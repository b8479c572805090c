"""Command-line entry points of the port (`python -m difashion_tpu_torch <command>`)."""
