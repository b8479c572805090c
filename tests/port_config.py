"""The port's config against the JAX package's: the port's dataclasses hold
every field of the JAX package's and a few of their own (SDXL's per-level
transformer depth, added conditioning, second text tower and
context state), which in an SD config stay at their SD defaults."""

PORT_FIELDS = {"transformer_layers_per_block": 1, "addition_embed_type": None,
               "addition_time_embed_dim": None, "projection_class_embeddings_input_dim": None,
               "projection_dim": None, "context_hidden_state": None, "text_2": None}


def assert_port_extends_jax(ours: dict, theirs: dict, path: str = "") -> None:
    """`dataclasses.asdict` of a port config (`ours`) against the JAX
    package's (`theirs`): equal on every field the JAX package has, and
    every other field one of PORT_FIELDS at its SD default."""
    for key, value in theirs.items():
        assert key in ours, f"{path}{key}: not in the port's config"
        if isinstance(value, dict):
            assert_port_extends_jax(ours[key], value, f"{path}{key}.")
        else:
            assert ours[key] == value, f"{path}{key}: {ours[key]!r} != {value!r}"
    for key in set(ours) - set(theirs):
        assert key in PORT_FIELDS, f"{path}{key}: neither the JAX package's nor the port's own"
        assert ours[key] == PORT_FIELDS[key], f"{path}{key}: {ours[key]!r}, not its SD default"
