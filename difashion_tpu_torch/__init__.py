"""difashion_tpu_torch: DiFashion in PyTorch with hand-written CUDA kernels for
Hopper (H100), ported from the JAX/TPU package `difashion_tpu`, which stays the
reference. The port imports neither JAX nor `difashion_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
