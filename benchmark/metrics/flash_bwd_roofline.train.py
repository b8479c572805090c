"""The flash backward kernels' share of their roofline over the window: the
dQ and dK/dV bounds of every UNet attention with d <= 128 over the device time
of `flash_dq_kernel`, `flash_dkv_kernel` and its split's reduce together."""
from benchmark.core.readers import roofline


def read(run):
    return roofline(run, ["flash_dq_kernel", "flash_dkv_kernel", "flash_dkv_reduce_kernel"],
                    ["flash_attention_dq", "flash_attention_dkv"],
                    lambda w: len(w.flash()), lambda w: w.flash_bwd_bound_s())
