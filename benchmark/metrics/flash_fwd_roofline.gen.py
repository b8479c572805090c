"""The flash forward kernel's share of its roofline over the window: the
bound of every UNet attention with d <= 128 over `flash_fwd_kernel`'s device
time."""
from benchmark.core.readers import roofline


def read(run):
    return roofline(run, ["flash_fwd_kernel"], ["flash_attention_fwd"],
                    lambda w: len(w.flash()), lambda w: w.flash_fwd_bound_s())
