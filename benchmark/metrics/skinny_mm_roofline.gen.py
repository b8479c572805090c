"""The skinny-N matmul kernel's share of its roofline over the window:
every Dense product the route sends to it (UNet forwards, decodes) over
`skinny_matmul_kernel`'s device time."""
from benchmark.core.readers import roofline


def read(run):
    return roofline(run, ["skinny_matmul_kernel"], ["skinny_matmul"],
                    lambda w: len(w.skinny()), lambda w: w.skinny_bound_s())
