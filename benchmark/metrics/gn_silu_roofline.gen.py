"""The GroupNorm kernel's share of its roofline over the window: every
GroupNorm of the UNet forwards and the decodes (x read and y written once)
over the device time of its kernels (one-read and two-pass routes)."""
from benchmark.core.readers import roofline

KERNELS = ["gn_cluster_kernel", "gn_partials_kernel", "gn_finalize_kernel", "gn_apply_kernel"]


def read(run):
    return roofline(run, KERNELS, ["group_norm_silu"],
                    lambda w: len(w.groupnorm), lambda w: w.groupnorm_bound_s())
