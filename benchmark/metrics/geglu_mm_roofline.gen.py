"""The fused GEGLU kernel's share of its roofline over the window: every
GEGLU projection of the UNet forwards and the decodes (the Dense products
with N = 8K: in these towers only the transformer blocks' ff.net.0.proj)
that the program's GEGLU route sends to `geglu_matmul_kernel`, over that
kernel's device time.

The route is frozen here, as `core/work.py` freezes the skinny-N gate: a
16-bit compute dtype with autograd off, F = N / 2 a multiple of the
kernel's 128-column tile, and K a multiple of 8 (x read in place). The
bound is the fused kernel's own: 2MKN operations at the bf16 peak, or x,
the weight and the bias read and the N/2-wide output written once (it never
writes the N-wide pre-activation). A run whose program has no such kernel
or counter reads nothing."""
from benchmark.core.readers import roofline
from benchmark.core.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

KERNELS = ["geglu_matmul_kernel"]
COUNTERS = ["geglu_matmul"]
TILE_F = 128


def geglu_gate(rows: int, k: int, n: int, size: int = 2) -> bool:
    """The program's GEGLU route at these shapes in a `size`-byte compute
    dtype, autograd off: 16 bits, F = N / 2 a multiple of TILE_F, K % 8 == 0."""
    return size == 2 and rows > 0 and n % (2 * TILE_F) == 0 and k % 8 == 0


def calls(work, size: int = 2):
    """A forward's GEGLU projections (M, K, N, bias) that the route takes."""
    return [d for d in work.dense if d[2] == 8 * d[1] and geglu_gate(d[0], d[1], d[2], size)]


def bound_s(m: int, k: int, n: int) -> float:
    return max(2.0 * m * k * n / PEAK_BF16_FLOPS,
               2.0 * (m * k + k * n + m * n / 2 + n) / PEAK_HBM_BYTES)


def read(run):
    return roofline(run, KERNELS, COUNTERS, lambda w: len(calls(w)),
                    lambda w: sum(bound_s(*d[:3]) for d in calls(w)))
