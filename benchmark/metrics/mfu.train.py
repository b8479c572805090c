"""The training window's operations (per step 3x the UNet's and the
MutualEncoder's forward, the frozen text tower's forward) over its traced
length at 989 TFLOP/s."""
from benchmark.core.readers import mfu


def read(run):
    return mfu(run)
