"""The generation window's matmul and convolution operations (UNet
forwards, MutualEncoder, decodes) over its traced length at 989 TFLOP/s."""
from benchmark.core.readers import mfu


def read(run):
    return mfu(run)
