"""Device ms per step of the loss, forward and backward
(`accumulate_gradients`): CUDA events around each step's call."""
from benchmark.core.readers import span_ms_mean


def read(run):
    return span_ms_mean(run, "fwd_bwd")
