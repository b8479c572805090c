"""Device ms of the sampler loop (`GenerationPipeline.sample`) per UNet
forward: CUDA events around each batch's `sample`, over the forwards."""
from benchmark.core.readers import span_ms_per


def read(run):
    return span_ms_per(run, "sample", "unet_forwards")
