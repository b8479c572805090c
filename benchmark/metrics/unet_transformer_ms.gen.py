"""Device ms a UNet forward in the program's `unet.transformer` spans (every
Transformer2D: GroupNorm, projections, the BasicTransformerBlocks), over
the batch a traced run profiles after its window."""
from benchmark.core.program_readers import unet_span_ms


def read(run):
    return unet_span_ms(run, "unet.transformer")
