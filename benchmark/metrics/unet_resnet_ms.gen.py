"""Device ms a UNet forward in the program's `unet.resnet` spans (every
ResnetBlock2D), over the batch a traced run profiles after its window."""
from benchmark.core.program_readers import unet_span_ms


def read(run):
    return unet_span_ms(run, "unet.resnet")
