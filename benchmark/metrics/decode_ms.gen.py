"""Device ms of the VAE decode and uint8 quantisation (`decode_to_uint8`)
per image: CUDA events around each batch's decode, over its images."""
from benchmark.core.readers import span_ms_per


def read(run):
    return span_ms_per(run, "decode", "images")
