"""Readers of the program's own spans (`difashion_tpu_torch/core/tracing.py`)
in a profiled generation batch: `run.program`, the device time credited to
each span (`core/program_trace.py`) with the program's counters over the
same batch, which a runner sets in traced runs (`runners/generate_xl.py`).
Each returns None where the run holds nothing to read: no profiled batch, a
program without the spans or counters, or counters that the configuration
does not explain."""
from __future__ import annotations

from typing import Optional

from benchmark.reference.sdxl import transformer_blocks_per_forward


def unet_span_ms(run, span: str) -> Optional[float]:
    """Device ms of the program's span `span` per UNet forward
    (`gen.unet_forwards`), where the counter `unet.transformer_blocks` is
    the configuration's BasicTransformerBlocks a forward times the
    forwards: the program ran the UNet that the configuration describes."""
    p = getattr(run, "program", None)
    if p is None:
        return None
    forwards = p.counts.get("gen.unet_forwards")
    blocks = p.counts.get("unet.transformer_blocks")
    want = transformer_blocks_per_forward(run.model_cfg["unet"])
    if not forwards or blocks != want * forwards:
        run.notes.append(f"unet.transformer_blocks: {blocks} over {forwards} forwards, the "
                         f"configuration has {want} a forward: no {span} time")
        return None
    return p.ms_per(span, "gen.unet_forwards")
