"""The port's tracing: named spans at its layer boundaries, and counters.

Spans are off by default, and then `span(name)` checks one module flag and
returns a shared null context: no allocation, no profiler call, no CUDA
event. `enable()` turns them on. An open span then sits inside
`torch.profiler.record_function(name)`, so a profiler trace holds it on the
thread that opened it, on the clock of the kernels it launches, and on
closing it appends a `Record` to an in-memory list, stamped with
`time.time_ns()`: the Unix clock that the profiler's events carry. Spans
nest by time: one opened inside another on its thread starts and ends
within it. Records stay in memory until read (`take`, `reset`); nothing is
written to disk.

The spans (each in the function that does the work):
  gen.prepare, gen.sample (gen.mutual, gen.unet, gen.scheduler each
  iteration), gen.decode, gen.fetch; unet.resnet and unet.transformer
  (every block of a UNet forward); unet.add_embedding (SDXL's added
  time / text conditioning, each forward that has it); text.encode (the
  bundle's text encode, both towers where there are two); train.forward,
  train.backward, train.allreduce (the gradients' mean over the ranks;
  nothing to reduce in one process), train.update (with train.sync, the step's host sync);
  train.batch and train.checkpoint (the train command's loop);
  serve.lock_wait and serve.jpeg (the generation service).

Counters count whether spans are on or off, as `nn/kernels.LAUNCHES`
counts launches: `gen.unet_forwards` (one per sampler iteration),
`unet.transformer_blocks` (the BasicTransformerBlocks each UNet forward
runs: 16 an sd2_base forward, 70 an SDXL one) and `train.steps` (one
per applied or skipped update)."""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Record(NamedTuple):
    name: str
    thread: int      # threading.get_native_id() of the thread that opened it
    start_ns: int    # time.time_ns(), inside the profiler's event of the span
    end_ns: int


COUNTERS: Dict[str, int] = {}
NULL = contextlib.nullcontext()

_on = False
_records: List[Record] = []
_lock = threading.Lock()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that records the span `name` while tracing is on, else the
    shared null context."""
    if not _on:
        return NULL
    return _Span(name)


def traced(name: str):
    """A decorator: the whole call of the function under `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    __slots__ = ("name", "start", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rf.__exit__(*exc)
        rec = Record(self.name, threading.get_native_id(), self.start, end)
        with _lock:
            _records.append(rec)
        return False


def take(thread: Optional[int] = None) -> List[Record]:
    """The records closed so far, in closing order, removed from the list:
    all of them, or those of the thread with native id `thread`."""
    with _lock:
        if thread is None:
            out = list(_records)
            _records.clear()
        else:
            out = [r for r in _records if r.thread == thread]
            _records[:] = [r for r in _records if r.thread != thread]
    return out


def reset() -> None:
    """Drop every record (the counters keep counting)."""
    take()


def count(name: str, n: int = 1) -> None:
    with _lock:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def host_ms(records: List[Record], name: str) -> List[float]:
    """Host milliseconds of each record named `name`."""
    return [(r.end_ns - r.start_ns) * 1e-6 for r in records if r.name == name]
