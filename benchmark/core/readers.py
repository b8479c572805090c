"""Arithmetic the per-layer readers share: a span's device time per unit of
work, a kernel's share of its roofline, the step's share of the peak, the
device's idle share. Each returns None where the run holds nothing to read
(an untraced window, no card, launches that the counted work does not
explain), and the reader then reports nothing."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from benchmark.core.work import PEAK_BF16_FLOPS


def span_ms_per(run, span: str, count: str) -> Optional[float]:
    """The span's device ms over the window, per unit of `run.counts[count]`."""
    ms, n = run.span_ms(span), run.counts.get(count)
    return sum(ms) / n if ms and n else None


def span_ms_mean(run, span: str) -> Optional[float]:
    ms = run.span_ms(span)
    return sum(ms) / len(ms) if ms else None


def roofline(run, kernels: Sequence[str], counters: Sequence[str],
             calls: Callable, bound: Callable) -> Optional[float]:
    """100 x the bound of the window's calls of a kernel over the kernel's
    device time in the trace. `calls(work)` and `bound(work)` give a
    forward's calls and bound seconds; each forward kind in
    run.counts["work"] is (work, times run in the traced part). Every
    counter in `counters` must have counted exactly those calls there
    (run.counts["trace_launches"])."""
    s, work = run.summary, run.counts.get("work")
    if s is None or not work:
        return None
    expected = sum(calls(w) * n for w, n in work.values())
    launched = run.counts.get("trace_launches", {})
    for c in counters:
        if launched.get(c) != expected:
            run.notes.append(f"{c}: {launched.get(c)} launches traced, the counted "
                             f"work explains {expected}: no roofline")
            return None
    secs, _ = s.kernel_seconds(*kernels)
    if expected == 0 or secs <= 0:
        return None
    return 100.0 * sum(bound(w) * n for w, n in work.values()) / secs


def mfu(run) -> Optional[float]:
    """100 x the window's matmul and convolution operations over its length
    (host clock) at the card's bf16 dense peak; a traced run on a card only."""
    flops = run.counts.get("flops")
    if run.summary is None or not flops or not run.window_s:
        return None
    return 100.0 * flops / run.window_s / PEAK_BF16_FLOPS


def idle_share(run) -> Optional[float]:
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
