"""The device trace of a traced run (`--trace 1`): `torch.profiler` over the
measured window, reduced to what the per-layer readers and the result line
need.

From the profiler's raw events: every device operation (kernels, copies,
sets) as an interval, the benchmark's own spans (`record_function` names
beginning with "bench."), and the host's operator events. The window is the
span "bench.window"; everything is clipped to it. Then:
  * busy_s: the length of the union of the device intervals;
  * per operation name: total seconds and count (names shortened to the
    function, without template arguments or parameters);
  * the idle gaps between device intervals, each labelled by the innermost
    benchmark span and the innermost host operator running at its middle.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace, template
    arguments or parameters; other names up to their first parenthesis; at
    most 120 characters."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.split("::")[-1][:120] or "(unnamed)"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_seconds: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, *fragments: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        any of `fragments`."""
        secs, n = 0.0, 0
        for name, s in self.op_seconds.items():
            if any(f in name for f in fragments):
                secs += s
                n += self.op_counts[name]
        return secs, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:top]]}


def summarize(device: List[Tuple[float, float, str]], spans: List[Tuple[float, float, str]],
              host: List[Tuple[float, float, str]], window: Tuple[float, float],
              top_gaps: int = 10) -> TraceSummary:
    """Intervals in seconds on one clock: device operations, benchmark spans
    and host operators, each (start, end, name); `window` (start, end)."""
    w0, w1 = window
    ivs = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    op_s: Dict[str, float] = {}
    op_n: Dict[str, int] = {}
    busy, cur_s, cur_e = 0.0, None, None
    gaps = []
    prev_end = w0
    for s, e, n in ivs:
        key = short_name(n)
        op_s[key] = op_s.get(key, 0.0) + (e - s)
        op_n[key] = op_n.get(key, 0) + 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((s - prev_end, prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > prev_end:
        gaps.append((w1 - prev_end, prev_end, w1))
    gaps.sort(reverse=True)
    labelled = []
    span_ivs = sorted(spans)
    host_ivs = sorted(host)
    starts = [h[0] for h in host_ivs]
    for length, g0, g1 in gaps[:top_gaps]:
        mid = 0.5 * (g0 + g1)
        span = _innermost(span_ivs, mid)
        i = bisect.bisect_right(starts, mid)
        op = None
        for s, e, n in reversed(host_ivs[max(0, i - 2000):i]):   # latest start first
            if e >= mid:
                op = n
                break
        label = " / ".join(x for x in (span, op) if x) or "no host operation"
        labelled.append((label, length))
    return TraceSummary(window_s=w1 - w0, busy_s=busy, op_seconds=op_s, op_counts=op_n,
                        gaps=labelled)


def _innermost(ivs, t) -> Optional[str]:
    best = None
    for s, e, n in ivs:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, n)
    return best[1] if best else None


def from_profiler(prof) -> Optional[TraceSummary]:
    """The summary of a finished `torch.profiler.profile`, or None when it
    holds no window or no device operation."""
    raw, window = [], None
    for ev in prof.profiler.kineto_results.events():
        raw.append((ev.start_ns(), ev.duration_ns(), ev.name(),
                    str(ev.device_type()).endswith("CUDA")))
        if raw[-1][2] == WINDOW:
            window = raw[-1]
    if window is None:
        return None
    base = window[0]   # seconds from the window's start keep their digits
    device, spans, host = [], [], []
    for start, dur, name, on_device in raw:
        s = (start - base) * 1e-9
        e = s + dur * 1e-9
        if on_device:
            if not name.startswith("bench."):   # not the spans' GPU-side copies
                device.append((s, e, name))
        elif name.startswith("bench.") and name != WINDOW:
            spans.append((s, e, name[len("bench."):]))
        elif name.startswith("aten::") or name.startswith("cuda"):
            host.append((s, e, name))
    if not device:
        return None
    return summarize(device, spans, host, (0.0, window[1] * 1e-9))
