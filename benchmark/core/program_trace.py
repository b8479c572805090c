"""Device time credited to the program's own spans, apart from the
benchmark's runs (`benchmark/program_spans.py` prints it).

`TracedRun` is the harness's `Run` with the program's tracing
(`difashion_tpu_torch/core/tracing.py`) on from before set-up. An open span
then sits in `torch.profiler.record_function(name)`, so a profile holds it
as a user annotation on the thread that opened it; any user annotation not
named "bench.*" is taken for a program span. The window keeps the
program's records and counters, and a profiled part is read once
(`from_profiler`) into the harness's summary and the attribution.

Every device operation is followed by its correlation id to the host call
that launched it: the torch operator, or the span itself for a kernel
launched through ctypes inside it (its linked correlation id, as
`torch.profiler` itself links kernels to operators), else the runtime call
(cudaLaunchKernel, cudaMemcpyAsync, ...) of its own correlation id. Its
duration is credited to the innermost program span open on that call's
thread at that call's start: that span's self time, and the total time of
it and of every span open around it. A call on a thread with no span open
then (autograd runs the backward on a device thread of its own) is
credited by time to the spans open on the thread that opened the most
spans: a backward's kernels fall in `train.backward`. What no span covers,
and device operations whose launch the profile does not hold, stay
unattributed.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.core.harness import Run
from benchmark.core.trace import WINDOW, TraceSummary, short_name, summarize

Span = Tuple[int, int, str, int]             # start ns, end ns, name, thread
Launch = Tuple[int, int]                     # time ns, thread
DeviceOp = Tuple[object, float, str]         # key of its launch, seconds, name


@dataclass
class ProgramTrace:
    device_s: float                          # every device operation's seconds, summed
    self_s: Dict[str, float] = field(default_factory=dict)
    total_s: Dict[str, float] = field(default_factory=dict)
    uncovered_s: float = 0.0                 # launched outside every span, or unlinked
    unlinked: int = 0                        # device operations with no launch found
    by_op: Dict[Tuple[str, str], float] = field(default_factory=dict)  # (span, op): s
    counts: Dict[str, int] = field(default_factory=dict)   # program counters over it

    @property
    def uncovered_share(self) -> float:
        return self.uncovered_s / self.device_s if self.device_s > 0 else 0.0

    def ms_per(self, span: str, counter: str, minus: Sequence[str] = ()) -> Optional[float]:
        """The total device ms of `span` less that of each of `minus`, per
        unit of the program counter `counter` over the profile; None when the
        span or the counter is absent."""
        n = self.counts.get(counter)
        if span not in self.total_s or not n:
            return None
        return 1e3 * (self.total_s[span] - sum(self.total_s.get(m, 0.0) for m in minus)) / n

    def op_by_span(self, op: str) -> Dict[str, float]:
        """Device seconds of the operation named `op` (its short name), by
        the innermost span that launched it."""
        out: Dict[str, float] = {}
        for (span, name), secs in self.by_op.items():
            if name == op:
                out[span] = out.get(span, 0.0) + secs
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def summary(self, top: int = 12) -> dict:
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_s": self.device_s, "uncovered_share": self.uncovered_share,
                "unlinked": self.unlinked, "counts": self.counts,
                "self_s": dict(sorted(self.self_s.items(), key=lambda kv: -kv[1])),
                "total_s": dict(sorted(self.total_s.items(), key=lambda kv: -kv[1])),
                "top_span_ops": [[s, op, v] for (s, op), v in ops]}


def _chains(spans: List[Span], times: List[int]) -> List[Tuple[str, ...]]:
    """For each time, the names of the spans of one thread open then,
    outermost first (the spans of one thread nest)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Tuple[str, ...]] = [()] * len(times)
    stack: List[Span] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def attribute(spans: Iterable[Span], launches: Dict[object, Launch],
              device: Iterable[DeviceOp]) -> ProgramTrace:
    """Credit each device operation (key, seconds, name) to the spans open
    at its launch (`launches[key]` = (time, thread)), as the module's
    docstring says. Times in ns on one clock."""
    by_thread: Dict[int, List[Span]] = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(s)
    main = max(by_thread, key=lambda t: len(by_thread[t])) if by_thread else None
    device = list(device)
    linked = [(k, launches[c]) for k, (c, _, _) in enumerate(device) if c in launches]
    chain: Dict[int, Tuple[str, ...]] = {}
    for thread in {th for _, (_, th) in linked}:
        mine = [(k, t) for k, (t, th) in linked if th == thread]
        got = _chains(by_thread.get(thread, []), [t for _, t in mine])
        chain.update((k, c) for (k, _), c in zip(mine, got))
    orphans = [(k, t) for k, (t, _) in linked if not chain[k]]
    if orphans and main is not None:
        got = _chains(by_thread[main], [t for _, t in orphans])
        chain.update((k, c) for (k, _), c in zip(orphans, got))
    out = ProgramTrace(device_s=sum(d[1] for d in device), unlinked=len(device) - len(linked))
    for k, (_, secs, name) in enumerate(device):
        names = chain.get(k, ())
        if not names:
            out.uncovered_s += secs
            continue
        out.self_s[names[-1]] = out.self_s.get(names[-1], 0.0) + secs
        for n in set(names):
            out.total_s[n] = out.total_s.get(n, 0.0) + secs
        key = (names[-1], short_name(name))
        out.by_op[key] = out.by_op.get(key, 0.0) + secs
    return out


def from_profiler(prof, counts: Optional[Dict[str, int]] = None
                  ) -> Tuple[Optional[TraceSummary], Optional[ProgramTrace]]:
    """A finished `torch.profiler.profile`, read in one pass over its events:
    the window's summary as `trace.from_profiler` makes it, without the
    program spans' copies on the device and with the innermost program span
    naming each idle gap, and the attribution, each None where the profile
    holds nothing to read. `counts`: the program's counters over it."""
    window = None
    device = []                        # start, end, name, linked id, own id
    bench, host, spans = [], [], []    # start, end, name (, thread)
    ops: Dict[int, Launch] = {}        # torch operators and spans, by correlation id
    runtime: Dict[int, Launch] = {}    # cudaLaunchKernel, cuLaunchKernel, ..., by correlation id
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            device.append((start, end, name, ev.linked_correlation_id(), ev.correlation_id()))
            continue
        at = (start, ev.device_resource_id())
        if name.startswith("cu"):
            runtime[ev.correlation_id()] = at
        elif ev.correlation_id():
            ops[ev.correlation_id()] = at
        if name == WINDOW:
            window = (start, end)
        elif name.startswith("bench."):
            bench.append((start, end, name[len("bench."):]))
        elif ev.is_user_annotation():
            spans.append((start, end, name, at[1]))
        elif name.startswith("aten::") or name.startswith("cuda"):
            host.append((start, end, name))
    names = {s[2] for s in spans}
    device = [d for d in device if not d[2].startswith("bench.") and d[2] not in names]
    summary = None
    if window is not None and device:
        sec = lambda ivs: [((s - window[0]) * 1e-9, (e - window[0]) * 1e-9, n)
                           for s, e, n, *_ in ivs]
        summary = summarize(sec(device), sec(bench) + sec(spans), sec(host),
                            (0.0, (window[1] - window[0]) * 1e-9))
    if not spans or not device:
        return summary, None
    launches: Dict[object, Launch] = {}
    keyed: List[DeviceOp] = []
    for start, end, name, linked, corr in device:
        key = ("op", linked) if linked in ops else ("runtime", corr) if corr in runtime else None
        if key is not None:
            launches[key] = ops[linked] if key[0] == "op" else runtime[corr]
        keyed.append((key, (end - start) * 1e-9, name))
    out = attribute(spans, launches, keyed)
    out.counts = dict(counts or {})
    return summary, out


def _tracing():
    from difashion_tpu_torch.core import tracing

    return tracing


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in _tracing().COUNTERS.items()}


@dataclass
class TracedRun(Run):
    """A `Run` with the program's spans on from before set-up, in traced
    and untraced runs alike: the window keeps the program's records and
    counters (`records`, `counted`), and a profiled part gives the
    harness's summary and the attribution (`program`)."""

    program: Optional[ProgramTrace] = None
    records: list = field(default_factory=list)
    counted: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        super().__post_init__()
        _tracing().enable()

    @contextlib.contextmanager
    def window(self, profile: bool = True):
        _tracing().reset()
        before = dict(_tracing().COUNTERS)
        with super().window(profile):
            yield
        self.records = _tracing().take()
        self.counted = _since(before)

    @contextlib.contextmanager
    def profiled(self):
        """`Run.profiled`, read by `from_profiler` above."""
        if not self.trace:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        before = dict(_tracing().COUNTERS)
        prof = profile(activities=acts)
        prof.start()
        try:
            with torch.profiler.record_function(WINDOW):
                yield
                self.sync()
        finally:
            prof.stop()
        self.summary, self.program = from_profiler(prof, _since(before))
