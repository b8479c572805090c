"""What every run shares: finding a cell's files by name, the checks on the
machine and the process, the measured window with its optional trace, the
benchmark's own spans, and the result line.

Files are found by name, so a later change adds a cell, a configuration, a
runner or a per-layer metric by adding a file:
  * benchmark/workloads/<cell>.json   the cell: its config, runner, traffic, check
  * benchmark/configs/<config>.json   the model configuration
  * benchmark/runners/<runner>.py     `run(run)` drives set-up, window and check
  * benchmark/metrics/<metric>.py     `read(run)` gives the metric or None
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "difashion_tpu")


class Refused(Exception):
    """The run cannot be made here (no card, a module that must not load)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, base: Path = BENCH) -> Path:
    """benchmark/<kind>/<name>.<json|py>."""
    ext = ".py" if kind in ("runners", "metrics") else ".json"
    path = base / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} does not exist")
    return path


def load_reader(name: str, base: Path = BENCH) -> Callable:
    """The `read` function of benchmark/metrics/<name>.py (names hold dots,
    so the file is loaded by path)."""
    path = find("metrics", name, base)
    key = f"benchmark_metric_{name}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module.read


def load_runner(kind: str):
    """benchmark/runners/<kind>.py, imported as a module of the package."""
    find("runners", kind)
    return importlib.import_module(f"benchmark.runners.{kind}")


def cell_metrics(spec: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics of BENCHMARK.json that `cell`
    reports: the end-to-end ones whose `workloads` list it or that have no
    such list (`setup_s`), the per-layer ones whose `workloads` list it
    (every per-layer metric has one)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in spec["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run must not hold, compared
    whole (the port's package name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: this benchmark measures the card "
                      "and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} card(s), torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")


def no_jax_by_library() -> None:
    """No JAX through a library that would load it by itself. (The
    program's kernels build into difashion_tpu_torch/_build/ inside the
    checkout; it uses no other build or kernel cache.)"""
    os.environ["USE_FLAX"] = "0"


def _smi(fields: str) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    return _smi("name,power.limit")


_CARD_STATE = ("power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
               "clocks_throttle_reasons.active")


def card_state() -> Dict[str, str]:
    """The card's draw, SM and memory clocks against the SM maximum, its
    temperature and the bitmask of what limits its clocks now (NVML's
    reasons: 0x1 idle, 0x4 the power cap, 0x8 a hardware slowdown, 0x20 /
    0x40 a thermal one, 0x80 the power brake), as nvidia-smi reads them;
    read as the window closes and printed on the run's summary line, so
    that a card that ran slow can be told apart."""
    got = _smi(_CARD_STATE)
    return {} if got is None else dict(zip(_CARD_STATE.split(","),
                                           (v.strip() for v in got.split(","))))


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # a NaN fails


@dataclass
class Run:
    """One run of one cell: its files, the clock, the window and what the
    readers read."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                       # perf_counter at the process's start
    base: Path = BENCH
    workload: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, object] = field(default_factory=dict)
    checks: Dict[str, Check] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    summary: object = None          # trace.TraceSummary of a traced window
    notes: List[str] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)   # seconds since t0 at each mark
    card: Dict[str, str] = field(default_factory=dict)       # card_state() as the window closed
    _spans: Dict[str, list] = field(default_factory=dict)

    def __post_init__(self):
        self.workload = load_json(find("workloads", self.cell, self.base))
        self.config = load_json(find("configs", self.workload["config"], self.base))

    @property
    def model_cfg(self) -> dict:
        return self.config["model"]

    def mark(self, phase: str) -> None:
        """The host clock at the end of a phase of set-up or check (printed
        on the run's summary line: the set-up split)."""
        self.phases[phase] = time.perf_counter() - self.t0

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self, profile: bool = True):
        """The measured window: set-up ends where it opens; it closes after
        the device has finished what the body queued. In a traced run the
        profiler covers it unless `profile` is False (a runner whose host
        the profiler would slow profiles a part of its own after it)."""
        self.sync()
        with self.profiled() if profile else contextlib.nullcontext():
            start = time.perf_counter()
            self.setup_s = start - self.t0
            yield
            self.sync()
            self.window_s = time.perf_counter() - start
        if self.device.startswith("cuda"):
            self.card = card_state()

    @contextlib.contextmanager
    def profiled(self):
        """In a traced run, `torch.profiler` (CPU and CUDA activity) over
        the body under the span "bench.window", reduced to `self.summary`."""
        if not self.trace:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from benchmark.core.trace import from_profiler

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        try:
            with torch.profiler.record_function("bench.window"):
                yield
                self.sync()
        finally:
            prof.stop()
        self.summary = from_profiler(prof)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own around a call into a layer, in
        traced runs only: `record_function("bench.<name>")` and CUDA events
        (read after the window with `span_ms`)."""
        if not self.trace:
            yield
            return
        import torch

        cuda = self.device.startswith("cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else None
        t = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            if ev:
                ev[0].record()
            yield
            if ev:
                ev[1].record()
        self._spans.setdefault(name, []).append((ev, time.perf_counter() - t))

    def span_ms(self, name: str) -> List[float]:
        """Device milliseconds of each span `name` (CUDA events), or host
        milliseconds where there is no card."""
        self.sync()
        return [ev[0].elapsed_time(ev[1]) if ev else host * 1e3
                for ev, host in self._spans.get(name, [])]


def result_line(run: Run, metric_entries: List[dict], values: Dict[str, float],
                device: dict, breakdown: Optional[dict]) -> dict:
    """The last line: correct, attempted, failed, metrics, device, the
    optional breakdown, and the compared numbers last."""
    correct = bool(run.checks) and all(c.ok for c in run.checks.values())
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in metric_entries if values.get(m["name"]) is not None},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return out
