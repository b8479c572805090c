"""The attribution of device time to the program's spans
(`core/program_trace.py`) on synthetic events and on a synthetic profile
read in one pass (the summary without the spans' copies on the device, the
idle gaps named by the program's spans), the benchmark's own runs leaving
the spans off, and `program_spans.py` on the tiny cells on the CPU."""
from __future__ import annotations

import json
import time

import pytest

from benchmark import program_spans
from benchmark.core import harness, program_trace

MAIN, AUTOGRAD = 11, 22
SPANS = [(0, 100, "train.forward", MAIN), (10, 30, "unet.resnet", MAIN),
         (100, 200, "train.backward", MAIN), (200, 260, "train.update", MAIN),
         (240, 250, "train.sync", MAIN)]
LAUNCHES = {1: (20, MAIN),        # inside unet.resnet inside train.forward
            2: (50, MAIN),        # train.forward's own
            3: (150, AUTOGRAD),   # autograd's thread, no span: train.backward by time
            4: (245, MAIN),       # train.sync inside train.update
            5: (300, MAIN)}       # after every span
DEVICE = [(1, 2.0, "void at::native::elementwise_kernel<128, 2>(int)"), (2, 1.0, "k2"),
          (3, 4.0, "k3"), (4, 0.5, "k4"), (5, 0.25, "k5"),
          (6, 0.25, "k6")]        # its launch is not in the profile


def test_attribution_on_a_synthetic_trace():
    got = program_trace.attribute(SPANS, LAUNCHES, DEVICE)
    assert got.device_s == pytest.approx(8.0)
    assert got.self_s == pytest.approx({"unet.resnet": 2.0, "train.forward": 1.0,
                                        "train.backward": 4.0, "train.sync": 0.5})
    assert got.total_s == pytest.approx({"unet.resnet": 2.0, "train.forward": 3.0,
                                         "train.backward": 4.0, "train.update": 0.5,
                                         "train.sync": 0.5})
    assert got.unlinked == 1
    assert got.uncovered_s == pytest.approx(0.5)
    assert got.uncovered_share == pytest.approx(0.5 / 8.0)
    assert got.by_op[("unet.resnet", "elementwise_kernel")] == pytest.approx(2.0)
    got.counts = {"train.steps": 2}
    assert got.ms_per("train.forward", "train.steps") == pytest.approx(1500.0)
    assert got.ms_per("train.update", "train.steps", minus=("train.sync",)) == 0.0
    assert got.ms_per("train.allreduce", "train.steps") is None
    assert got.ms_per("train.forward", "gen.unet_forwards") is None


def test_launches_on_a_thread_with_spans_stay_on_it():
    """A launch on a thread that has its own spans is credited to them, not
    to the main thread's spans open at the same time."""
    spans = SPANS + [(140, 160, "serve.jpeg", AUTOGRAD)]
    got = program_trace.attribute(spans, LAUNCHES, DEVICE)
    assert got.self_s["serve.jpeg"] == pytest.approx(4.0)
    assert "train.backward" not in got.total_s


class _Event:
    """The part of a kineto event that `program_trace.from_profiler` reads."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0, thread=MAIN,
                 annotation=False):
        self._v = (name, start, dur, device, corr, linked, thread, annotation)

    name = lambda self: self._v[0]
    start_ns = lambda self: self._v[1]
    duration_ns = lambda self: self._v[2]
    device_type = lambda self: "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"
    correlation_id = lambda self: self._v[4]
    linked_correlation_id = lambda self: self._v[5]
    device_resource_id = lambda self: self._v[6]
    is_user_annotation = lambda self: self._v[7]


class _Profile:
    def __init__(self, events):
        class _K:
            def events(_):
                return events

        self.profiler = type("P", (), {"kineto_results": _K()})()


def test_one_pass_gives_the_summary_and_the_attribution():
    """A window with a bench span, two program spans (their copies on the
    device left out of the summary), a kernel linked to its operator, one to
    its runtime call only, and an idle gap in the backward."""
    ann = dict(annotation=True)
    events = [
        _Event("bench.window", 0, 1000, corr=1, **ann),
        _Event("bench.fwd_bwd", 0, 900, corr=2, **ann),
        _Event("train.forward", 10, 390, corr=3, **ann),
        _Event("aten::mul", 20, 10, corr=4),
        _Event("cudaLaunchKernel", 22, 5, corr=5),
        _Event("train.backward", 400, 500, corr=6, **ann),
        _Event("aten::sum", 600, 300, corr=7),
        _Event("cudaLaunchKernel", 410, 5, corr=8, thread=AUTOGRAD),
        _Event("void at::native::elementwise_kernel<128, 2>(int)", 100, 200, device=True,
               corr=5, linked=4),
        _Event("k_backward", 420, 100, device=True, corr=8),
        _Event("train.forward", 100, 200, device=True, **ann),   # the span's device copy
        _Event("train.backward", 420, 100, device=True, **ann),
    ]
    summary, got = program_trace.from_profiler(_Profile(events), {"train.steps": 1})
    assert set(summary.op_seconds) == {"elementwise_kernel", "k_backward"}
    assert summary.busy_s == pytest.approx(300e-9)
    assert summary.gaps[0] == ("train.backward / aten::sum", pytest.approx(480e-9))
    assert got.total_s == pytest.approx({"train.forward": 200e-9, "train.backward": 100e-9})
    assert got.uncovered_s == 0 and got.unlinked == 0
    assert got.ms_per("train.backward", "train.steps") == pytest.approx(1e-4)
    assert got.op_by_span("elementwise_kernel") == pytest.approx({"train.forward": 200e-9})
    # a profile without program spans: the summary alone
    summary, got = program_trace.from_profiler(_Profile(
        [e for e in events if not e.name().startswith("train.")]))
    assert got is None and summary.busy_s == pytest.approx(300e-9)


def test_the_benchmarks_own_runs_leave_the_programs_spans_off():
    from difashion_tpu_torch.core import tracing

    tracing.disable()
    harness.Run(cell="sd2_base.train_b8", seed=1, seconds=0.0, trace=True, device="cpu",
                t0=0.0)
    assert not tracing.enabled()


@pytest.mark.parametrize("cell,trace", [("tiny.train", 1), ("tiny.train", 0), ("tiny.gor", 1)])
def test_program_spans_on_the_tiny_cells(tiny_base, capsys, cell, trace):
    from difashion_tpu_torch.core import tracing

    try:
        assert program_spans.main(["--workload", cell, "--seed", "5", "--seconds", "0",
                                   "--trace", str(trace)], device="cpu", base=tiny_base,
                                  t0=time.perf_counter()) == 0
        assert tracing.enabled()
    finally:
        tracing.disable()
        tracing.reset()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["trace"] == trace
    if cell == "tiny.train":
        assert out["layers"]["host_ms"] > 0 and out["layers"]["step_ms"] > 0
    else:
        assert out["layers"] == {}   # no device operation in a CPU profile
    assert "program" not in out
