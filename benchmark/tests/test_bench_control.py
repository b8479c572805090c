"""What decides `correct`, at a size a test run holds: the control (the
reference in fp8 put in the program's place) and the planted faults fail
the cells' limits, where the sound program passes them."""
from __future__ import annotations

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import control
from benchmark.core import harness


def readings(base, cell, seeds="5,6,7"):
    out = io.StringIO()
    with redirect_stdout(out):
        control.main(["--workload", cell, "--seeds", seeds], device="cpu", base=base)
    return [r for r in map(json.loads, out.getvalue().splitlines()) if "kind" in r]


def failed(rec):
    return any(v > rec["limits"][k] for k, v in rec["numbers"].items())


@pytest.mark.parametrize("cell", ["tiny.gor", "tiny.train"])
def test_control_fails_where_the_program_passes(tiny_base, cell):
    recs = readings(tiny_base, cell)
    kinds = {r["kind"] for r in recs}
    assert "program" in kinds and "control_fp8" in kinds
    for r in recs:
        assert failed(r) == (r["kind"] != "program"), r


def _faulty_run(base, cell, fault, **faults):
    run = harness.Run(cell=cell, seed=11, seconds=0.0, trace=False, device="cpu",
                      t0=time.perf_counter(), base=base)
    harness.load_runner(run.workload["runner"]).run(run, program_fault=fault, **faults)
    line = harness.result_line(run, [], {}, {}, None)
    return line["correct"], run.checks


def _sampler_state_unchanged(st):
    real = st.pipeline.sampler
    st.pipeline.sampler = lambda inputs, *a, **k: inputs.init_latents.float()
    assert real is not None


def _sampler_half_batch(st):
    real = st.pipeline.sampler

    def half(inputs, *a, **k):
        out = real(inputs, *a, **k)
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:n].mean(0, keepdim=True).expand_as(out[n:])])
    st.pipeline.sampler = half


def _image_altered(st):
    real = st.pipeline.generate_batch

    def altered(prep):
        imgs = real(prep).copy()
        imgs[0, :64] = 255 - imgs[0, :64]
        return imgs
    st.pipeline.generate_batch = altered


def _step_state_unchanged(st):
    st.step_fn = lambda state, *a, **k: (state, {"loss": torch.tensor(1.0)})


def _step_half_batch(st):
    real = st.step_fn

    def half(state, batch, *a, **k):
        n = batch.input_ids.shape[0] // 2
        return real(state, batch._replace(**{f: getattr(batch, f)[:n] for f in
                                             ("latent_mean", "latent_logvar", "input_ids",
                                              "hist_latents")}), *a, **k)
    st.step_fn = half


def _step_stale_batch(st):
    real, seen = st.step_fn, []

    def stale(state, batch, *a, **k):
        seen.append(batch)
        return real(state, seen[0], *a, **k)
    st.step_fn = stale


def _step_skipped(st):
    real, calls = st.step_fn, []

    def every_other(state, *a, **k):
        calls.append(1)
        return real(state, *a, **k) if len(calls) % 2 else (state, {"loss": torch.tensor(1.0)})
    st.step_fn = every_other


@pytest.mark.parametrize("fault", [_step_state_unchanged, _step_half_batch, _step_stale_batch,
                                   _step_skipped])
def test_a_step_broken_after_the_first_steps_is_not_correct(tiny_base, fault):
    """Broken only after the steps the reference follows from the seed: the
    window's steps and the one after it."""
    correct, checks = _faulty_run(tiny_base, "tiny.train", None, window_fault=fault)
    assert correct is False, checks


@pytest.mark.parametrize("cell,fault", [
    ("tiny.gor", _sampler_state_unchanged), ("tiny.gor", _sampler_half_batch),
    ("tiny.gor", _image_altered), ("tiny.train", _step_state_unchanged),
    ("tiny.train", _step_half_batch)])
def test_a_broken_timed_path_is_not_correct(tiny_base, cell, fault):
    correct, checks = _faulty_run(tiny_base, cell, fault)
    assert correct is False, checks


def test_sound_run_is_correct(tiny_base):
    for cell in ("tiny.gor", "tiny.train"):
        correct, checks = _faulty_run(tiny_base, cell, None)
        assert correct is True, checks
