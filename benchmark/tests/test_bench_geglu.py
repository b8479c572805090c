"""The fused GEGLU kernel's per-layer metric (`metrics/geglu_mm_roofline.gen.py`)
against hand counts: the calls it selects in a forward, its frozen route
against the program's, its bound per shape, and what it reads from a run
with the kernel's counter and from one without (a program before the
kernel)."""
from __future__ import annotations

import importlib.util
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.core import harness, work


def _metric():
    path = harness.find("metrics", "geglu_mm_roofline.gen")
    spec = importlib.util.spec_from_file_location("geglu_mm_roofline_gen", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())["model"]


# a 64-row UNet forward's GEGLU projections at both configurations (the same
# feed-forward widths): 5 blocks at each of the three attention levels, 1 mid
SITES = {(64 * 4096, 320, 2560): 5, (64 * 1024, 640, 5120): 5, (64 * 256, 1280, 10240): 5,
         (64 * 64, 1280, 10240): 1}


@pytest.mark.parametrize("config", ["sd2_base", "sd15"])
def test_selector_finds_the_geglu_projections(config):
    """16 GEGLU projections a UNet forward, at the four sites, and none in a
    decode."""
    m = _metric()
    mc = _model(config)
    got = m.calls(work.unet_work(mc, 64))
    assert len(got) == 16
    counts = {}
    for rows, k, n, bias in got:
        assert bias
        counts[(rows, k, n)] = counts.get((rows, k, n), 0) + 1
    assert counts == SITES
    assert m.calls(work.decode_work(mc, 16)) == []
    # no other Dense of the forward has N = 8K, and none of these is the skinny gate's
    assert not [d for d in got if work.skinny_gate(d[0], d[2], d[1])]


def test_frozen_route_agrees_with_the_programs():
    """The metric's frozen route against the program's (`geglu_gate`, with
    `aligned` on the x a GEGLU passes) on the sites, on shapes it refuses,
    in 16 bits and in fp32."""
    from difashion_tpu_torch.nn.kernels.geglu_matmul import geglu_gate
    from difashion_tpu_torch.nn.kernels.skinny_matmul import aligned

    m = _metric()
    shapes = list(SITES) + [(4096, 320, 2432), (4096, 36, 288), (130, 40, 256), (4096, 320, 320)]
    for dtype in (torch.bfloat16, torch.float32):
        for rows, k, n in shapes:
            # shapes without memory for the gate; a small x of the same K for the layout
            x = torch.zeros(1, dtype=dtype).expand(rows, k)
            w = torch.zeros(1, dtype=dtype).expand(n, k)
            program = geglu_gate(x, w) and aligned(torch.zeros(8, k, dtype=dtype))
            assert m.geglu_gate(rows, k, n, dtype.itemsize) == program, (rows, k, n, dtype)
    assert all(m.geglu_gate(*s) for s in SITES)


def test_bound_by_hand():
    """The fused kernel's own bound at each site: operations bound them all
    (the 4096-token level near the ridge), against `matmul_bound_s`, which
    counts the N-wide output."""
    m = _metric()
    for (rows, k, n) in SITES:
        ops = 2 * rows * k * n / 989e12
        nbytes = 2 * (rows * k + k * n + rows * n / 2 + n) / 3.35e12
        assert m.bound_s(rows, k, n) == pytest.approx(max(ops, nbytes), rel=1e-12)
        assert ops >= nbytes
    # the 4096-token level: 429.5 GFLOP, 0.434 ms at the peak, its bytes 0.251 ms; with
    # the 2F-wide output counted (`matmul_bound_s`) the bytes would bound it, 0.451 ms
    assert m.bound_s(262144, 320, 2560) * 1e3 == pytest.approx(0.434274, abs=1e-6)
    assert 2 * (262144 * 320 + 320 * 2560 + 262144 * 1280 + 2560) / 3.35e12 * 1e3 == \
        pytest.approx(0.250897, abs=1e-6)
    assert work.matmul_bound_s(262144, 320, 2560, True) * 1e3 == pytest.approx(0.451222, abs=1e-6)
    total = sum(m.bound_s(*s) * c for s, c in SITES.items())
    assert total * 1e3 == pytest.approx(6.6227, abs=1e-4)   # 15 x 0.434274 + 0.108568


def _run(launched, secs):
    w = work.unet_work(_model("sd2_base"), 64)
    summary = SimpleNamespace(kernel_seconds=lambda *names: (
        secs if names == ("geglu_matmul_kernel",) else 0.0, 0))
    return SimpleNamespace(summary=summary, notes=[],
                           counts={"work": {"unet": (w, 10), "decode": (w, 0)},
                                   "trace_launches": launched})


def test_reader_with_and_without_the_kernel():
    """10 forwards' worth of calls: the share where the counter explains
    them; nothing, and no error, from a program without the counter or
    with launches the work does not explain."""
    read = harness.load_reader("geglu_mm_roofline.gen")
    m = _metric()
    bound = 10 * sum(m.bound_s(*s) * c for s, c in SITES.items())
    run = _run({"geglu_matmul": 160, "skinny_matmul": 1380}, 2 * bound)
    assert read(run) == pytest.approx(50.0)
    parent = _run({"skinny_matmul": 1380}, 0.0)
    assert read(parent) is None and "geglu_matmul" in parent.notes[0]
    assert read(_run({"geglu_matmul": 0}, 0.0)) is None
