"""The operation and bound functions against hand counts."""
from __future__ import annotations

import json

import pytest

from benchmark.core import harness, work


def test_attention_bounds_by_hand():
    # sd15's d = 40 self-attention at 4096 tokens, 64 rows, 8 heads: counted at 40
    b, h, s, d = 64, 8, 4096, 40
    ops = 4 * b * h * s * s * d
    assert work.attention_bound_s(b, h, s, s, d) == pytest.approx(ops / 989e12)
    nbytes = 2 * b * h * d * (2 * 77 + 2 * 77) + 4 * b * h * 77
    assert work.attention_bound_s(b, h, 77, 77, d) == pytest.approx(nbytes / 3.35e12)
    dq = 6 * b * h * s * s * d / 989e12
    dkv = 8 * b * h * s * s * d / 989e12
    assert work.backward_bound_s("dq", b, h, s, s, d) == pytest.approx(dq)
    assert work.backward_bound_s("dkv", b, h, s, s, d) == pytest.approx(dkv)


def test_matmul_and_groupnorm_bounds_by_hand():
    m, k, n = 262144, 320, 320   # a 4096-token projection at 64 rows: bytes bound it
    ops = 2 * m * k * n + m * n
    nbytes = 2 * (m * k + k * n + m * n + n)
    assert work.matmul_bound_s(m, k, n, True) == pytest.approx(max(ops / 989e12,
                                                                   nbytes / 3.35e12))
    assert nbytes / 3.35e12 > ops / 989e12
    shape = (16, 128, 512, 512)
    assert work.groupnorm_bound_s(shape) == pytest.approx(
        (2 * 2 * 16 * 128 * 512 * 512 + 2 * 128 * 4) / 3.35e12)
    assert work.skinny_gate(2048, 1280, 320) and not work.skinny_gate(4928, 640, 1024)


def test_unet_work_counts_the_sites():
    mc = json.loads((harness.BENCH / "configs" / "sd15.json").read_text())["model"]
    w = work.unet_work(mc, 64)
    heads = {a[4] for a in w.attention}
    assert heads == {40, 80, 160}
    assert len(w.flash()) == 20 and len(w.attention) == 32   # d = 160 goes plain
    assert len(w.groupnorm) == 61
    assert w.flops / 64 == pytest.approx(8.034e11, rel=1e-3)
    sd2 = json.loads((harness.BENCH / "configs" / "sd2_base.json").read_text())["model"]
    w2 = work.unet_work(sd2, 16)
    # the main path's launches a forward at 16 rows (chip_smoke.py asserts them)
    assert (len(w2.flash()), len(w2.groupnorm), len(w2.skinny())) == (32, 61, 130)
    assert w2.flash_fwd_bound_s() * 1e3 == pytest.approx(2.263, abs=5e-4)
