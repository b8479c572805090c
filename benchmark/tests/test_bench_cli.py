"""The command refuses to run without a card, and never falls back to the
CPU."""
from __future__ import annotations

import subprocess
import sys

import torch

from benchmark.core import harness

CMD = [sys.executable, str(harness.BENCH / "run.py")]


def test_no_card_no_result():
    if torch.cuda.is_available():
        return   # the refusal is for machines without a card
    p = subprocess.run(CMD + ["--workload", "sd2_base.gor_pndm50", "--seed", "3",
                              "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_unknown_cell_no_result():
    p = subprocess.run(CMD + ["--workload", "nope", "--seed", "3", "--seconds", "1"],
                       capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "unknown workload" in p.stderr


def test_fewer_cards_than_the_cell_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    try:
        harness.require_cuda(4)
    except harness.Refused as e:
        assert "needs 4 card(s)" in str(e)
    else:
        raise AssertionError("a 4-card cell ran on one card")
