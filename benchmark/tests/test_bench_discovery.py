"""The harness finds a cell's files by name: a configuration, a workload, a
runner and a per-layer metric are added by adding a file, and
BENCHMARK.json names only files that exist, in the contract's forms."""
from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from benchmark.core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_benchmark_json_names_files_that_exist():
    s = spec()
    assert s["command"] == ["python3", "benchmark/run.py"] and s["paths"] == ["benchmark"]
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert harness.load_json(harness.ROOT / c["file"])["reduced"] == c["reduced"]
    for cell in s["workloads"]:
        w = harness.load_json(harness.find("workloads", cell["name"]))
        assert w["config"] == cell["config"] and cell["config"] in configs
        assert cell["chips"] == 1
        harness.find("runners", w["runner"])
    for m in s["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_names_units_and_bounds_keep_the_contract():
    s = spec()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in s[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for cell in s["workloads"]:
        got, layer = harness.cell_metrics(s, cell["name"])
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2 and layer
        assert {m["moves"] for m in layer} <= {m["name"] for m in got}
    for key in ("configs", "workloads"):
        assert all(0 < len(x["why"]) <= 200 and "\n" not in x["why"] for x in s[key])


def test_files_dropped_in_are_found_by_name(tiny_base, tmp_path):
    """A new configuration, workload and per-layer metric, each one file in
    its folder, run with no other edit."""
    base = tmp_path / "bench"
    shutil.copytree(tiny_base, base)
    cfg = json.loads((base / "configs" / "tiny.json").read_text())
    cfg["model"]["unet"]["layers_per_block"] = 2
    (base / "configs" / "tiny_deep.json").write_text(json.dumps(dict(cfg, name="tiny_deep")))
    w = json.loads((base / "workloads" / "tiny.gor.json").read_text())
    w["generation"]["num_inference_steps"] = 2
    (base / "workloads" / "tiny_deep.gor2.json").write_text(json.dumps(dict(w, config="tiny_deep")))
    (base / "metrics").mkdir()
    (base / "metrics" / "batches_seen.gen.py").write_text(
        "def read(run):\n    return float(run.counts['batches'])\n")

    run = harness.Run(cell="tiny_deep.gor2", seed=3, seconds=0.0, trace=False, device="cpu",
                      t0=time.perf_counter(), base=base)
    assert run.model_cfg["unet"]["layers_per_block"] == 2
    harness.load_runner(run.workload["runner"]).run(run)
    assert harness.load_reader("batches_seen.gen", base)(run) == 1.0
    assert run.counts["unet_forwards"] == 3   # PNDM: 2 steps + the corrector
    s = {"end_to_end": [{"name": "images_per_s", "workloads": ["tiny_deep.gor2"]},
                        {"name": "setup_s"}],
         "per_layer": [{"name": "batches_seen.gen", "moves": "images_per_s",
                        "workloads": ["tiny_deep.gor2"]},
                       {"name": "elsewhere.gen", "moves": "images_per_s",
                        "workloads": ["tiny.gor"]}]}
    e2e, layer = harness.cell_metrics(s, "tiny_deep.gor2")
    assert [m["name"] for m in e2e] == ["images_per_s", "setup_s"]
    assert [m["name"] for m in layer] == ["batches_seen.gen"]


def test_unknown_names_are_refused(tiny_base):
    with pytest.raises(FileNotFoundError, match="no workload"):
        harness.find("workloads", "nope.cell", tiny_base)
    with pytest.raises(FileNotFoundError, match="no metric"):
        harness.load_reader("nope.metric")
