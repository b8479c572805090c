#!/usr/bin/env python3
"""Two checkouts of the port timed on the same card, in turns: the
generation main path, the service's requests, one sampler UNet forward and
one training step by kernel category, and the catalog precompute.

    python3 scripts/ab_paths.py DIR_A DIR_B     # from the repository root, one CUDA card

Each run is a process of its own in one checkout (its package, its sources,
its build, its `chip_smoke.py`), in the order A, B, B, A, so that a drift of
the card or the host shows as a difference between the two runs of one
checkout. A run calls that checkout's `chip_smoke.py` phases `main_path`,
`profile`, `serve`, `precompute` (sd2_base, bf16) and `profile_train` (the recipe's
step over fp32 master weights), and prints their lines prefixed with the
checkout and the run; last, per checkout, the median of its runs of: seconds
per outfit, ms per UNet step, seconds per GOR and FITB request, the UNet
forward's device ms and its layout
and copy buckets, the train step's device ms and its layout and copy
buckets, and the encode batch's device ms. A layout or copy bucket that an
older `chip_smoke.py` does not name is summed from its categories.
"""
import json
import statistics
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.config import ModelConfig
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.nn import kernels

chip_smoke.phase_device()
kernels.build_all()
cfg = ModelConfig.sd2_base()
mm = chip_smoke.dense_sites(cfg)
model = create_difashion(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
chip_smoke.phase_main_path(model, mm)
chip_smoke.phase_profile(model)
chip_smoke.phase_serve(model, mm)
chip_smoke.phase_precompute(model, mm)
del model
torch.cuda.empty_cache()
model = create_difashion(cfg, seed=0, device="cuda").prepare_for_training()
chip_smoke.phase_profile_train(model)
"""


def bucket(prof, name, marks):
    """A category's ms of a device profile, by its name or, in an older
    profile, summed from the kernels that match `marks`."""
    if name in prof:
        return prof[name]
    return sum(t["ms"] for t in prof.get("top", []) if any(m in t["name"] for m in marks))


def run(directory):
    res = subprocess.run([sys.executable, "-c", CHILD.format(directory=directory)],
                         capture_output=True, text=True, cwd=directory, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{directory}: {res.stderr[-3000:]}")
    out = {}
    for line in res.stdout.splitlines():
        if line.startswith('{"phase"'):
            row = json.loads(line)
            out[row["phase"]] = row
    prof, train = out["profile"], out["profile_train"]
    enc = out["precompute"].get("encode_profile", {})
    return {
        "seconds_per_outfit": out["main_path"]["seconds_per_outfit"],
        "ms_per_unet_step": out["main_path"]["ms_per_unet_step"],
        "gor_seconds": out["serve"]["requests"]["gor"]["seconds"],
        "fitb_seconds": statistics.median(out["serve"]["requests"][k]["seconds"]
                                          for k in ("fitb", "fitb_again")),
        "forward_device_ms": prof["device_kernel_ms"],
        "forward_host_wall_ms": prof["host_wall_ms"],
        "forward_layout_ms": prof["by_category_ms"].get("layout NCHW<->NHWC", 0.0),
        "forward_conv_ms": prof["by_category_ms"].get("convolution", 0.0),
        "forward_group_norm_ms": prof["by_category_ms"].get("group_norm_silu", 0.0),
        "forward_copies_ms": bucket(prof, "copies_ms", ("copy",)),
        "train_device_ms": train["device_kernel_ms"],
        "train_layout_ms": train["by_category_ms"].get("layout NCHW<->NHWC", 0.0),
        "train_copies_ms": bucket(train, "copies_ms", ("copy",)),
        "train_split_ms": train["split_ms"],
        "encode_batch_device_ms": enc.get("device_kernel_ms"),
        "encode_layout_ms": enc.get("by_category_ms", {}).get("layout NCHW<->NHWC", 0.0),
        "precompute_seconds_per_1000": out["precompute"]["seconds_per_1000_items"],
        "by_category": {"forward": prof["by_category_ms"], "train": train["by_category_ms"],
                        "encode": enc.get("by_category_ms")},
    }


def main():
    a, b = sys.argv[1:3]
    runs = {a: [], b: []}
    for i, directory in enumerate((a, b, b, a)):
        r = run(directory)
        runs[directory].append(r)
        print(json.dumps({"checkout": directory, "run": i, **r}), flush=True)
    keys = [k for k, v in runs[a][0].items() if isinstance(v, (int, float))]
    print(json.dumps({"median": {d: {k: statistics.median(r[k] for r in rs) for k in keys}
                                 for d, rs in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
