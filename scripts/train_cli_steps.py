#!/usr/bin/env python3
"""Seconds per step of the train command on one CUDA card, with its batch
copied to the card as shipped (through pinned memory, without blocking) and,
as a yardstick, from pageable memory (each such copy waits for the stream:
a second host sync per step), in turns shipped, pageable, pageable, shipped.

    python3 scripts/train_cli_steps.py [--steps 12] [--skip 2]   # from the repository root

Each leg is `cli/train.py::main --device cuda` at the sd2_base widths with
the recipe (`Config.preset_eta01()`), seeded random weights and the hash
tokenizer, on chip_smoke's synthetic dataset, for `--steps` steps (and the
checkpoint at the last). `chip_smoke.TrainCliProbe` records each step from
outside the command: the host clock at its start and CUDA events around it.
Per leg one JSON line: the host's interval from one step to the next and the
events' ms, over the steps after the first `--skip`; last, per variant, the
medians over its legs.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)


def pageable(assemble):
    """`assemble_batch` with each tensor copied from pageable memory."""
    from difashion_tpu_torch.engine.train import TrainBatch

    def run(*args, device="cuda", **kwargs):
        batch = assemble(*args, device="cpu", **kwargs)
        return TrainBatch(*(None if t is None else t.to(device) for t in batch))
    return run


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--skip", type=int, default=2, help="steps left out of the medians")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("train_cli_steps: needs a CUDA device")
    import dataclasses

    from difashion_tpu_torch.cli import train as train_cli
    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.nn import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    kernels.build_all()   # every source at once, before the first leg
    shipped = train_cli.assemble_batch
    root = tempfile.mkdtemp(prefix="difashion_train_cli_steps_")
    probe = chip_smoke.TrainCliProbe()
    medians = {"shipped": {"host_ms": [], "events_ms": []},
               "pageable": {"host_ms": [], "events_ms": []}}
    try:
        cfg = Config.preset_eta01()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpointing_steps=args.steps, checkpoints_total_limit=1))
        data = os.path.join(root, "data")
        os.makedirs(data)
        chip_smoke.write_train_cli_dataset(data, cfg.model)
        cfg_path = os.path.join(root, "config.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        for leg, variant in enumerate(("shipped", "pageable", "pageable", "shipped")):
            train_cli.assemble_batch = shipped if variant == "shipped" else pageable(shipped)
            out = os.path.join(root, f"ckpt{leg}")
            first = len(probe.steps)
            state, model = train_cli.main(["--data_path", data, "--output_dir", out,
                                           "--config", cfg_path, "--device", "cuda",
                                           "--max_train_steps", str(args.steps)])
            torch.cuda.synchronize()
            rows = probe.steps[first:]
            host = [(b["host_start"] - a["host_start"]) * 1e3
                    for a, b in zip(rows, rows[1:])][args.skip:]
            events = [r["events"][0].elapsed_time(r["events"][1]) for r in rows][args.skip:]
            row = {"leg": leg, "variant": variant, "steps": len(rows),
                   "host_interval_ms": host, "events_ms": events,
                   "median_host_ms": statistics.median(host),
                   "median_events_ms": statistics.median(events)}
            print(json.dumps(row), flush=True)
            medians[variant]["host_ms"].append(row["median_host_ms"])
            medians[variant]["events_ms"].append(row["median_events_ms"])
            del state, model
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        train_cli.assemble_batch = shipped
        probe.restore()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"summary": {v: {k: statistics.median(x) for k, x in m.items()}
                                  for v, m in medians.items()}, "legs": medians}))


if __name__ == "__main__":
    main()
