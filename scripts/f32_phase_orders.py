#!/usr/bin/env python3
"""The fp32 skinny-N kernel's rows and the fp32 train step, read twice in
opposite orders in one process on one CUDA card, with the card's clocks
beside each reading.

    python3 scripts/f32_phase_orders.py        # from the repository root

It runs chip_smoke.py's phase kernel_mm (the fp32 rows,
`phase_kernel_mm_f32`) and phase train_fp32 as rows, step, step, rows: the
rows once on a card that has run nothing heavy yet and once after two fp32
train steps, the step once after the rows and once after a step. Each
phase's JSON lines are printed as chip_smoke.py prints them; then one line
per reading with the SM clock, power draw and temperature that nvidia-smi
read before and after it, and last a summary: per shape the two readings'
ms and their ratio, and the two steps' seconds and skinny-N device ms. It
asks whether an fp32 number moves with the order of the phases (the open
question of a stray fp32 reading in `PERF.md`).
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)


def clocks():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0] if out.strip() else None


def main():
    import torch

    if not torch.cuda.is_available():
        print("f32_phase_orders: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels

    chip_smoke.phase_device()
    kernels.build_all(("skinny_matmul_f32", "flash_attention_f32", "group_norm_silu"))
    cfg = ModelConfig.sd2_base()
    paths = chip_smoke.dense_sites(cfg, dtype=torch.float32)
    model = create_difashion(cfg, seed=0, device="cuda").prepare_for_training()
    readings = []

    def read(name, fn):
        before = clocks()
        out = fn()
        readings.append({"reading": name, "clocks_before": before, "clocks_after": clocks()})
        print(json.dumps(readings[-1]), flush=True)
        return out

    rows_first, _ = read("rows_first", lambda: chip_smoke.phase_kernel_mm_f32(paths))
    step_after_rows = read("step_after_rows", lambda: chip_smoke.phase_train_fp32(model, paths))
    step_after_step = read("step_after_step", lambda: chip_smoke.phase_train_fp32(model, paths))
    rows_last, _ = read("rows_after_steps", lambda: chip_smoke.phase_kernel_mm_f32(paths))
    per_shape = [{"mkn": a["mkn"], "w_kn": a["w_kn"], "ms": [a["ms"], b["ms"]],
                  "last_over_first": b["ms"] / a["ms"]} for a, b in zip(rows_first, rows_last)]
    steps = [{k: s[k] for k in ("seconds_per_step", "skinny_f32_device_ms",
                                 "convolution_device_ms", "matmul_device_ms")}
             for s in (step_after_rows, step_after_step)]
    print(json.dumps({"summary": {"per_shape": per_shape, "steps": steps,
                                  "ratio_range": [min(r["last_over_first"] for r in per_shape),
                                                  max(r["last_over_first"] for r in per_shape)]}}),
          flush=True)


if __name__ == "__main__":
    main()
