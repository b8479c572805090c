"""`python -m difashion_tpu_torch info`: the devices the other commands will
see, and the memory plan of a training configuration. Counterpart of
`difashion_tpu/cli/info.py`.

Prints the backend (cuda, or cpu with no card visible), the number of
visible cards and their name, the torch and CUDA versions, the device count
the plan is for, and the training state's bytes per device
(`engine/memory.py`, planned on the meta device: nothing is allocated)
against a memory budget, 80 GiB by default (an H100 80GB).
"""
from __future__ import annotations

import argparse
import json


def device_report(dp_size: int = 0) -> dict:
    """The devices, and the data-parallel world the plan is for: dp_size, or
    the world a train command started alike would take (torchrun's group
    size; 1 without torchrun: one process trains on one device)."""
    import torch

    from difashion_tpu_torch.core.distributed import world_size

    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 1
    return {
        "backend": "cuda" if cuda else "cpu",
        "devices": n,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "mesh": {"dp": dp_size if dp_size > 0 else world_size()},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="difashion_tpu_torch info",
                                description="devices + training-state memory planner")
    p.add_argument("--model", choices=["sd2_base", "sd15", "tiny"], default="sd2_base")
    p.add_argument("--dp_size", type=int, default=0,
                   help="devices to plan for (default: the torchrun group's size, else 1)")
    p.add_argument("--adam8bit", action="store_true",
                   help="plan with block-wise int8 Adam moments")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--hbm_gib", type=float, default=80.0,
                   help="memory budget per device in GiB (H100 80GB default)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--skip_accounting", action="store_true", help="devices only")
    args = p.parse_args(argv)

    env = device_report(args.dp_size)
    acc = None
    if not args.skip_accounting:
        from difashion_tpu_torch.config import ModelConfig, TrainConfig
        from difashion_tpu_torch.engine.memory import state_memory_accounting

        tcfg = TrainConfig(learning_rate=1e-5, use_8bit_adam=args.adam8bit,
                           use_ema=not args.no_ema, use_ema_fashion=not args.no_ema)
        acc = state_memory_accounting(getattr(ModelConfig, args.model)(), tcfg,
                                      n_devices=env["mesh"]["dp"])
    budget = int(args.hbm_gib * 2**30)
    if args.json:
        out = dict(env)
        if acc is not None:
            out["hbm_accounting"] = {**acc, "hbm_budget_bytes": budget,
                                     "fits_dp": acc["per_chip_bytes_dp"] <= budget,
                                     "fits_zero1": acc["per_chip_bytes_zero1"] <= budget}
        print(json.dumps(out))
        return out
    for k, v in env.items():
        print(f"{k:<12} {v}")
    if acc is not None:
        from difashion_tpu_torch.engine.memory import format_accounting

        print()
        print(format_accounting(acc, hbm_bytes=budget))
    return env


if __name__ == "__main__":
    main()
