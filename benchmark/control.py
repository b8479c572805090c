"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program's numbers (its sound run), the control's
(the reference put in the program's place, computed in fp8: e4m3 operands
with per-tensor scales, e5m2 gradients), and for a training cell the fault
"half of the batch left out, the mean taken over the rest" planted in the
fp32 reference put in the program's place, on the first steps and on the
step after a window of `--seconds`. A state left unchanged reads 1 on the
change numbers by their definition and needs no run.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 20]

One line of JSON per seed and kind. The benchmark's own runs do not run
this; `benchmark/tests/test_bench_control.py` runs it at a small size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def gen_readings(run, runner, fp8):
    """(program's gap, control's gap, no faults, no look) of one seed: one batch of the
    program, the check's outfits, the fp32 reference and the fp8 control."""
    st = runner.setup(run)
    runner.window(run, st)
    runner.free(st)
    chosen = runner.picks(run, st)
    ref = runner.reference_images(run, st.traffic, chosen, st.gen_seed, st.outputs)
    prog = runner.program_images(run, chosen, st.outputs)
    ctrl = runner.reference_images(run, st.traffic, chosen, st.gen_seed, st.outputs, fp8)
    olen = run.workload["traffic"]["items_per_outfit"]
    return ({"image_mean_abs_levels": runner.level_gap(prog, ref, olen)},
            {"image_mean_abs_levels": runner.level_gap(ctrl, ref, olen)}, {}, {})


def train_readings(run, runner, fp8):
    """(program's gaps, control's gaps, half-batch fault's gaps, the look)
    of one seed: the first steps and the step after the window (a window of
    `--seconds`), each read by the fp32 reference, the fp8 control and the
    half-batch fault from the same start. The look: the program's three
    worst parameters of each gap (name, gap, reference norm over the median
    parameter's), at step 1 and at the step after the window."""
    st = runner.setup(run)
    runner.window(run, st)
    late = runner.late_step(run, st)
    runner.free(st)
    half = run.workload["traffic"]["outfits_per_step"] // 2
    kinds = {"ref": {}, "ctrl": {"prec": fp8}, "half": {"rows_kept": half}}
    lates = {k: runner.reference_late(run, st, late, **kw) for k, kw in kinds.items()}
    late.drop_copies()
    firsts = {k: runner.reference_readings(run, st, **kw) for k, kw in kinds.items()}
    ref = (firsts["ref"], lates["ref"])

    def worst(prog, ref_r, name):
        g = runner.leaf_gaps(prog, ref_r, name)
        q = getattr(ref_r, name)
        med = float(np.median([q[k] for k in g]))
        return [[k, g[k], q[k] / med] for k in sorted(g, key=g.get, reverse=True)[:3]]
    look = {f"{when}_{name}": worst(prog, ref_r, name)
            for when, prog, ref_r in (("first", st.readings, ref[0]),
                                      ("late", late.readings, ref[1]))
            for name in ("grad", "change", "ema_change")}
    return (runner.compare(st.readings, late.readings, *ref, late.uncounted),
            runner.compare(firsts["ctrl"], lates["ctrl"], *ref),
            {"half_batch": runner.compare(firsts["half"], lates["half"], *ref)}, look)


def main(argv=None, device="cuda", base=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the window before the step after it (training; 0: one step)")
    args = p.parse_args(argv)

    from benchmark.core import harness
    from benchmark.reference.precision import FP8

    if device == "cuda":
        harness.require_cuda(1)
        harness.no_jax_by_library()
    kw = {} if base is None else {"base": base}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=args.workload, seed=seed, seconds=args.seconds, trace=False,
                          device=device, t0=time.perf_counter(), **kw)
        runner = harness.load_runner(run.workload["runner"])
        read = gen_readings if run.workload["runner"] == "generate" else train_readings
        prog, ctrl, faults, look = read(run, runner, FP8)
        limits = run.workload["check"]["limits"]
        for kind, numbers in [("program", prog), ("control_fp8", ctrl)] + list(faults.items()):
            print(json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "limits": limits}), flush=True)
        if look:
            print(json.dumps({"cell": args.workload, "seed": seed, "look": look}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
