"""The readings the SDXL cells' limits are set from: `control.py`'s
generation readings (the program's gap, and the reference computed in fp8
in the program's place) with the `generate_xl` runner, or with
`--program_only` the program's gap alone (the sound runs).

    python3 benchmark/control_xl.py --workload <cell> --seeds 11,12,13 [--program_only]

One line of JSON per seed and kind, as `control.py` prints them. The
benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, device="cuda", base=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program_only", action="store_true")
    args = p.parse_args(argv)

    from benchmark import control
    from benchmark.core import harness
    from benchmark.reference.precision import FP8
    from benchmark.runners import generate_xl as runner

    if device == "cuda":
        harness.require_cuda(1)
        harness.no_jax_by_library()
    kw = {} if base is None else {"base": base}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=args.workload, seed=seed, seconds=0.0, trace=False,
                          device=device, t0=time.perf_counter(), **kw)
        if args.program_only:
            st = runner.setup(run)
            runner.window(run, st)
            runner.free(st)
            runner.check(run, st)
            kinds = [("program", {k: c.value for k, c in run.checks.items()})]
        else:
            prog, ctrl, _, _ = control.gen_readings(run, runner, FP8)
            kinds = [("program", prog), ("control_fp8", ctrl)]
        for kind, numbers in kinds:
            print(json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers,
                              "limits": run.workload["check"]["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
