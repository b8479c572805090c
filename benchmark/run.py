"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by name
(`core/harness.py`); its runner sets the program up, measures the window
and checks the outputs against the plain reference. With `--trace 0` the
result carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from the window's trace, spans and counters. The
last line of standard output is the result (JSON); the numbers compared
stand as the last lines of standard error. No card, fewer cards than the
cell asks for, or JAX in the process: no result, a non-zero exit.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.core import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    try:
        harness.require_cuda(chips)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    harness.no_jax_by_library()
    run = harness.Run(cell=args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=T0)
    smi = harness.power_limit()
    runner = harness.load_runner(run.workload["runner"])
    runner.run(run)

    found = harness.forbidden_modules()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 4
    import torch

    e2e, layer = harness.cell_metrics(spec, args.workload)
    if args.trace:
        entries, values = layer, {}
        for m in layer:
            values[m["name"]] = harness.load_reader(m["name"])(run)
    else:
        entries = e2e
        values = dict(run.end_to_end, setup_s=run.setup_s)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes, "nvidia_smi": smi}
    breakdown = None
    if args.trace and run.summary is not None:
        device.update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
        breakdown = run.summary.breakdown()
    line = harness.result_line(run, entries, values, device, breakdown)
    for note in run.notes:
        print(f"note: {note}", file=sys.stderr)
    print(json.dumps({"cell": args.workload, "seed": args.seed, "setup_s": run.setup_s,
                      "window_s": run.window_s, "phases": run.phases, "card": run.card,
                      "counts": {k: v for k, v in run.counts.items() if k != "work"}}),
          flush=True)
    for name, c in run.checks.items():
        print(f"check {name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
