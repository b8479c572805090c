"""The program's spans in a cell: the cell run as `run.py` runs it, with the
port's tracing (`difashion_tpu_torch/core/tracing.py`) on from before
set-up, and the device time of the profiled part (the gen window, the
train cell's profiled steps) credited to the span that launched it
(`core/program_trace.py`).

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s> [--trace 0|1]

One line of JSON: the run's `correct`, end-to-end numbers and set-up, and
with `--trace 1` the cell's per-layer metrics as `run.py --trace 1` reads
them, the attribution (device seconds per span, self and total; the share
no span covers; the top (span, kernel) pairs; each elementwise and reduce
kernel's seconds by span), the idle gaps labelled by the innermost span, and
`layers`:
  gen: device ms per UNet forward (`gen.unet_forwards`) in `unet.resnet`,
    `unet.transformer`, `gen.sample`, and `gen.sample` outside `gen.unet`
    (`sampler_glue_ms`), beside `unet_step_ms.gen`;
  train: device ms per profiled step in `train.forward`, `train.backward`
    and `train.update`, and all of the step's (`device_ms`), beside
    `fwd_bwd_ms.train`.
Train, either way: `host_ms`, the host ms per window step inside
`train.forward`, `train.backward` and `train.update` less `train.sync`, and
`step_ms`, the window's ms per step. Once the device paces the step the
host blocks in its launches when the launch queue is full, so `host_ms`
then reads near the device's time a step; only `step_ms` above the device's
time shows the host pacing it. `--trace 0` runs no profiler: the end-to-end
numbers then carry the spans' own cost, against `run.py --trace 0`'s with
them off. The benchmark's own runs do not run this tool.
"""
import time

T0 = time.perf_counter()   # set-up is counted from here, as in run.py

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ELEMENTWISE = ("elementwise_kernel", "vectorized_elementwise_kernel",
               "unrolled_elementwise_kernel", "reduce_kernel")


def host_ms_per_step(run):
    from difashion_tpu_torch.core.tracing import host_ms

    steps = run.counted.get("train.steps")
    if not steps:
        return None
    ms = lambda *names: sum(sum(host_ms(run.records, n)) for n in names)
    return (ms("train.forward", "train.backward", "train.update") - ms("train.sync")) / steps


def layers(run, read) -> dict:
    """The numbers of the module's docstring; `read(metric)` reads one of
    the cell's per-layer metrics."""
    p = run.program
    if run.workload["runner"] == "generate":
        if p is None:
            return {}
        per = lambda span, minus=(): p.ms_per(span, "gen.unet_forwards", minus)
        return {"unet_resnet_ms": per("unet.resnet"),
                "unet_transformer_ms": per("unet.transformer"),
                "sample_ms": per("gen.sample"), "sampler_glue_ms": per("gen.sample", ("gen.unet",)),
                "unet_step_ms.gen": read("unet_step_ms.gen")}
    out = {"host_ms": host_ms_per_step(run),
           "step_ms": 1e3 * run.window_s / run.counts["steps"]}
    if p is not None and p.counts.get("train.steps"):
        per = lambda span: p.ms_per(span, "train.steps")
        out.update(forward_ms=per("train.forward"), backward_ms=per("train.backward"),
                   update_ms=per("train.update"),
                   device_ms=1e3 * p.device_s / p.counts["train.steps"],
                   **{"fwd_bwd_ms.train": read("fwd_bwd_ms.train")})
    return out


def main(argv=None, device="cuda", base=None, t0=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    from benchmark.core import harness
    from benchmark.core.program_trace import TracedRun

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    if device == "cuda":
        chips = {c["name"]: c["chips"] for c in spec["workloads"]}[args.workload]
        harness.require_cuda(chips)
        harness.no_jax_by_library()
    kw = {} if base is None else {"base": base}
    run = TracedRun(cell=args.workload, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=device, t0=T0 if t0 is None else t0, **kw)
    harness.load_runner(run.workload["runner"]).run(run)

    names = [m["name"] for m in spec["per_layer"] if args.workload in m["workloads"]]
    metrics = {n: harness.load_reader(n)(run) for n in names} if args.trace else {}
    out = {"cell": args.workload, "seed": args.seed, "trace": args.trace,
           "correct": bool(run.checks) and all(c.ok for c in run.checks.values()),
           "end_to_end": dict(run.end_to_end, setup_s=run.setup_s), "card": run.card,
           "layers": layers(run, metrics.get), "metrics": metrics}
    if run.program is not None:
        out.update(program=run.program.summary(),
                   elementwise_s={op: run.program.op_by_span(op) for op in ELEMENTWISE})
    if run.summary is not None:
        out["gaps"] = run.summary.gaps
    for note in run.notes:
        print(f"note: {note}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
