"""Quality-parity runbook: generate, evaluate, compare with the reference.
Counterpart of `difashion_tpu/cli/parity.py`, with its flags plus `--device`.
One command for the reference's release check (train -> `checkpoint-15000`
-> `inf4eval.py` -> `evaluate_fitb.py`): the port's `generate` on the
split, the port's `evaluate` over the run just generated (and its grounding
cascade with `--grounding`), then the table of our metrics against the
reference's, FID and LPIPS gated at 2 %:

    python -m difashion_tpu_torch parity --ckpt_dir ckpt/ --weights_dir eval_weights/ \
        --data_path datasets/ifashion --img_folder_path imgs/ \
        --image_paths_npy all_item_image_paths.npy \
        --reference_results ref_eval_results.npy --out_dir parity_run/ [--device cuda|cpu]

`--reference_results` takes the reference's `eval_results.npy` ({run name:
{metric: value}}, its first run) or a flat JSON {metric: value}; without it
the table is ours only and no gate runs. The table is also written to
`<out_dir>/parity_table.json` (atomically). A gated metric outside 2 %, or
not measured, exits non-zero.

Strict by design: it refuses the hash tokenizer and towers at random
weights; `--allow_random_weights` exists for the tests and plumbing runs
only. The generation model is freed before the towers are built.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
from typing import Dict, Optional

import numpy as np

from difashion_tpu_torch.cli.common import setup_logging

# gated at 2 % (FID and LPIPS within 2 % of the reference); the rest are
# reported with their relative difference
GATED = ("fid", "lpips")
GATE_PCT = 2.0


def load_reference_results(path: Optional[str]) -> Dict[str, float]:
    """{metric: float} from a flat JSON, or from a results file (its first
    run); values that are not numbers (the Inception metrics' dict) are left
    out."""
    if not path:
        return {}
    if path.endswith(".json"):
        with open(path) as f:
            return {k: float(v) for k, v in json.load(f).items()}
    obj = np.load(path, allow_pickle=True).item()
    if obj and all(isinstance(v, dict) for v in obj.values()):
        obj = next(iter(obj.values()))
    return {k: x for k, x in ((k, _number(v)) for k, v in obj.items()) if x is not None}


def _number(v) -> Optional[float]:
    """A metric's value as a float, None where it is not a number."""
    try:
        return float(np.asarray(v).reshape(-1)[0])
    except (TypeError, ValueError):
        return None


def parity_table(ours: Dict[str, float], reference: Dict[str, float]) -> list:
    """Rows (metric, ours, reference, delta %, gate). A gated metric that the
    reference pins and we did not measure (or cannot read) FAILs: a parity
    run never passes with FID or LPIPS unchecked."""
    rows = []
    for k in sorted(set(ours) | set(reference)):
        o = _number(ours[k]) if k in ours else None
        r = reference.get(k)
        if o is None or r is None:
            if k in GATED and r is not None:
                rows.append((k, o, r, None, "FAIL (gated metric not measured)"))
            else:
                rows.append((k, o, r, None,
                             "no reference value" if r is None else "not measured"))
            continue
        delta = abs(o - r) / max(abs(r), 1e-12) * 100.0
        if k in GATED:
            status = (f"PASS (<= {GATE_PCT}%)" if delta <= GATE_PCT
                      else f"FAIL (> {GATE_PCT}%)")
        else:
            status = "reported"
        rows.append((k, o, r, delta, status))
    return rows


def print_table(rows: list, log) -> bool:
    """Log the table; False when a row FAILs."""
    log.info("%-22s %12s %12s %9s  %s", "metric", "ours", "reference", "delta%", "gate")
    for k, o, r, d, status in rows:
        log.info("%-22s %12s %12s %9s  %s", k,
                 f"{o:.5g}" if o is not None else "-", f"{r:.5g}" if r is not None else "-",
                 f"{d:.2f}" if d is not None else "-", status)
    return not any(status.startswith("FAIL") for *_, status in rows)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiFashion quality-parity runbook (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--ckpt_step", type=int, default=None)
    p.add_argument("--weights_dir", required=True,
                   help="eval tower checkpoints (eval/extractors.py's layout)")
    p.add_argument("--tokenizer_dir", default=None,
                   help="CLIP vocab.json + merges.txt (default: <weights_dir>/tokenizer)")
    p.add_argument("--img_folder_path", required=True)
    p.add_argument("--image_paths_npy", required=True)
    p.add_argument("--cnn_features_npy", default=None)
    p.add_argument("--hist_clipembs_npy", default=None)
    p.add_argument("--cid_to_label_npy", default=None)
    p.add_argument("--reference_results", default=None)
    p.add_argument("--task", choices=["FITB", "GOR"], default="FITB")
    p.add_argument("--mode", choices=["valid", "test"], default="valid")
    p.add_argument("--out_dir", default="parity_run")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--grounding", action="store_true", help="also run the grounding cascade")
    p.add_argument("--config", default=None,
                   help="model / generation config JSON, passed to generate (needed for a "
                        "checkpoint not trained on a preset)")
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--scheduler", choices=["pndm", "ddim", "dpmpp"], default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="tests and plumbing only: never a real parity run")
    p.add_argument("--table_out", default=None,
                   help="where to write the table as JSON (default: "
                        "<out_dir>/parity_table.json)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the table as written to the JSON artifact."""
    args = parse_args(argv)
    log = setup_logging()
    tok_dir = args.tokenizer_dir or os.path.join(args.weights_dir, "tokenizer")
    shared = ["--data_path", args.data_path, "--task", args.task, "--mode", args.mode,
              "--device", args.device] + (["--tiny"] if args.tiny else []) + (
        ["--allow_random_weights"] if args.allow_random_weights else [])

    # 1) generate on the split (refuses the hash tokenizer)
    from difashion_tpu_torch.cli.generate import main as generate_main

    gen_argv = shared + ["--ckpt_dir", args.ckpt_dir, "--output_dir", args.out_dir,
                         "--tokenizer_dir", tok_dir]
    # the generation settings the checkpoint is meant to run with
    for flag, val in (("--ckpt_step", args.ckpt_step), ("--max_batches", args.max_batches),
                      ("--config", args.config),
                      ("--num_inference_steps", args.num_inference_steps),
                      ("--scheduler", args.scheduler), ("--seed", args.seed)):
        if val is not None:
            gen_argv += [flag, str(val)]
    log.info("[parity 1/3] generation: %s %s", args.task, args.mode)
    this_run = os.path.basename(generate_main(gen_argv))
    # the UNet and the VAE are garbage once generate returns: give their
    # memory back before the towers are built beside nothing
    gc.collect()
    if args.device.startswith("cuda"):
        import torch

        torch.cuda.empty_cache()

    # 2) every cascade of the task over the run (refuses random towers)
    from difashion_tpu_torch.cli.evaluate import main as evaluate_main

    eval_argv = shared + ["--gen_dir", args.out_dir, "--weights_dir", args.weights_dir,
                          "--img_folder_path", args.img_folder_path,
                          "--image_paths_npy", args.image_paths_npy,
                          "--batch_size", str(args.batch_size)]
    for flag, val in (("--cnn_features_npy", args.cnn_features_npy),
                      ("--hist_clipembs_npy", args.hist_clipembs_npy),
                      ("--cid_to_label_npy", args.cid_to_label_npy)):
        if val:
            eval_argv += [flag, val]
    log.info("[parity 2/3] evaluation cascades")
    evaluate_main(eval_argv)
    if args.grounding:
        evaluate_main(eval_argv + ["--grounding"])

    # 3) the table, for the run just generated (the results file keeps every
    # run ever evaluated into out_dir)
    results_path = os.path.join(args.out_dir, "eval_results.npy")
    all_results = np.load(results_path, allow_pickle=True).item()
    if this_run not in all_results:
        raise SystemExit(f"run {this_run!r} missing from {results_path} "
                         f"(found: {sorted(all_results)[:3]})")
    ours = dict(all_results[this_run])
    if args.grounding:
        gpath = os.path.join(args.out_dir, "eval_results_grounding.npy")
        gres = np.load(gpath, allow_pickle=True).item().get(this_run, {})
        ours.update({f"grounding_{k}": v for k, v in gres.items()})
    reference = load_reference_results(args.reference_results)
    if args.reference_results and not reference:
        raise SystemExit(f"--reference_results {args.reference_results!r} yielded no usable "
                         "metric value (wrong file or layout?): refusing to report a table "
                         "whose gates are idle as if no reference were given")
    log.info("[parity 3/3] reference comparison for %s", this_run)
    rows = parity_table(ours, reference)
    ok = print_table(rows, log)
    table = {"run": this_run, "task": args.task, "mode": args.mode, "gated": list(GATED),
             "gate_pct": GATE_PCT,
             "rows": [{"metric": k, "ours": o, "reference": r, "delta_pct": d, "gate": status}
                      for k, o, r, d, status in rows],
             "ok": ok}
    table_out = args.table_out or os.path.join(args.out_dir, "parity_table.json")
    tmp = table_out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1)
    os.replace(tmp, table_out)
    log.info("parity table written: %s", table_out)
    if reference and not ok:
        raise SystemExit("parity FAILED: a gated metric outside the 2% window or not measured")
    if not reference:
        log.info("(no --reference_results: the table is ours only, no gate ran)")
    log.info("parity run complete: %s", results_path)
    return table


if __name__ == "__main__":
    main()
