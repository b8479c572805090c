"""Evaluation CLI: the metric cascades over generated runs. Counterpart of
`difashion_tpu/cli/evaluate.py` (the reference's four evaluation scripts and
their `run_eval_*.sh`), with its flags plus `--device`.

    python -m difashion_tpu_torch evaluate --data_path <dir> --gen_dir <gen> \
        --img_folder_path <imgs> --image_paths_npy <npy> [--task FITB|GOR] \
        [--mode valid|test] [--grounding] [--weights_dir <eval weights>] \
        [--cnn_features_npy <npy>] [--hist_clipembs_npy <npy>] [--device cuda|cpu]

Every `<TASK>-*.npy` manifest under `--gen_dir` (the reference's "all") is
scored by the cascade of (`--task`, `--grounding`) into
`<gen_dir>/eval_results.npy` (`eval_results_grounding.npy`); a metric already
there is skipped. The inputs are checked before any tower is built, and a
run whose outfits are not in the `--mode` split's ground truth stops the
command. The towers are built on `--device` (the card by default) and refuse
to run at random weights unless `--allow_random_weights`.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from difashion_tpu_torch.cli.common import setup_logging
from difashion_tpu_torch.data.datasets import FashionData
from difashion_tpu_torch.eval import drivers
from difashion_tpu_torch.eval.extractors import build_extractors

CASCADES = {("FITB", False): drivers.evaluate_fitb, ("GOR", False): drivers.evaluate_gor,
            ("FITB", True): drivers.evaluate_grounding_fitb,
            ("GOR", True): drivers.evaluate_grounding_gor}


def discover_runs(gen_dir: str, task: str):
    """Run manifests are `<run_name>.npy` beside `<run_name>/images/`; the
    `_grd.npy` ground-truth manifests are not runs."""
    return [p[:-len(".npy")] for p in sorted(glob.glob(os.path.join(gen_dir, f"{task}-*.npy")))
            if not p.endswith("_grd.npy")]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiFashion evaluation (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--gen_dir", required=True)
    p.add_argument("--task", choices=["FITB", "GOR"], default="FITB")
    p.add_argument("--mode", choices=["valid", "test"], default="test")
    p.add_argument("--grounding", action="store_true")
    p.add_argument("--weights_dir", default=None,
                   help="eval tower checkpoints (see eval/extractors.py)")
    p.add_argument("--img_folder_path", default=None)
    p.add_argument("--image_paths_npy", default=None,
                   help="all_item_image_paths.npy (iid -> relative path)")
    p.add_argument("--cnn_features_npy", default=None,
                   help="cnn_features_clip.npy (iid -> 1024-d CLIP embedding)")
    p.add_argument("--hist_clipembs_npy", default=None)
    p.add_argument("--cid_to_label_npy", default=None,
                   help="the finetuned Inception's {cid: class row} map")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="run with towers at random init (the metrics are meaningless)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {run name: its results dict}."""
    args = parse_args(argv)
    log = setup_logging()
    data = FashionData.load(args.data_path)

    # checks before the towers are built and the manifests streamed
    grd = data.valid_grd if args.mode == "valid" else data.test_grd
    if grd is None:
        raise SystemExit(f"no {args.mode}_grd.npy under {args.data_path}: every cascade scores "
                         "against the split's ground truth")
    if args.image_paths_npy is None or args.img_folder_path is None:
        raise SystemExit("--image_paths_npy AND --img_folder_path are required: every "
                         "cascade scores against ground-truth item images")
    if args.grounding:
        if args.cnn_features_npy is None:
            raise SystemExit("--grounding requires --cnn_features_npy (the catalog's CLIP "
                             "features are the retrieval index)")
        if args.task == "FITB" and data.retrieval_candidates.get(args.mode) is None:
            raise SystemExit(f"--grounding FITB requires retrieval candidates for "
                             f"mode={args.mode} in the dataset")
        if args.task == "GOR" and data.cate_iid_dict is None:
            raise SystemExit("--grounding GOR requires map/cate_iid_dict.npy "
                             "(the per-category candidate pools)")

    X = build_extractors(args.weights_dir, batch_size=args.batch_size, tiny=args.tiny,
                         allow_random=args.allow_random_weights, device=args.device)
    load = lambda path: np.load(path, allow_pickle=True) if path else None
    image_paths, cnn = load(args.image_paths_npy), load(args.cnn_features_npy)
    hist_embs = load(args.hist_clipembs_npy).item() if args.hist_clipembs_npy else None
    cid_to_label = load(args.cid_to_label_npy).item() if args.cid_to_label_npy else None

    def item_loader(iid: int):
        return drivers.load_image01(
            os.path.join(args.img_folder_path, str(image_paths[iid])), 512)

    ctx = drivers.EvalContext(
        extractors=X, id_cate_dict=data.id_cate_dict, item_image_loader=item_loader,
        cnn_features_clip=cnn, history_clipembs=hist_embs,
        retrieval_candidates=data.retrieval_candidates.get(args.mode),
        cate_iid_dict=data.cate_iid_dict, cid_to_label=cid_to_label)
    cascade = CASCADES[(args.task, args.grounding)]

    out = {}
    for run in discover_runs(args.gen_dir, args.task):
        # run names do not carry --mode: a run of the other split would fail
        # deep in the cascade, or resume onto the other split's metrics
        man = np.load(run + ".npy", allow_pickle=True).item()
        man_oids = {int(o) for by_oid in man.values() for o in by_oid}
        unknown = man_oids - {int(o) for o in grd}
        if unknown:
            raise SystemExit(
                f"{os.path.basename(run)}: {len(unknown)}/{len(man_oids)} outfit ids not in "
                f"the {args.mode} ground truth (e.g. {sorted(unknown)[:3]}): was this run "
                f"generated with the other --mode?")
        log.info("evaluating %s ...", os.path.basename(run))
        res = out[os.path.basename(run)] = cascade(run, ctx, grd)
        log.info("== %s ==", os.path.basename(run))
        for k, v in res.items():
            log.info("  %s: %s", k, v)
    return out


if __name__ == "__main__":
    main()
