#!/usr/bin/env python3
"""Dataset-scale evaluation smoke of the PyTorch/CUDA port: the evaluate
command at the reference's test-split scale (iFashion: 1,988 outfits), to
show that the metric cascades stream. The port's counterpart of
`tools/eval_scale_smoke.py`, with its flags, its synthetic data (the same
`np.random.RandomState(0)` draws, dictionaries and JPEGs, written through
the port's `engine/pipeline.py::save_jpeg`) and its JSON line.

It synthesizes a dataset directory, `--n_items` catalog JPEGs at `--img`
px, a run manifest of `--n_outfits` outfits (FITB: 1 generated image each;
GOR: 4) and the catalog's and histories' CLIP features, then runs
`python -m difashion_tpu_torch evaluate` over it as a child process with
the towers at random weights (`--allow_random_weights`: the full-size ones,
or the tiny ones with `--tiny`, which also runs on the CPU). The child runs
the command through `__main__.main` with its time split into the image
loader (`eval/drivers.py::load_image01`), each tower call of `Extractors`,
the towers' build, and the rest (the cascades' host math, the grids, I/O),
and reports its own peak resident set.

    python3 scripts/eval_scale_smoke_cuda.py [--out DIR] [--task FITB|GOR] [--grounding]
        [--n_outfits 1988] [--n_items 4000] [--img 512] [--batch_size 32]
        [--emb_dim N] [--tiny] [--artifact PATH]

Prints one JSON line (wall seconds, peak RSS, return code, the split per
scored image) and, without `--tiny`, appends it to
`scripts/logs/eval_scale_smoke_cuda.jsonl` (or `--artifact`). The data go to
a temporary directory, deleted at the end, unless `--out`. Exits with the
command's return code.
"""
import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

TOWER_CALLS = ("fid_features", "inception_probs", "clip_image_embs", "clip_text_embs",
               "lpips", "compat_scores")


def synth(out: str, task: str, n_outfits: int, n_items: int, img: int,
          emb_dim: int = 1024) -> dict:
    """The dataset directory, item images and generated-run tree of
    `tools/eval_scale_smoke.py::synth`, draw for draw. Returns the paths."""
    from PIL import Image

    from difashion_tpu_torch.engine.pipeline import save_jpeg

    data_dir = os.path.join(out, "data")
    img_dir = os.path.join(out, "imgs")
    gen_dir = os.path.join(out, "gen")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(os.path.join(data_dir, "map"), exist_ok=True)

    rng = np.random.RandomState(0)
    n_cates = 50

    # the catalog: JPEGs and the iid -> relative path table; item 0 is the
    # white null image (the reference's convention)
    paths = []
    t0 = time.time()
    for iid in range(n_items):
        rel = os.path.join(str(iid % 97), f"{iid}.jpg")
        p = os.path.join(img_dir, rel)
        if not os.path.exists(p):
            if iid == 0:
                arr = np.full((img, img, 3), 255, np.uint8)
            else:
                # a low-frequency random texture compresses about as photos do
                base = rng.rand(8, 8, 3)
                arr = np.kron(base, np.ones((img // 8, img // 8, 1)))
                arr = (np.clip(arr + rng.rand(img, img, 3) * 0.15, 0, 1)
                       * 255).astype(np.uint8)
            save_jpeg(arr, p)
        paths.append(rel)
    print(f"catalog: {n_items} item JPEGs in {time.time() - t0:.1f}s", flush=True)
    np.save(os.path.join(out, "all_item_image_paths.npy"), np.array(paths, dtype=object))

    # the catalog's CLIP features (the precomputed cnn_features_clip.npy)
    cnn = rng.randn(n_items, emb_dim).astype(np.float32)
    cnn /= np.linalg.norm(cnn, axis=-1, keepdims=True)
    np.save(os.path.join(out, "cnn_features_clip.npy"), cnn)

    # the dataset's dictionaries
    id_cate = {c: f"category-{c}" for c in range(1, n_cates + 1)}
    np.save(os.path.join(data_dir, "id_cate_dict.npy"), np.array(id_cate, dtype=object))
    cate_iid = {c: rng.randint(1, n_items, size=200).tolist() for c in range(1, n_cates + 1)}
    np.save(os.path.join(data_dir, "map", "cate_iid_dict.npy"),
            np.array(cate_iid, dtype=object))

    n_users = max(1, n_outfits // 4)
    test_grd, retrieval, history, hist_embs = {}, {}, {}, {}
    man = {}
    n_gen = 1 if task == "FITB" else 4
    run = os.path.join(gen_dir, f"{task}-scale-run")
    t0 = time.time()
    n_imgs = 0
    for i in range(n_outfits):
        uid = 1 + i % n_users
        oid = 10_000 + i
        outfits = rng.randint(1, n_items, size=4)
        cates = rng.randint(1, n_cates + 1, size=4)
        test_grd[oid] = {"outfits": outfits.tolist(), "category": cates.tolist()}
        retrieval.setdefault(uid, {})[oid] = (
            [int(outfits[0])] + rng.randint(1, n_items, size=4).tolist())
        hu = history.setdefault(uid, {})
        for c in cates[:2]:
            hu.setdefault(int(c), rng.randint(1, n_items, size=3).tolist())

        # generated images: catalog textures inverted (distinct files, a
        # distribution apart from the ground truth's)
        img_paths = []
        for j in range(n_gen):
            p = os.path.join(run, "images", str(uid), str(oid), f"{j}.jpg")
            if not os.path.exists(p):
                src = (i * n_gen + j) % (n_items - 1) + 1
                with Image.open(os.path.join(img_dir, paths[src])) as im:
                    arr = np.asarray(im.convert("RGB"))
                save_jpeg(255 - arr, p)
            img_paths.append(p)
            n_imgs += 1
        rec = outfits.copy()
        rec[:n_gen] = 0
        man.setdefault(uid, {})[oid] = {"cates": cates[:n_gen].tolist(), "full_cates": cates,
                                        "outfits": rec, "image_paths": img_paths}
    print(f"manifest: {n_outfits} outfits / {n_imgs} generated JPEGs "
          f"in {time.time() - t0:.1f}s", flush=True)
    np.save(run + ".npy", np.array(man, dtype=object))
    np.save(os.path.join(data_dir, "test_grd.npy"), np.array(test_grd, dtype=object))
    np.save(os.path.join(data_dir, "fitb_test_retrieval_candidates.npy"),
            np.array(retrieval, dtype=object))
    np.save(os.path.join(data_dir, "test_history.npy"), np.array(history, dtype=object))

    # per-(uid, cid) mean history CLIP embeddings (the precompute's contract)
    for uid, by_c in history.items():
        hist_embs[uid] = {c: cnn[np.asarray(v)].mean(0) for c, v in by_c.items()}
    np.save(os.path.join(out, "history_clipembs.npy"), np.array(hist_embs, dtype=object))
    return {"data": data_dir, "imgs": img_dir, "gen": gen_dir, "generated_images": n_imgs}


def child_main(argv) -> None:
    """The evaluate child: `--child OUT -- <evaluate argv>`. Runs the
    command through the dispatcher with the loader's and each tower call's
    seconds summed, and writes them, the build's seconds, the total and its
    own peak resident set to OUT."""
    out, eval_argv = argv[0], argv[2:]
    from difashion_tpu_torch.__main__ import main as dispatch
    from difashion_tpu_torch.cli import evaluate
    from difashion_tpu_torch.eval import drivers

    split = {"loader": {"calls": 0, "seconds": 0.0}, "build_s": 0.0,
             "towers": {k: {"calls": 0, "items": 0, "seconds": 0.0} for k in TOWER_CALLS}}
    build, load = evaluate.build_extractors, drivers.load_image01

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            res = fn(*args)
            rec = split["towers"][name]
            rec["calls"] += 1
            rec["items"] += len(args[0])
            rec["seconds"] += time.perf_counter() - t0
            return res
        return run

    def build_extractors(*args, **kwargs):
        t0 = time.perf_counter()
        X = build(*args, **kwargs)
        split["build_s"] += time.perf_counter() - t0
        for name in TOWER_CALLS:
            setattr(X, name, timed(name, getattr(X, name)))
        return X

    def load_image01(*args, **kwargs):
        t0 = time.perf_counter()
        res = load(*args, **kwargs)
        split["loader"]["calls"] += 1
        split["loader"]["seconds"] += time.perf_counter() - t0
        return res

    evaluate.build_extractors, drivers.load_image01 = build_extractors, load_image01
    t0 = time.perf_counter()
    rc = dispatch(["evaluate", *eval_argv])
    split["total_s"] = time.perf_counter() - t0
    split["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open(out, "w") as f:
        json.dump(split, f)
    sys.exit(rc)


def per_image(split: dict, n_images: int) -> dict:
    """The child's seconds per scored (generated) image: the loader, the
    towers, their build and the rest."""
    towers = sum(t["seconds"] for t in split["towers"].values())
    rest = split["total_s"] - towers - split["loader"]["seconds"] - split["build_s"]
    return {"total_s": split["total_s"] / n_images,
            "loader_s": split["loader"]["seconds"] / n_images,
            "towers_s": towers / n_images, "build_s": split["build_s"] / n_images,
            "rest_s": rest / n_images,
            "by_tower_s": {k: v["seconds"] / n_images for k, v in split["towers"].items()}}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="the data's directory (default: a temporary one, deleted at the end)")
    p.add_argument("--task", choices=["FITB", "GOR"], default="FITB")
    p.add_argument("--grounding", action="store_true")
    p.add_argument("--n_outfits", type=int, default=1988)
    p.add_argument("--n_items", type=int, default=4000)
    p.add_argument("--img", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--emb_dim", type=int, default=None,
                   help="catalog CLIP-feature dim (default: 1024, or 16 with --tiny)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny towers on the CPU (a plumbing check)")
    p.add_argument("--artifact", default=None,
                   help="JSONL to append to (default: scripts/logs/"
                        "eval_scale_smoke_cuda.jsonl in the repo)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        child_main(argv[1:])
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = "cpu" if args.tiny else "cuda"
    emb_dim = args.emb_dim or (16 if args.tiny else 1024)
    keep = args.out is not None
    out = args.out or tempfile.mkdtemp(prefix="eval_scale_")
    try:
        t0 = time.time()
        dirs = synth(out, args.task, args.n_outfits, args.n_items, args.img, emb_dim=emb_dim)
        synth_s = time.time() - t0
        split_path = os.path.join(out, "split.json")
        cmd = [sys.executable, "-u", os.path.abspath(__file__), "--child", split_path, "--",
               "--data_path", dirs["data"], "--gen_dir", dirs["gen"], "--task", args.task,
               "--img_folder_path", dirs["imgs"],
               "--image_paths_npy", os.path.join(out, "all_item_image_paths.npy"),
               "--cnn_features_npy", os.path.join(out, "cnn_features_clip.npy"),
               "--hist_clipembs_npy", os.path.join(out, "history_clipembs.npy"),
               "--batch_size", str(args.batch_size), "--allow_random_weights",
               "--device", device]
        if args.grounding:
            cmd.append("--grounding")
        if args.tiny:
            cmd.append("--tiny")
        print("+", " ".join(cmd), flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, cwd=REPO)
        wall = time.time() - t0
        split = None
        if os.path.exists(split_path):
            with open(split_path) as f:
                split = json.load(f)
    finally:
        if not keep:
            shutil.rmtree(out, ignore_errors=True)
    line = {
        "metric": f"eval_scale_smoke_{args.task}{'_grounding' if args.grounding else ''}",
        "n_outfits": args.n_outfits, "n_items": args.n_items, "img": args.img,
        "device": device, "wall_s": wall, "synth_s": synth_s,
        "peak_rss_gib": split["peak_rss_bytes"] / 2 ** 30 if split else None,
        "returncode": r.returncode, "generated_images": dirs["generated_images"],
        "per_image": per_image(split, dirs["generated_images"]) if split else None,
        "split": split,
    }
    if device.startswith("cuda"):
        from learning_proof_cuda import card

        line.update(card(device))
    print(json.dumps(line), flush=True)
    if not args.tiny:
        art = args.artifact or os.path.join(REPO, "scripts", "logs", "eval_scale_smoke_cuda.jsonl")
        os.makedirs(os.path.dirname(os.path.abspath(art)), exist_ok=True)
        with open(art, "a") as f:
            f.write(json.dumps(line) + "\n")
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
