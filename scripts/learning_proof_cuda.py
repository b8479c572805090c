#!/usr/bin/env python3
"""Mid-scale learning proof of the PyTorch/CUDA port: overfit a 64 px
DiFashion on one memorized outfit through the port's own commands and the
production sampling path (4-branch CFG, 50-step PNDM), and gate on the
image-space reconstruction of the memorized items. The port's counterpart of
`tools/learning_proof_tpu.py`, with the same mid config, flow and gates:

  train (two legs, the second resumed from the first's checkpoint)
  -> generate FITB and GOR with the EMA and the raw weights
  -> per generated slot, the mean squared distance to the VAE decode of each
     of the 4 catalog items: the slot passes when its own item is nearest
     and nearer than `margin` x the next one (FITB: 0.65, all 4 slots; GOR:
     0.8, at least 14 of 16), on either weight set; and the loss fell
     (the mean of the last logged windows below 0.6 x the first ones).

Every attention of the port runs on the flash kernels (no threshold as in the
JAX package), so the mid config's 64-token attentions train and sample
through them on the card; the report's `preset` records the kernel launches
of each train step and each sampler UNet forward.

    python3 scripts/learning_proof_cuda.py [--steps 6000] [--device cuda|cpu]
        [--workdir DIR] [--report PATH] [--tiny] [--plain_versions]

`--plain_versions` runs the same proof with every kernel's caller on its
plain PyTorch version, to tell the kernels' part in a result from the
recipe's. `--tiny` runs the CPU-sized proof of `tests/test_learning_e2e.py`
(the tiny preset, 300 steps, 10-step sampling). The fixture is written into
the work directory (a temporary one, deleted at the end, unless
`--workdir`); the report goes to `scripts/logs/learning_proof_cuda.json`
unless `--report`. Exits 1 when a gate fails.
"""
import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

OLEN = 4
N_ITEMS = 5   # item 0 is the null (white) item; item i has category i


def mid_config(out_dir: str, img: int, steps: int, inf_steps: int, lr: float = 5e-4):
    """img px images, img/8 latents, UNet channels (128, 256, 384, 384) at
    d = 64, the recipe's CFG scales; batch 8 (the fixture's 8 rows, full
    batch), checkpoints at steps // 2."""
    from difashion_tpu_torch.config import (
        CLIPTextConfig,
        Config,
        DataConfig,
        GenerationConfig,
        ModelConfig,
        MutualEncoderConfig,
        UNetConfig,
        VAEConfig,
    )

    lat = img // 8
    model = ModelConfig(
        unet=UNetConfig(sample_size=lat, block_out_channels=(128, 256, 384, 384),
                        layers_per_block=1, cross_attention_dim=256, attention_head_dim=64,
                        norm_num_groups=32),
        vae=VAEConfig(block_out_channels=(32, 64, 128, 128), layers_per_block=1,
                      norm_num_groups=16, sample_size=img),
        text=CLIPTextConfig(vocab_size=1000, hidden_size=256, intermediate_size=512,
                            num_layers=4, num_heads=4),
        mutual=MutualEncoderConfig(latent_channels=4, latent_size=lat, hid_dim=128))
    cfg = Config(model=model, data=DataConfig(img_size=img),
                 generation=dataclasses.replace(
                     GenerationConfig(), num_inference_steps=inf_steps, height=img, width=img,
                     fitb_batch_size=4, gor_batch_size=2))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, output_dir=out_dir, checkpointing_steps=max(1, steps // 2),
        train_batch_size=8, learning_rate=lr, max_train_steps=steps))


def tiny_config(out_dir: str, steps: int, inf_steps: int = 10):
    """`tests/test_learning_e2e.py`'s: the tiny preset, batch 4, lr 1e-3,
    10-step sampling."""
    from difashion_tpu_torch.config import Config

    cfg = Config.preset_tiny()
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, output_dir=out_dir,
                                  checkpointing_steps=max(1, steps // 2), train_batch_size=4,
                                  learning_rate=1e-3, max_train_steps=steps),
        generation=dataclasses.replace(cfg.generation, num_inference_steps=inf_steps,
                                       fitb_batch_size=4, gor_batch_size=2))


def write_dataset(dpath: str, cfg) -> np.ndarray:
    """The fixture of `tests/test_learning_e2e.py`: 4 items (item i in
    category i) and one outfit [1, 2, 3, 4] repeated in 8 training rows; a
    FITB test table with each slot blanked in turn, its ground truth and
    histories; the items' VAE moments (log-variance -30: a deterministic
    sample). Returns the scaled catalog latents [N_ITEMS, h, h, C]."""
    os.makedirs(dpath, exist_ok=True)
    h = cfg.model.unet.sample_size
    C = cfg.model.vae.latent_channels
    sf = cfg.model.vae.scaling_factor
    rng = np.random.RandomState(7)
    scaled = rng.randn(N_ITEMS, h, h, C).astype(np.float32) * 0.8
    scaled[0] = 0.0                      # null item
    mean = scaled / sf
    logvar = np.full_like(mean, -30.0)

    n_rows = 8
    save = lambda name, obj: np.save(os.path.join(dpath, name), np.array(obj, dtype=object))
    save("train.npy", {"uids": [1] * n_rows, "oids": list(range(100, 100 + n_rows)),
                       "outfits": [[1, 2, 3, 4]] * n_rows, "category": [[1, 2, 3, 4]] * n_rows})
    fitb_outfits = []
    for k in range(OLEN):
        o = [1, 2, 3, 4]
        o[k] = 0
        fitb_outfits.append(o)
    save("fitb_test.npy", {"uids": [1] * OLEN, "oids": list(range(200, 200 + OLEN)),
                           "outfits": fitb_outfits, "category": [[1, 2, 3, 4]] * OLEN})
    save("test_grd.npy", {oid: {"outfits": [1, 2, 3, 4], "category": [1, 2, 3, 4]}
                          for oid in range(200, 200 + OLEN)})
    history = {1: {c: [c] for c in range(1, 5)}}
    save("train_history.npy", history)
    save("test_history.npy", history)
    save("id_cate_dict.npy", {c: f"cate{c}" for c in range(1, 5)})
    os.makedirs(os.path.join(dpath, "processed"), exist_ok=True)
    np.savez(os.path.join(dpath, "processed", "all_item_moments.npz"), mean=mean, logvar=logvar)
    return scaled


class LaunchProbe:
    """The kernel launches of each train step (the step that
    `cli/train.py::build_train_step` returns, wrapped from outside, with the
    TrainState's step at its entry) and of each UNet forward (while
    `sampling` is set). `restore()` puts the originals back."""

    def __init__(self):
        from difashion_tpu_torch.cli import train as train_cli
        from difashion_tpu_torch.models.unet import UNet2DCondition
        from difashion_tpu_torch.nn import kernels

        self.steps, self.forwards, self.sampling = [], [], None
        self._orig = [(train_cli, "build_train_step", train_cli.build_train_step),
                      (UNet2DCondition, "forward", UNet2DCondition.forward)]
        build, forward = (o[2] for o in self._orig)
        probe = self

        def counted(fn, record):
            def run(*args, **kwargs):
                before = dict(kernels.LAUNCHES)
                out = fn(*args, **kwargs)
                record({k: kernels.LAUNCHES[k] - before[k] for k in kernels.COUNTERS})
                return out
            return run

        def build_train_step(model, cfg):
            step, init = build(model, cfg)

            def run(state, *args):
                at = state.step
                return counted(step, lambda n: probe.steps.append(
                    {"at_step": at, "launches": n}))(state, *args)
            return run, init

        def unet_forward(self_, *args, **kwargs):
            if probe.sampling is None:
                return forward(self_, *args, **kwargs)
            return counted(forward, lambda n: probe.forwards.append(
                {"task": probe.sampling, "launches": n}))(self_, *args, **kwargs)

        train_cli.build_train_step = build_train_step
        UNet2DCondition.forward = unet_forward

    def restore(self):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)


def distinct(records) -> list:
    """The distinct launch counts among `records`, in order of appearance."""
    out = []
    for r in records:
        if r["launches"] not in out:
            out.append(r["launches"])
    return out


def card(device: str) -> dict:
    """The device's name, and the card's name and power limit as nvidia-smi
    prints them."""
    import torch

    if not device.startswith("cuda"):
        return {"device": device}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def reconstruction(man: dict, cat_imgs: np.ndarray, margin_gate: float, min_correct: int):
    """Per generated slot, the distances to the 4 catalog decodes and
    whether its own item is nearest within the margin."""
    from PIL import Image

    n_correct, slots = 0, []
    for per in man.values():
        for oid, rec in per.items():
            for i, pth in enumerate(rec["image_paths"]):
                img = np.asarray(Image.open(pth), np.float32)
                tgt = rec["cates"][i]
                d = [float(np.mean((img - cat_imgs[j]) ** 2)) for j in range(4)]
                others = [d[j] for j in range(4) if j + 1 != tgt]
                ok = int(np.argmin(d)) + 1 == tgt and d[tgt - 1] < margin_gate * min(others)
                n_correct += int(ok)
                slots.append({"oid": int(oid), "slot": i, "target": int(tgt), "dists": d,
                              "ok": bool(ok)})
    return {"n_checked": len(slots), "n_correct": n_correct, "gate_min_correct": min_correct,
            "passed": n_correct >= min_correct, "slots": slots}


def run(args) -> dict:
    import torch

    from difashion_tpu_torch.cli import generate as generate_cli
    from difashion_tpu_torch.cli import train as train_cli
    from difashion_tpu_torch.cli.generate import load_model_for_inference, run_name
    from difashion_tpu_torch.engine.generate import decode_to_uint8

    wd = args.workdir
    dpath, ckpt, gen_dir = (os.path.join(wd, d) for d in ("data", "ckpt", "gen"))
    cfg = (tiny_config(ckpt, args.steps, args.inference_steps) if args.tiny
           else mid_config(ckpt, args.img, args.steps, args.inference_steps, lr=args.lr))
    scaled_latents = write_dataset(dpath, cfg)
    cfg_path = os.path.join(wd, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    g = cfg.generation
    report = {"preset": {"config": "tiny" if args.tiny else "mid", "img": g.height,
                         "steps": args.steps, "lr": cfg.train.learning_rate,
                         "batch": cfg.train.train_batch_size,
                         "inference_steps": g.num_inference_steps, "scheduler": g.scheduler,
                         "mixed_precision": cfg.train.mixed_precision,
                         "plain_versions": args.plain_versions, **card(args.device)}}

    probe = LaunchProbe()
    try:
        # ---- train in two legs (a checkpoint, then a resume), the port's command
        t0 = time.perf_counter()
        common = ["--data_path", dpath, "--output_dir", ckpt, "--config", cfg_path,
                  "--device", args.device]
        legs = []
        for extra in (["--max_train_steps", str(cfg.train.checkpointing_steps)],
                      ["--resume_from_checkpoint", "latest"]):
            first = len(probe.steps)
            state, model = train_cli.main(common + extra)
            rows = probe.steps[first:]
            legs.append({"first_step": rows[0]["at_step"] if rows else None,
                         "steps": len(rows), "end_step": int(state.step)})
            del state, model
        report["train_wall_s"] = time.perf_counter() - t0
        report["legs"] = legs
        report["checkpoints"] = sorted(int(n.split("-")[1]) for n in os.listdir(ckpt)
                                       if n.startswith("checkpoint-"))
        with open(os.path.join(ckpt, "metrics.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        # one step's diffusion loss is a draw of its timestep: gate on the
        # means of the first and the last k logged windows
        k = max(1, min(5, len(losses) // 4))
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        report.update(losses=losses, loss_first=first, loss_last=last, loss_windows_k=k,
                      losses_finite=bool(np.all(np.isfinite(losses))),
                      loss_fell=bool(last < 0.6 * first))
        print(f"train: {args.steps} steps in {report['train_wall_s']:.1f} s, loss "
              f"mean[:{k}] {first:.4f} -> mean[-{k}:] {last:.4f}", flush=True)

        # ---- generate FITB and GOR with the EMA weights (the production path)
        # and the raw ones: at this scale the EMA can lag a freshly memorized
        # fixture, so the gates take either, and both are recorded
        t0 = time.perf_counter()
        variants = ("ema", "raw")
        runs = {}
        for task in ("FITB", "GOR"):
            for variant in variants:
                probe.sampling = task
                out = generate_cli.main(
                    ["--data_path", dpath, "--ckpt_dir", ckpt, "--task", task, "--mode", "test",
                     "--output_dir", f"{gen_dir}_{variant}", "--config", cfg_path,
                     "--allow_random_weights", "--device", args.device]
                    + (["--no_ema"] if variant == "raw" else []))
                probe.sampling = None
                man = np.load(out + ".npy", allow_pickle=True).item()
                jpgs = [p for per in man.values() for rec in per.values()
                        for p in rec["image_paths"]]
                runs[f"{task}_{variant}"] = {"run": os.path.basename(out), "images": len(jpgs),
                                             "jpegs_exist": all(map(os.path.exists, jpgs))}
        report["generate_wall_s"] = time.perf_counter() - t0
        report["runs"] = runs
    finally:
        probe.restore()
    report["preset"]["launches"] = {
        "per_train_step": distinct(probe.steps),
        "per_sampler_unet_forward": {t: distinct([f for f in probe.forwards if f["task"] == t])
                                     for t in ("FITB", "GOR")},
        "train_steps": len(probe.steps), "sampler_unet_forwards": len(probe.forwards)}
    train_launches = report["preset"]["launches"]["per_train_step"]
    report["preset"]["kernels_in_learned_path"] = bool(
        len(train_launches) == 1 and all(train_launches[0][k] > 0 for k in (
            "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
            "group_norm_silu")))

    # ---- the reconstruction gates (image space, the tiny test's rule)
    model, step = load_model_for_inference(cfg, ckpt, device=args.device)
    with torch.inference_mode():
        cat = torch.from_numpy(scaled_latents[1:5]).to(args.device)
        cat_imgs = decode_to_uint8(model, cat).cpu().numpy().astype(np.float32)
    del model
    gates_ok = report["loss_fell"]
    for task, margin_gate, min_correct in (("FITB", args.fitb_margin_gate, OLEN),
                                           ("GOR", 0.8, args.gor_min_correct)):
        by_variant = {}
        for variant in variants:
            run_dir = os.path.join(f"{gen_dir}_{variant}", run_name(task, step, cfg))
            man = np.load(run_dir + ".npy", allow_pickle=True).item()
            by_variant[variant] = r = reconstruction(man, cat_imgs, margin_gate, min_correct)
            print(f"{task}[{variant}]: {r['n_correct']}/{r['n_checked']} slots reconstruct "
                  f"(gate {min_correct}) -> {'PASS' if r['passed'] else 'FAIL'}", flush=True)
        passed = any(v["passed"] for v in by_variant.values())
        gates_ok = gates_ok and passed
        report[task] = dict(by_variant["ema"], variants=by_variant, passed=passed)
    report["all_gates_passed"] = bool(gates_ok)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default=None,
                   help="keep the fixture, checkpoints and runs here (default: a temporary "
                        "directory, deleted at the end)")
    p.add_argument("--report", default=os.path.join(REPO, "scripts", "logs",
                                                    "learning_proof_cuda.json"))
    p.add_argument("--steps", type=int, default=None, help="default 6000 (--tiny: 300)")
    # 64 px -> 8x8 latents: the tiny test's latent grid, with the mid model
    p.add_argument("--img", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--inference_steps", type=int, default=None, help="default 50 (--tiny: 10)")
    p.add_argument("--fitb_margin_gate", type=float, default=0.65)
    p.add_argument("--gor_min_correct", type=int, default=14)
    p.add_argument("--tiny", action="store_true", help="the CPU-sized proof")
    p.add_argument("--plain_versions", action="store_true",
                   help="train and sample through the kernels' plain PyTorch versions "
                        "(nn.kernels.plain_versions): the same proof without the kernels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.steps is None:
        args.steps = 300 if args.tiny else 6000
    if args.inference_steps is None:
        args.inference_steps = 10 if args.tiny else 50
    keep = args.workdir is not None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="learning_proof_")
    os.makedirs(args.workdir, exist_ok=True)
    try:
        if args.plain_versions:
            from difashion_tpu_torch.nn.kernels import plain_versions

            with plain_versions():
                report = run(args)
        else:
            report = run(args)
    finally:
        if not keep:
            shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.report}", flush=True)
    return 0 if report["all_gates_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
