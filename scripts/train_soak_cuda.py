#!/usr/bin/env python3
"""Training soak of the PyTorch/CUDA port: the full recipe over the training
table's schema and scale, with a SIGKILL that lands while the trainer steps.
The port's counterpart of `tools/train_soak.py`, with its recipe, legs and
gates, and two gates more.

Recipe: `Config.preset_eta01()` (sd2_base, on the card; `--tiny`: the tiny
preset, on the CPU) with 8-bit AdamW, gradient checkpointing, 2 outfits a batch, bf16
autocast and EMA, `max_train_steps = --steps`, a checkpoint at the half.

Data, synthesized from `--seed` (the reference's Polyvore tables are not in
this repository): 26,921 training rows of 4 items in 4 of 50 categories
over 517 users, item ids below `--n_items` (119,000: the reference
catalog's), item i in category 1 + i % 50, 10 history items per (user,
category) of the user's rows; the catalog's VAE moments as the JAX tool
makes them (std 4.4, log-variance -6, item 0 zero; 119,000 x 64 x 64 x 4
fp32 twice, 14.5 GiB). `--n_items` cuts the catalog; the report states it.

Legs, each the port's train command (`python -m difashion_tpu_torch
train`, run through `__main__.main` in a child process that counts each
step's kernel launches and the device's peak memory):
  1. train to steps / 2 (checkpoint-<steps/2>);
  2. resume `latest`; watch `metrics.jsonl` (a row every `--console_every`
     steps) every 0.1 s, and SIGKILL the child `--kill_after_steps` steps
     after its first row past the half. If the child ends, or no row comes
     within SETUP_GRACE_S seconds, the run fails: the drill never degrades
     to a kill at start-up;
  3. plant a stale `checkpoint-<steps>.tmp/` (what a kill in a checkpoint
     write leaves), resume `latest` again and run to `steps`.

Gates: every loss finite, no update skipped, `checkpoint-<steps>` present
(the JAX tool's); the kill landed while stepping; continuity: legs 2 and 3
start from the same checkpoint with the same draws (the command seeds its
generator at every start), so every step both logged carries the same loss
and grad_norm: the largest differences are reported, and the gate holds
them to CONTINUITY_TOL (0: bit for bit); leg 3 resumed from the half
(not the planted directory), whose files did not reach `checkpoint-<steps>`.
Then the final checkpoint is exported with its EMA weights and the frozen
towers (`core/importer.py::export_checkpoint`, the files of
`scripts/export_hf_torch.py --ema --include_frozen`), read back through
`import_sd_checkpoint`, and one GOR outfit generated at a fixed seed from
the re-imported model must be bit-equal to the one from the checkpoint.

    python3 scripts/train_soak_cuda.py [--steps 500] [--n_items 119000]
        [--workdir DIR] [--report PATH] [--tiny]

The report (the JAX artifact's fields and the new gates', seconds per step
of each leg, the device peak, the launches of a step, the export's bytes
and seconds) goes to `scripts/logs/train_soak_cuda.json` unless
`--report`; the work directory is a temporary one, deleted at the end,
unless `--workdir`. Exits 1 when a gate fails.
"""
import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

N_ROWS = 26_921       # Polyvore's training outfits (SURVEY.md, data schemas)
N_USERS = 517
N_CATES = 50
OLEN = 4
HIST_LEN = 10
N_ITEMS = 119_000     # the reference catalog's item ids (tools/train_soak.py)
POLL_S = 0.1
# seconds leg 2 may take to log its first step past the half: its start-up
# reads the 14.5 GiB of moments and builds the model
SETUP_GRACE_S = 3600.0
# the largest loss / grad_norm difference allowed between the steps legs 2
# and 3 both log: none, as the step is deterministic on the CPU and on the
# H100 (the 500-step run, scripts/logs/train_soak_cuda.json)
CONTINUITY_TOL = 0.0


def recipe(tiny: bool, ckpt: str, steps: int):
    """The JAX tool's recipe on the preset."""
    from difashion_tpu_torch.config import Config

    cfg = Config.preset_tiny() if tiny else Config.preset_eta01()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, output_dir=ckpt, use_8bit_adam=True, gradient_checkpointing=True,
        checkpointing_steps=steps // 2, train_batch_size=2, max_train_steps=steps,
        mixed_precision="bf16", use_ema=True, use_ema_fashion=True))


def synth_data(dpath: str, cfg, n_items: int, seed: int) -> dict:
    """The module docstring's tables and moments under `dpath`. Returns the
    scale written."""
    from difashion_tpu_torch.data.precompute import save_processed

    os.makedirs(dpath, exist_ok=True)
    rng = np.random.RandomState(seed)
    pools = {c: np.arange(c % N_CATES or N_CATES, n_items, N_CATES) for c in range(1, N_CATES + 1)}
    pools = {c: p[p > 0] for c, p in pools.items()}
    uids = np.concatenate([np.arange(1, N_USERS + 1),
                           rng.randint(1, N_USERS + 1, N_ROWS - N_USERS)])
    rng.shuffle(uids)
    cates = np.stack([rng.choice(N_CATES, OLEN, replace=False) + 1 for _ in range(N_ROWS)])
    outfits = np.array([[pools[c][rng.randint(len(pools[c]))] for c in row] for row in cates])
    history = {}
    for u, row in zip(uids, cates):
        per = history.setdefault(int(u), {})
        for c in row:
            if int(c) not in per:
                per[int(c)] = [int(x) for x in rng.choice(pools[c], HIST_LEN)]
    save = lambda name, obj: np.save(os.path.join(dpath, name), np.array(obj, dtype=object))
    save("train.npy", {"uids": uids.tolist(), "oids": list(range(1, N_ROWS + 1)),
                       "outfits": outfits.tolist(), "category": cates.tolist()})
    save("train_history.npy", history)
    save("id_cate_dict.npy", {c: f"category {c}" for c in range(1, N_CATES + 1)})
    s, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    mrng = np.random.default_rng(seed)
    mean = mrng.standard_normal((n_items, s, s, C), np.float32)
    mean *= 4.4
    mean[0] = 0.0     # the null (white) item
    save_processed(dpath, "all_item_moments", mean=mean,
                   logvar=np.full((n_items, s, s, C), -6.0, np.float32))
    return {"rows": N_ROWS, "users": N_USERS, "categories": N_CATES, "n_items": n_items,
            "max_item_id": int(outfits.max()), "history_entries": sum(map(len, history.values())),
            "moments_bytes": 2 * mean.nbytes}


def read_rows(path: str, skip: int = 0):
    """The metrics rows of `metrics.jsonl` after its first `skip` lines (a
    line counts once its newline is written)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().split("\n")[:-1]
    return [json.loads(line) for line in lines[skip:] if line.strip()]


def line_count(path: str) -> int:
    return len(read_rows(path))


def leg_main(argv) -> None:
    """A leg's child: `--leg OUT -- <train argv>`. Runs the train command
    through the dispatcher with each step's launches counted
    (`learning_proof_cuda.LaunchProbe`) and writes them, the steps and the
    device's peak memory to OUT when the command returns."""
    out, train_argv = argv[0], argv[2:]
    import torch

    from difashion_tpu_torch.__main__ import main as dispatch
    from learning_proof_cuda import LaunchProbe, distinct

    probe = LaunchProbe()
    try:
        rc = dispatch(["train", *train_argv])
    finally:
        probe.restore()
    with open(out, "w") as f:
        json.dump({"rc": rc, "steps": [r["at_step"] for r in probe.steps],
                   "launches_per_step": distinct(probe.steps),
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if torch.cuda.is_initialized() else None)}, f)
    sys.exit(rc)


def run_leg(cmd, extra, report_path):
    t0 = time.perf_counter()
    r = subprocess.run(cmd(report_path) + extra, cwd=REPO)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"leg failed with exit code {r.returncode}: {cmd(report_path) + extra}")
    with open(report_path) as f:
        return wall, json.load(f)


def kill_while_stepping(cmd, extra, metrics, skip, half, after, grace):
    """Leg 2: start the child, watch the rows past `skip`, SIGKILL it
    `after` steps after its first row past `half`. Returns (wall, killed at
    the row of step, first row past the half). Raises if the child ends or
    the grace expires first."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd(os.devnull) + extra, cwd=REPO)
    first = None
    try:
        while True:
            if proc.poll() is not None:
                raise SystemExit(f"leg 2 ended (exit code {proc.returncode}) before the kill: "
                                 "the drill did not land while stepping")
            if time.perf_counter() - t0 > grace:
                raise SystemExit(f"leg 2 logged no step past {half} within {grace} s")
            past = [r["step"] for r in read_rows(metrics, skip) if r["step"] > half]
            if past and first is None:
                first = past[0]
            if past and past[-1] >= first + after:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                return time.perf_counter() - t0, past[-1], first
            time.sleep(POLL_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def gor_images(model, seed: int, steps: int, device: str):
    """One GOR outfit (4 slots) at `seed`: its text encoded from seeded ids,
    `steps`-step sampling with the recipe's guidance, the decode to uint8.
    Returns (images, latents) on the host."""
    import torch

    from difashion_tpu_torch.engine.generate import (
        GenerationInputs,
        build_sampler,
        decode_to_uint8,
        make_guidance_spec,
    )

    cfg, g = model.config, torch.Generator().manual_seed(seed)
    s, C, F = cfg.unet.sample_size, cfg.vae.latent_channels, OLEN
    rand = lambda *shape: torch.randn(*shape, generator=g).to(device)
    ids = torch.randint(0, cfg.text.vocab_size, (F, 77), generator=g).to(device)
    with torch.inference_mode():
        cate_text = model.encode_text(ids)
        null_text = model.encode_text(torch.zeros_like(ids[:1]))[0]
        inputs = GenerationInputs(
            init_latents=rand(F, s, s, C), outfit_idx=torch.zeros(F, dtype=torch.long,
                                                                  device=device),
            known_latents=rand(1, F, s, s, C) * 0.2,
            gen_mask=torch.ones(1, F, dtype=torch.bool, device=device),
            gen_index=torch.arange(F, device=device).view(1, F),
            hist_latents=rand(F, s, s, C) * 0.2, cate_text=cate_text, null_text=null_text,
            null_latent=rand(s, s, C) * 0.05)
        latents = build_sampler(model, num_inference_steps=steps,
                                spec=make_guidance_spec(12.0, 4.0, 5.0), eta=0.1)(inputs)
        images = decode_to_uint8(model, latents)
    return images.cpu().numpy(), latents.float().cpu().numpy()


def export_and_reload(cfg, ckpt: str, out: str, device: str, gen_steps: int) -> dict:
    """Export the final checkpoint (EMA, frozen towers), re-import it, and
    generate one GOR outfit from each: bit-equal images required."""
    import torch

    from difashion_tpu_torch.cli.generate import load_model_for_inference
    from difashion_tpu_torch.core.importer import (
        export_checkpoint,
        import_sd_checkpoint,
        read_safetensors,
    )
    from difashion_tpu_torch.models.difashion import create_difashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.weights import load_tower

    t0 = time.perf_counter()
    exported = export_checkpoint(cfg, ckpt, out, ema=True, include_frozen=True, device=device)
    export_s = time.perf_counter() - t0
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    model, step = load_model_for_inference(cfg, ckpt, use_ema=True, device=device)
    kernels.reset_launches()
    want, want_lat = gor_images(model, seed=7, steps=gen_steps, device=device)
    launches = dict(kernels.LAUNCHES)
    dtype = next(model.parameters()).dtype
    del model
    t0 = time.perf_counter()
    again = create_difashion(cfg.model, seed=cfg.train.seed + 1, device=device, dtype=dtype)
    import_sd_checkpoint(out, again)
    load_tower(again.fashion_encoder, read_safetensors(os.path.join(
        out, "fashion_encoder", "diffusion_pytorch_model.safetensors")), "fashion_encoder")
    reload_s = time.perf_counter() - t0
    got, got_lat = gor_images(again.eval(), seed=7, steps=gen_steps, device=device)
    del again
    return {"step": exported["step"], "files": {os.path.relpath(p, out): v for p, v in
                                                exported["files"].items()},
            "bytes": sum(v["bytes"] for v in exported["files"].values()),
            "export_s": export_s, "reload_s": reload_s, "gen_steps": gen_steps,
            "generation_launches": launches, "images_bit_equal": bool(np.array_equal(got, want)),
            "latents_max_abs_diff": float(np.abs(got_lat - want_lat).max())}


def continuity(leg2, leg3) -> dict:
    """Every step both legs logged: the largest loss and grad_norm
    differences."""
    a, b = ({r["step"]: r for r in rows if "loss" in r} for rows in (leg2, leg3))
    both = sorted(set(a) & set(b))
    diff = lambda k: max((abs(a[s][k] - b[s][k]) for s in both), default=None)
    return {"steps_compared": both, "max_abs_loss_diff": diff("loss"),
            "max_abs_grad_norm_diff": diff("grad_norm")}


def per_step_seconds(rows, every: int):
    """Each row's step time over its `every` steps (the first row of a leg
    holds the start-up)."""
    return [r["step_time_s"] / every for r in rows if "step_time_s" in r]


def run(args) -> dict:
    from learning_proof_cuda import card

    wd = args.workdir
    dpath, ckpt = os.path.join(wd, "data"), os.path.join(wd, "ckpt")
    cfg = recipe(args.tiny, ckpt, args.steps)
    half, every = args.steps // 2, args.console_every
    if half < 3 * every + args.kill_after_steps:
        raise SystemExit(f"--steps {args.steps}: the half must hold three metrics rows and the "
                         f"kill's {args.kill_after_steps} steps after the first")
    t0 = time.perf_counter()
    data = synth_data(dpath, cfg, args.n_items, args.seed)
    synth_s = time.perf_counter() - t0
    cfg_path = os.path.join(wd, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    base = ["--data_path", dpath, "--output_dir", ckpt, "--config", cfg_path,
            "--console_every", str(every)]
    if args.device != "cuda":
        base += ["--device", args.device]
    cmd = lambda out: [sys.executable, "-u", os.path.abspath(__file__), "--leg", out, "--",
                       *base]
    metrics = os.path.join(ckpt, "metrics.jsonl")
    report = {"recipe": "sd2_base bsz2 bf16 remat adam8bit ema" if not args.tiny
              else "tiny bsz2 bf16 remat adam8bit ema", "steps": args.steps,
              "console_every": every, "data": data, "n_items": args.n_items,
              "reduced": ({"n_items": f"{args.n_items} of {N_ITEMS}"}
                          if args.n_items < N_ITEMS else {}),
              "synth_s": synth_s, **card(args.device)}

    # leg 1: to the half
    wall, leg1 = run_leg(cmd, ["--max_train_steps", str(half)], os.path.join(wd, "leg1.json"))
    rows1 = read_rows(metrics)
    report["leg1_wall_s"] = wall
    if not os.path.isdir(os.path.join(ckpt, f"checkpoint-{half}")):
        raise SystemExit(f"leg 1 left no checkpoint-{half}")

    # leg 2: resume, SIGKILL while stepping
    skip = line_count(metrics)
    wall, killed_at, first = kill_while_stepping(
        cmd, ["--resume_from_checkpoint", "latest"], metrics, skip, half,
        args.kill_after_steps, SETUP_GRACE_S)
    rows2 = read_rows(metrics, skip)
    report.update(leg2_killed_while_stepping=True, leg2_wall_s=wall,
                  leg2_first_row_step=first, leg2_kill_seen_at_step=killed_at,
                  leg2_last_logged_step=rows2[-1]["step"])

    # leg 3: a stale .tmp planted, resume latest, run to the end
    stale = os.path.join(ckpt, f"checkpoint-{args.steps}.tmp")
    os.makedirs(stale, exist_ok=True)
    with open(os.path.join(stale, "meta.json"), "w") as f:
        json.dump({"step": args.steps}, f)
    with open(os.path.join(stale, "planted.txt"), "w") as f:
        f.write("left by a killed writer\n")
    skip = line_count(metrics)
    wall, leg3 = run_leg(cmd, ["--resume_from_checkpoint", "latest"],
                         os.path.join(wd, "leg3.json"))
    rows3 = read_rows(metrics, skip)
    final = os.path.join(ckpt, f"checkpoint-{args.steps}")
    report.update(leg3_wall_s=wall, leg3_first_step=leg3["steps"][0] if leg3["steps"] else None,
                  stale_tmp_ignored=bool(
                      leg3["steps"] and leg3["steps"][0] == half and not os.path.exists(stale)
                      and os.path.isdir(final)
                      and not os.path.exists(os.path.join(final, "planted.txt"))))

    # gates over every row of the three legs (leg 2's rows kept beside leg 3's)
    rows = read_rows(metrics)
    losses = [(r["step"], r["loss"]) for r in rows if "loss" in r]
    skips = sum(r.get("update_skipped", 0.0) for r in rows)
    finite = bool(all(np.isfinite([v for _, v in losses]))
                  and all(np.isfinite(r["grad_norm"]) for r in rows if "grad_norm" in r))
    cont = continuity(rows2, rows3)
    steps_seen = [s for s, _ in losses]
    ips = sorted(r["images_per_sec_per_chip"] for r in rows
                 if r.get("images_per_sec_per_chip"))
    report.update({
        "n_metric_rows": len(rows), "rows_per_leg": [len(rows1), len(rows2), len(rows3)],
        "steps_logged": [min(steps_seen), max(steps_seen)],
        "loss_first": losses[0][1], "loss_last": losses[-1][1], "losses": losses,
        "update_skipped_total": skips, "all_losses_finite": finite,
        "images_per_sec_per_chip_median": ips[len(ips) // 2] if ips else None,
        "continuity": cont, "continuity_tol": CONTINUITY_TOL,
        "seconds_per_step": {
            leg: {"median": float(np.median(v[1:] or v)), "first_row": v[0]}
            for leg, v in (("leg1", per_step_seconds(rows1, every)),
                           ("leg2", per_step_seconds(rows2, every)),
                           ("leg3", per_step_seconds(rows3, every))) if v},
        "device_peak_bytes": {"leg1": leg1["peak_bytes"], "leg3": leg3["peak_bytes"]},
        "launches_per_step": leg1["launches_per_step"] + [
            x for x in leg3["launches_per_step"] if x not in leg1["launches_per_step"]],
        "leg_steps": [len(leg1["steps"]), None, len(leg3["steps"])],
    })
    cont_ok = (bool(cont["steps_compared"])
               and cont["max_abs_loss_diff"] <= CONTINUITY_TOL
               and cont["max_abs_grad_norm_diff"] <= CONTINUITY_TOL)

    # the final checkpoint out to safetensors and back
    report["export"] = export_and_reload(cfg, ckpt, os.path.join(wd, "export"), args.device,
                                         args.gen_steps)
    report["passed"] = bool(
        finite and skips == 0 and max(steps_seen) >= args.steps and os.path.isdir(final)
        and report["leg2_killed_while_stepping"] and cont_ok and report["stale_tmp_ignored"]
        and report["export"]["images_bit_equal"] and len(report["launches_per_step"]) == 1)
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--leg"]:
        leg_main(argv[1:])
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default=None,
                   help="keep the data, checkpoints and export here (default: a temporary "
                        "directory, deleted at the end)")
    p.add_argument("--report", default=os.path.join(REPO, "scripts", "logs",
                                                    "train_soak_cuda.json"))
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--n_items", type=int, default=N_ITEMS,
                   help="catalog items (the moments' rows); fewer cuts the catalog")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--console_every", type=int, default=5, help="steps between metrics rows")
    p.add_argument("--kill_after_steps", type=int, default=3,
                   help="steps after leg 2's first row past the half before the SIGKILL")
    p.add_argument("--gen_steps", type=int, default=20,
                   help="sampler steps of the export's bit-equal generation")
    p.add_argument("--tiny", action="store_true", help="the tiny preset, on the CPU")
    args = p.parse_args(argv)
    args.device = "cpu" if args.tiny else "cuda"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    keep = args.workdir is not None
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="train_soak_")
    os.makedirs(args.workdir, exist_ok=True)
    try:
        report = run(args)
    finally:
        if not keep:
            shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "losses"}), flush=True)
    print(f"wrote {args.report}", flush=True)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
