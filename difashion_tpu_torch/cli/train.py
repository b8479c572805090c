"""Training CLI: the DiFashion fine-tuning loop. Counterpart of
`difashion_tpu/cli/train.py`, with its flags plus `--device`.

    python -m difashion_tpu_torch train --data_path <dir> --output_dir <ckpt> \
        [--config cfg.json | --tiny] [--pretrained_dir <sd2-base>] \
        [--max_train_steps N] [--resume_from_checkpoint latest|N] [--device cuda|cpu]

Each step is `engine/train.py::build_train_step`'s step (the VAE sample from
the catalog's moments, or the encode of raw images with `--from_images`; the
UNet forward and backward through the flash-attention, GroupNorm and
skinny-N kernels on the card; clipping, AdamW and EMA). The host loop only
gathers the batch of `TrainLoader.batch_at(step)` and syncs with the device
every `console_every` steps and at the last, to log. A checkpoint is saved
every `checkpointing_steps` and at `max_train_steps`, keeping the newest
`checkpoints_total_limit`; the frozen towers are saved once. A resume reads
the port's checkpoints or the JAX package's (`checkpoint.py`); the next ones
are the port's, in the same directory. Metrics go to
`<output_dir>/metrics.jsonl` and the trackers of `--report_to`. With
`--trace` the port's spans are on (`core/tracing.py`), and each metrics row
adds the mean host ms, since the last row, of assembling a batch
(`batch_host_ms`), of the step's host sync (`sync_host_ms`), of the
gradients' all-reduce (`allreduce_host_ms`: the host's part, which NCCL
queues on the card; about 0 in one process) and of the blocking part of a
checkpoint save (`checkpoint_host_ms`, in the row after the save).

Data parallelism runs one process per device under torchrun:

    torchrun --nproc_per_node N -m difashion_tpu_torch train --dp_size N ...

(`--dp_size -1`, the default, takes the group's size). The group is NCCL on
the cards, gloo with `--device cpu`; each rank trains on its contiguous
shard of every global batch of `train_batch_size` outfits
(`core/distributed.py::host_shard`) through the data-parallel step
(`engine/train.py`), and rank 0 alone writes (the frozen towers,
checkpoints, metrics, validation samples) while the others wait at a
barrier. Runs on the card unless `--device cpu`. PIL is needed for
`--from_images`, for the first-run precompute of the catalog moments and
for `--validation_steps` (JPEGs); each raises when PIL is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.cli.common import load_config, setup_logging
from difashion_tpu_torch.config import Config
from difashion_tpu_torch.core import distributed, tracing
from difashion_tpu_torch.core.distributed import DistInfo
from difashion_tpu_torch.core.logging import MetricLogger, StepTimer
from difashion_tpu_torch.data.datasets import FashionData, HistLatentStore, TrainLoader
from difashion_tpu_torch.data.precompute import load_processed
from difashion_tpu_torch.data.prompts import build_train_prompts
from difashion_tpu_torch.data.tokenizer import load_tokenizer
from difashion_tpu_torch.engine.train import TrainBatch, TrainState, autocast, build_train_step
from difashion_tpu_torch.models.difashion import FROZEN, TRAINABLE, create_difashion


def require_pil(what: str) -> None:
    """Raise SystemExit naming `what` when PIL is not installed."""
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"{what} needs PIL (pillow), which this Python does not have: "
                         "install it, or precompute the catalog moments elsewhere "
                         "(extract-features --stage vae) and train from them") from e


def resolve_dp_size(dp_size: int, world: int, train_batch_size: int, log) -> int:
    """The number of ranks to train on: the process group's size, which
    `dp_size` (when above 0) must equal, and which must divide the global
    batch (the JAX command picks the largest divisor instead)."""
    if dp_size > 0 and dp_size != world:
        raise SystemExit(
            f"dp_size {dp_size} needs a process group of {dp_size} ranks, one per device "
            f"(this run has {world}): launch `torchrun --nproc_per_node {dp_size} -m "
            f"difashion_tpu_torch train --dp_size {dp_size} ...`")
    if train_batch_size % world:
        raise SystemExit(f"train_batch_size {train_batch_size} outfits do not split over "
                         f"{world} ranks: use a multiple of {world}")
    if dp_size <= 0:
        log.info("dp_size %d: training on the group's %d device(s)", dp_size, world)
    return world


@tracing.traced("train.batch")
def assemble_batch(batch: dict, moments_mean: Optional[np.ndarray],
                   moments_logvar: Optional[np.ndarray], input_ids_table: np.ndarray,
                   cid_row: dict, hist_store: HistLatentStore, scaling_factor: float,
                   image_loader=None, np_rng: Optional[np.random.RandomState] = None,
                   device="cuda") -> TrainBatch:
    """The dense batch of a `TrainLoader` batch, on `device`: the items'
    moments gathered by id (or their images, `image_loader(iid, np_rng)` ->
    [H, W, 3] in [-1, 1], with `--from_images`), the per-category token ids
    and the history latents. `scaling_factor` is unused (the step scales),
    kept for the JAX package's signature.

    To a card the arrays go through pinned memory without blocking: a copy
    from pageable memory would wait for the stream, a second host sync per
    step beside the step's own, so that the device would idle while the
    host queues the next step."""
    outfits = np.asarray(batch["outfits"])
    category = np.asarray(batch["category"])
    uids = np.asarray(batch["uids"])
    B, olen = outfits.shape
    flat = outfits.reshape(-1)
    pin = torch.device(device).type == "cuda"

    def on_dev(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.pin_memory() if pin else t).to(device, non_blocking=pin)

    if image_loader is not None:
        imgs = np.stack([image_loader(int(i), np_rng) for i in flat])
        images = on_dev(imgs.reshape((B, olen) + imgs.shape[1:]))
        mean = logvar = None
    else:
        images = None
        mean = on_dev(moments_mean[flat].reshape((B, olen) + moments_mean.shape[1:]))
        logvar = on_dev(moments_logvar[flat].reshape(tuple(mean.shape)))
    rows = np.vectorize(cid_row.get)(category)
    ids = input_ids_table[rows.reshape(-1)].reshape(B, olen, -1)
    return TrainBatch(images=images, latent_mean=mean, latent_logvar=logvar,
                      input_ids=on_dev(ids.astype(np.int32)),
                      hist_latents=on_dev(hist_store.gather(uids, category)))


@contextlib.contextmanager
def ema_weights(model, state: TrainState):
    """The EMA weights in the model's trainable parameters, in eval mode, for
    the duration; the training weights and modes back after. The two are
    swapped in place, one tensor at a time (no second copy of the model)."""

    def swap():
        with torch.no_grad():
            for p, e in zip(state.params, state.ema.params):
                tmp = p.detach().clone()
                p.copy_(e)
                e.copy_(tmp)

    if state.ema is not None:
        swap()
    model.eval()
    try:
        yield
    finally:
        if state.ema is not None:
            swap()
        model.prepare_for_training()


def run_training(cfg: Config, data: FashionData, moments_mean: Optional[np.ndarray],
                 moments_logvar: Optional[np.ndarray], hist_store: HistLatentStore,
                 tokenizer, pretrained_dir: Optional[str] = None,
                 max_steps: Optional[int] = None, log_dir: Optional[str] = None,
                 image_loader=None, report_to: tuple = ("tensorboard",),
                 validation_every: int = 0, validation_batches: int = 1, device="cuda",
                 dp: Optional[DistInfo] = None, console_every: int = 50):
    """The training loop as a library function (the CLI and the tests share
    it). Returns (state, model): the final TrainState and the model whose
    parameters it holds. `dp`: this rank of a data-parallel group
    (`initialize_distributed`), whose device it trains on. `console_every`:
    the steps between the host's syncs with the device, each a metrics row
    (and a console line at its multiples of `MetricLogger`'s)."""
    log = setup_logging()
    tcfg = cfg.train
    max_steps = max_steps or tcfg.max_train_steps
    dp = dp or distributed.single(device)
    device = dp.device
    writer = dp.rank == 0
    n_devices = resolve_dp_size(tcfg.dp_size, dp.world, tcfg.train_batch_size, log)
    if validation_every > 0 and data.fitb_valid is not None:
        require_pil("--validation_steps (the validation samples are JPEGs)")

    # fp32 master weights; the step runs under bf16 autocast with the bf16 recipe
    model = create_difashion(cfg.model, seed=tcfg.seed, device=device)
    if pretrained_dir:
        from difashion_tpu_torch.core.importer import import_sd_checkpoint

        import_sd_checkpoint(pretrained_dir, model)
        log.info("imported pretrained SD weights from %s", pretrained_dir)
    step_fn, init_state = build_train_step(model, tcfg, dp=dp)
    state = init_state()
    log.info("training on %s (rank %d of %d)", device, dp.rank, n_devices)

    store = CheckpointStore(tcfg.output_dir, tcfg.checkpoints_total_limit)
    if writer and not store.has_frozen():
        store.save_frozen({t: getattr(model, t).state_dict() for t in FROZEN})
    start_step = 0
    if tcfg.resume_from_checkpoint:
        want = (None if tcfg.resume_from_checkpoint == "latest"
                else int(tcfg.resume_from_checkpoint))
        if want is not None and want not in store.all_steps():
            # an explicit step that does not exist fails loudly: starting fresh
            # would overwrite the directory's history
            raise SystemExit(
                f"--resume_from_checkpoint {want}: checkpoint-{want} not found under "
                f"{tcfg.output_dir} (have: {store.all_steps() or 'none'})")
        if store.latest_step() is not None:
            # copied into the fresh state's tensors in place: no second copy of
            # the parameters stays alive
            state = store.load(state, want, mutual_dims=(
                cfg.model.mutual.latent_channels, cfg.model.mutual.latent_size))
            start_step = state.step
            log.info("resumed from checkpoint at step %d", start_step)
    distributed.check_same_parameters(model, TRAINABLE + FROZEN, dp.world)

    # per-category token-id table (the prompts depend on the category only)
    cids = (sorted(data.id_cate_dict.keys()) if data.id_cate_dict
            else sorted({int(c) for c in data.train.category.reshape(-1)}))
    id_cate = data.id_cate_dict or {c: f"category {c}" for c in cids}
    ids_table = tokenizer(build_train_prompts(cids, id_cate))
    cid_row = {c: i for i, c in enumerate(cids)}

    null_latent = torch.from_numpy(np.asarray(hist_store.null, np.float32)).to(device)
    with torch.no_grad(), autocast(model, tcfg):
        null_text = model.encode_text(
            torch.from_numpy(np.asarray(tokenizer([""]))).long().to(device))[0].float()

    loader = TrainLoader(data.train, tcfg.train_batch_size, seed=tcfg.seed, shuffle=True)
    metrics_log = None
    if writer:
        metrics_log = MetricLogger(
            log_dir or tcfg.output_dir, console_every=console_every, report_to=report_to,
            run_config={"learning_rate": tcfg.learning_rate,
                        "train_batch_size": tcfg.train_batch_size,
                        "max_train_steps": max_steps, "eta": tcfg.eta,
                        "snr_gamma": tcfg.snr_gamma})
    timer = StepTimer(n_chips=n_devices)
    sf = cfg.model.vae.scaling_factor

    # validation sampling: every N steps, the EMA weights swapped in, a few
    # valid-split FITB outfits sampled into <output_dir>/samples/ through one
    # GenerationPipeline built at the first pass
    val_pipe = None
    if validation_every > 0 and data.fitb_valid is not None:
        from difashion_tpu_torch.engine.pipeline import GenerationPipeline, merge_images_grid

        all_latents = moments_mean * sf if moments_mean is not None else None
        if all_latents is None:
            log.warning("validation sampling without catalog latents: known slots and "
                        "history fall back to the null latent")
            val_hist = HistLatentStore({}, np.zeros(hist_store.null.shape, np.float32))
        else:
            val_hist = HistLatentStore.from_catalog(data.history.get("valid", {}),
                                                    all_latents)
        samples_dir = os.path.join(log_dir or tcfg.output_dir, "samples")

        def run_validation(cur_state, at_step):
            nonlocal val_pipe
            with ema_weights(model, cur_state), torch.inference_mode():
                if val_pipe is None:
                    val_pipe = GenerationPipeline(model, cfg, id_cate, tokenizer, val_hist,
                                                  item_latents=all_latents)
                out = val_pipe.run(data.fitb_valid, "FITB", samples_dir, f"step-{at_step}",
                                   grd_dict=data.valid_grd, seed=tcfg.seed,
                                   max_batches=validation_batches)
            log.info("validation samples at step %d -> %s", at_step, out)
            try:   # one grid of this pass's samples to the trackers
                from PIL import Image

                man = np.load(out + ".npy", allow_pickle=True).item()
                paths = [p for per_uid in man.values() for rec in per_uid.values()
                         for p in rec["image_paths"]][:16]
                if paths:
                    imgs = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
                    metrics_log.log_image(at_step, "validation/fitb_samples",
                                          merge_images_grid(imgs))
            except Exception as e:   # observability must never stop training
                log.warning("validation image logging failed: %s", e)
    elif validation_every > 0:
        log.warning("--validation_steps set but no fitb_valid split found; validation "
                    "sampling disabled")
        validation_every = 0

    # the same generator on every rank: each draws the global batch's
    # randomness and keeps its rows
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    step = synced = start_step
    sync_every = max(1, metrics_log.console_every) if writer else 1
    imgs_per_step = tcfg.train_batch_size * data.train.outfits.shape[1]   # global batch
    crop_rng = np.random.RandomState(tcfg.seed + 1 + dp.rank)
    timer.start()
    try:
        while step < max_steps:
            shard = distributed.host_shard(loader.batch_at(step), dp.rank, dp.world)
            batch = assemble_batch(shard, moments_mean, moments_logvar,
                                   ids_table, cid_row, hist_store, sf,
                                   image_loader=image_loader, np_rng=crop_rng, device=device)
            state, m = step_fn(state, batch, null_latent, null_text, generator)
            step += 1
            # sync with the device only to log: the step's own sync (the
            # non-finite check) is the only other one
            if writer and (step % sync_every == 0 or step >= max_steps):
                loss = float(m["loss"])
                t = timer.stop(imgs_per_step * (step - synced))
                synced = step
                if tracing.enabled():
                    t.update(host_means(tracing.take()))
                metrics_log.log(step, loss=loss, grad_norm=float(m["grad_norm"]),
                                update_skipped=float(m["update_skipped"]), **t)
                timer.start()
            elif not writer and tracing.enabled():
                tracing.reset()   # no rows on this rank
            if step % tcfg.checkpointing_steps == 0 or step >= max_steps:
                if writer:
                    with tracing.span("train.checkpoint"):
                        store.save_async(state, step)
                    log.info("saved checkpoint-%d (async)", step)
                distributed.barrier()
            if validation_every > 0 and step % validation_every == 0:
                if writer:
                    run_validation(state, step)
                distributed.barrier()
                timer.start()   # the validation's wall time is not a step's
    finally:
        # a checkpoint announced is written (or its failure raised) and the
        # metrics flushed, whatever stopped the loop
        store.wait()
        if metrics_log is not None:
            metrics_log.close()
    distributed.barrier()
    return state, model


HOST_MEANS = (("train.batch", "batch_host_ms"), ("train.sync", "sync_host_ms"),
              ("train.allreduce", "allreduce_host_ms"),
              ("train.checkpoint", "checkpoint_host_ms"))


def host_means(records) -> dict:
    """The mean host ms of the loop's spans among `records` (`HOST_MEANS`:
    assembling a batch, the step's sync, queueing the gradients' all-reduce,
    a checkpoint's blocking part), those with any."""
    out = {}
    for name, key in HOST_MEANS:
        ms = tracing.host_ms(records, name)
        if ms:
            out[key] = sum(ms) / len(ms)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiFashion training (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--output_dir", default="ckpt")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--pretrained_dir", default=None,
                   help="local diffusers SD2-base dir (unet/ vae/ text_encoder/)")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--train_batch_size", type=int, default=None)
    p.add_argument("--eta", type=float, default=None)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--resume_from_checkpoint", default=None, help="latest, or a step")
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke test)")
    p.add_argument("--img_folder_path", default=None,
                   help="catalog image root (first-run precompute and --from_images)")
    p.add_argument("--image_paths_npy", default=None, help="iid -> relative image path array")
    p.add_argument("--from_images", action="store_true",
                   help="train from raw images (bilinear resize, random crop, the VAE "
                        "inside the step) instead of the precomputed moments")
    p.add_argument("--validation_steps", type=int, default=0,
                   help="sample a few valid-split FITB outfits with the EMA weights every "
                        "N steps into <output_dir>/samples/ (0 = off)")
    p.add_argument("--validation_batches", type=int, default=1,
                   help="valid batches per validation pass")
    p.add_argument("--report_to", default="tensorboard",
                   help="comma-separated trackers: tensorboard,wandb,comet_ml (a missing "
                        "package is skipped with a warning; metrics.jsonl always written)")
    p.add_argument("--console_every", type=int, default=50,
                   help="steps between metrics rows (each a sync with the device)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", action="store_true",
                   help="turn the port's spans on and add the mean host ms of the batch, "
                        "the step's sync, the gradients' all-reduce and the checkpoint's "
                        "blocking part to each metrics row")
    return p.parse_args(argv)


def main(argv=None):
    """Returns run_training's (state, model). Under torchrun (WORLD_SIZE > 1)
    this process joins the group first: NCCL on the cards, gloo with
    `--device cpu`."""
    args = parse_args(argv)
    if args.trace:
        tracing.enable()
    if distributed.world_size() == 1:
        return _main(args, None)
    backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
    dp = distributed.initialize_distributed(backend, args.device)
    try:
        return _main(args, dp)
    finally:
        distributed.destroy()


def _main(args, dp: Optional[DistInfo]):
    device = dp.device if dp is not None else args.device
    cfg = load_config(args.config, args.tiny)
    overrides = {k: getattr(args, k) for k in ("max_train_steps", "learning_rate",
                                               "train_batch_size", "eta", "snr_gamma",
                                               "resume_from_checkpoint")
                 if getattr(args, k) is not None}
    overrides["output_dir"] = args.output_dir
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))

    log = setup_logging()
    data = FashionData.load(args.data_path)
    image_paths = (np.load(args.image_paths_npy, allow_pickle=True)
                   if args.image_paths_npy else None)

    proc = load_processed(args.data_path, "all_item_moments")
    if proc is None:
        # first run: precompute the catalog's moments (rank 0; the others wait)
        if image_paths is None or args.img_folder_path is None:
            raise SystemExit(
                "catalog moments not found; either pass --img_folder_path + "
                "--image_paths_npy so training can precompute them on first run, or run "
                "`python -m difashion_tpu_torch extract-features --stage vae`")
        require_pil("the first-run precompute of the catalog moments")
        if dp is None or dp.rank == 0:
            from difashion_tpu_torch.cli.extract_features import make_item_loader
            from difashion_tpu_torch.data.precompute import encode_catalog, save_processed

            log.info("catalog moments cache missing: VAE-encoding %d items first",
                     len(image_paths))
            model = create_difashion(cfg.model, seed=0, device=device)
            if args.pretrained_dir:
                from difashion_tpu_torch.core.importer import import_sd_checkpoint

                import_sd_checkpoint(args.pretrained_dir, model)
            item_loader = make_item_loader(args.img_folder_path, image_paths,
                                           cfg.model.vae.sample_size)
            proc = encode_catalog(model, item_loader, len(image_paths), device=device)
            del model
            save_processed(args.data_path, "all_item_moments", **proc)
            log.info("saved processed/all_item_moments.npz")
        distributed.barrier()
        if proc is None:
            proc = load_processed(args.data_path, "all_item_moments")

    moments_mean, moments_logvar = proc["mean"], proc["logvar"]
    hist_store = HistLatentStore.from_catalog(data.history.get("train", {}),
                                              moments_mean * cfg.model.vae.scaling_factor)
    tokenizer = load_tokenizer(args.tokenizer_dir, cfg.model.text.vocab_size)

    image_loader = None
    if args.from_images:
        if image_paths is None or args.img_folder_path is None:
            raise SystemExit("--from_images needs --img_folder_path and --image_paths_npy")
        require_pil("--from_images")
        from PIL import Image

        from difashion_tpu_torch.data.preprocessing import to_model_input

        size = cfg.model.vae.sample_size

        def image_loader(iid: int, np_rng):
            img = Image.open(os.path.join(args.img_folder_path,
                                          str(image_paths[iid]))).convert("RGB")
            return to_model_input(img, size=size, crop="random", rng=np_rng)

    report_to = tuple(t.strip() for t in args.report_to.split(",") if t.strip())
    return run_training(cfg, data, moments_mean, moments_logvar, hist_store, tokenizer,
                        pretrained_dir=args.pretrained_dir, image_loader=image_loader,
                        report_to=report_to, validation_every=args.validation_steps,
                        validation_batches=args.validation_batches, device=device, dp=dp,
                        console_every=args.console_every)


if __name__ == "__main__":
    main()
