"""Runner `generate_xl`: the `generate` runner's batches of outfits on an
SDXL configuration: the program's generation pipeline with its second text
tower and the UNet's added time / text conditioning, checked against the
plain SDXL reference (`reference/sdxl.py`).

Set-up builds the program's model from the benchmark's seeded SDXL weights
(`core/weights_xl.py`) through its strict loader, then the kernels, the
history store, the pipeline (which encodes the category prompts with both
text towers once) and a warm-up of the cell's shapes. The window, the
counts and the check's picks and gap are the `generate` runner's; the check
generates the picked outfits again with the SDXL reference.

A traced run profiles one more batch after the window with the program's
own spans on (`difashion_tpu_torch/core/tracing.py`) and keeps the device
time credited to each span (`core/program_trace.py`) as `run.program`, with
the program's counters over that batch; `core/program_readers.py` reads it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from benchmark.core import traffic as traffic_mod
from benchmark.core.harness import Check, Run
from benchmark.core.weights_xl import make_weights, reference_towers
from benchmark.runners.generate import (
    State,
    _prepare,
    free,
    level_gap,
    picks,
    program_images,
    window,
)


def setup(run: Run) -> State:
    import torch

    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.data.datasets import HistLatentStore
    from difashion_tpu_torch.data.tokenizer import load_tokenizer
    from difashion_tpu_torch.engine.generate import build_sampler, decode_to_uint8
    from difashion_tpu_torch.engine.pipeline import GenerationPipeline
    from difashion_tpu_torch.models.difashion import DiFashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.weights import load_difashion

    w, mc = run.workload, run.model_cfg
    run.mark("imports")
    dtype = getattr(torch, w["dtype"])
    cfg = Config.from_dict({"model": mc, "generation": w["generation"]})
    with torch.device("meta"):
        model = DiFashion(cfg.model)
    model = model.to(dtype).to_empty(device=run.device)
    # strict: a program without the SDXL towers stops here, before any build
    load_difashion(model, make_weights(mc, run.seed, run.device, dtype))
    model.eval()
    run.mark("weights")
    if run.device.startswith("cuda"):
        kernels.build_all(w["kernels"])
    run.mark("kernels")
    s, c = mc["unet"]["sample_size"], mc["vae"]["latent_channels"]
    tr = traffic_mod.generation(w["traffic"], run.seed, (s, s, c))
    tokenizer = load_tokenizer(None, vocab_size=mc["text"]["vocab_size"], strict=False)
    pipeline = GenerationPipeline(model, cfg, tr.id_cate, tokenizer,
                                  HistLatentStore(tr.hist, tr.null_latent),
                                  null_latent=tr.null_latent)
    gen_seed = int(run.seed) % (2 ** 62)
    run.mark("traffic_and_pipeline")
    g = w["generation"]
    warm = build_sampler(model, num_inference_steps=w["warmup_steps"], spec=pipeline.spec,
                         eta=g["eta"], scheduler=g["scheduler"])
    prep = _prepare(pipeline, w, tr.batch(0), gen_seed)
    decode_to_uint8(model, warm(prep.inputs)).cpu()
    del prep
    run.mark("warmup")
    return State(model, pipeline, tr, [], gen_seed)


def profile_batch(run: Run, st: State) -> None:
    """One more batch through `generate_batch` under `torch.profiler` with
    the program's spans on: `run.program` is its attribution, with the
    program's counters over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.core.program_trace import from_profiler
    from difashion_tpu_torch.core import tracing

    batch = st.traffic.batch(run.counts["batches"])
    was_on = tracing.enabled()
    before = dict(tracing.COUNTERS)
    tracing.enable()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                      else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        st.pipeline.generate_batch(_prepare(st.pipeline, run.workload, batch, st.gen_seed))
        run.sync()
    finally:
        prof.stop()
        if not was_on:
            tracing.disable()
    counts = {k: v - before.get(k, 0) for k, v in tracing.COUNTERS.items()}
    tracing.reset()
    _, run.program = from_profiler(prof, counts)


def unet_work(model_cfg: dict, rows: int):
    """`core/work.py::unet_work` on the SDXL reference UNet, with the
    pooled text embedding and the time ids."""
    import torch

    from benchmark.core import work
    from benchmark.reference.sdxl import build_tower

    u = model_cfg["unet"]
    unet = build_tower("unet", model_cfg)
    s = u["sample_size"]
    return work._count(unet, lambda: unet(
        work.meta(rows, u["in_channels"], s, s), work.meta(rows, dtype=torch.long),
        work.meta(rows, 77, u["cross_attention_dim"]),
        work.meta(rows, model_cfg["text_2"]["projection_dim"]), work.meta(rows, 6)))


def work_counts(run: Run) -> None:
    """The window's work by shapes, as the `generate` runner counts it,
    with the SDXL UNet."""
    from benchmark.core import work

    t = run.workload["traffic"]
    fills = t["outfits_per_batch"] * t["items_per_outfit"]
    n_fwd, batches = run.counts["unet_forwards"], run.counts["batches"]
    unet = unet_work(run.model_cfg, run.counts["unet_rows"])
    mutual = work.mutual_work(run.model_cfg, fills)
    decode = work.decode_work(run.model_cfg, fills)
    run.counts["work"] = {"unet": (unet, n_fwd), "decode": (decode, batches)}
    run.counts["flops"] = n_fwd * (unet.flops + mutual.flops) + batches * decode.flops


def reference_images(run: Run, tr: traffic_mod.GenTraffic, chosen, gen_seed: int,
                     outputs, prec=None) -> np.ndarray:
    """The SDXL reference's uint8 images of the chosen outfits' fills, in
    the order of the program's."""
    import torch

    from benchmark.reference.sampling import fill_noise, hash_token_ids, train_prompt
    from benchmark.reference.sdxl import generate_outfits

    mc, w = run.model_cfg, run.workload
    olen = w["traffic"]["items_per_outfit"]
    s, c = mc["unet"]["sample_size"], mc["vae"]["latent_channels"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    towers = reference_towers(mc, run.seed, run.device, getattr(torch, w["dtype"]), prec)
    vocab = mc["text"]["vocab_size"]
    cates, hist, init, groups = [], [], [], []
    for k, b in chosen:
        batch = outputs[k][1]
        uid, oid = int(batch["uids"][b]), int(batch["oids"][b])
        groups.append(list(range(len(init), len(init) + olen)))
        for j in range(olen):
            cid = int(batch["category"][b, j])
            cates.append(train_prompt(tr.id_cate[cid]))
            hist.append(tr.hist_latent(uid, cid))
            init.append(fill_noise(gen_seed, (uid, oid, j), (s, s, c)))
    imgs = generate_outfits(towers, mc, w["generation"], hash_token_ids(cates, vocab),
                            hash_token_ids([""], vocab)[0], np.stack(hist), np.stack(init),
                            groups, tr.null_latent, run.device)
    del towers
    return imgs


def check(run: Run, st: State) -> None:
    chosen = picks(run, st)
    ref = reference_images(run, st.traffic, chosen, st.gen_seed, st.outputs)
    run.checks["image_mean_abs_levels"] = Check(
        level_gap(program_images(run, chosen, st.outputs), ref,
                  run.workload["traffic"]["items_per_outfit"]),
        run.workload["check"]["limits"]["image_mean_abs_levels"])


def run(run: Run, program_fault: Optional[Callable] = None) -> None:
    """Set-up, window, the peak, a traced run's profiled batch, the program
    freed, the check. A `program_fault(state)` (tests only) breaks the
    program after set-up."""
    import torch

    st = setup(run)
    if program_fault is not None:
        program_fault(st)
    window(run, st)
    if run.device.startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if run.trace:
        profile_batch(run, st)
    free(st)
    if run.trace:
        work_counts(run)
    run.mark("window_closed")
    check(run, st)
    run.mark("checked")
