"""Runner `generate`: batches of outfits through the program's generation
pipeline, as the `generate` command runs them for evaluation.

Set-up builds the program's model from the benchmark's seeded weights
(through its loader), the history store over the traffic's latents and the
`GenerationPipeline` (which encodes the category prompts once), and warms
the cell's shapes with a short sampler run and a decode. The window drives
`prepare_batch` and `generate_batch` (sampler, decode, uint8 on the host)
batch after batch, and closes at the end of the batch in flight when
`--seconds` have passed; images_per_s divides every image by the window's
length. A traced run calls what `generate_batch` composes (`sample`,
`decode_to_uint8`, the copy to the host) under spans of its own.

The check: outfits among those the window finished, one in each slot of a
batch, each from a batch drawn from the seed, are generated again by the
plain fp32 reference from the same inputs; the worst outfit's mean gap in
uint8 levels between the program's images and the reference's is held to
the cell's limit.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from benchmark.core import traffic as traffic_mod
from benchmark.core.harness import Check, Run
from benchmark.core.weights import make_weights, reference_towers


@dataclass
class State:
    model: object
    pipeline: object
    traffic: traffic_mod.GenTraffic
    outputs: List[tuple]          # (batch index, batch, uint8 images [F, H, W, 3])
    gen_seed: int


def forwards_per_batch(gen: dict) -> int:
    """UNet forwards of one sampler run: PNDM's plan has steps + 1
    iterations (the corrector). The reference holds PNDM alone."""
    if gen["scheduler"] != "pndm":
        raise ValueError(f"scheduler {gen['scheduler']!r}: the generate runner and its "
                         "reference run PNDM")
    return gen["num_inference_steps"] + 1


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
    if run.device.startswith("cuda"):
        kernels.build_all(w["kernels"])   # at once: only a first run compiles
    run.mark("kernels")
    dtype = getattr(torch, w["dtype"])
    cfg = Config.from_dict({"model": mc, "generation": w["generation"]})
    with torch.device("meta"):
        model = DiFashion(cfg.model)
    model = model.to(dtype).to_empty(device=run.device)
    load_difashion(model, make_weights(mc, run.seed, run.device, dtype))
    model.eval()
    run.mark("weights")
    s, c = mc["unet"]["sample_size"], mc["vae"]["latent_channels"]
    tr = traffic_mod.generation(w["traffic"], run.seed, (s, s, c))
    tokenizer = load_tokenizer(None, vocab_size=mc["text"]["vocab_size"], strict=False)
    pipeline = GenerationPipeline(model, cfg, tr.id_cate, tokenizer,
                                  HistLatentStore(tr.hist, tr.null_latent),
                                  null_latent=tr.null_latent)
    gen_seed = int(run.seed) % (2 ** 62)
    run.mark("traffic_and_pipeline")
    # warm-up: the window's shapes (a sampler over the same rows, a decode)
    g = w["generation"]
    warm = build_sampler(model, num_inference_steps=w["warmup_steps"], spec=pipeline.spec,
                         eta=g["eta"], scheduler=g["scheduler"])
    prep = _prepare(pipeline, w, tr.batch(0), gen_seed)
    decode_to_uint8(model, warm(prep.inputs)).cpu()
    del prep
    run.mark("warmup")
    return State(model, pipeline, tr, [], gen_seed)


def _prepare(pipeline, w, batch, seed):
    t = w["traffic"]
    per, olen = t["outfits_per_batch"], t["items_per_outfit"]
    return pipeline.prepare_batch(batch, t["task"], seed, pad_to=per * olen, pad_outfits=per)


def window(run: Run, st: State) -> None:
    """Batches until `run.seconds` have passed, then the batch in flight."""
    from difashion_tpu_torch.engine.generate import decode_to_uint8
    from difashion_tpu_torch.nn import kernels

    w = run.workload
    before = dict(kernels.LAUNCHES)
    i = 0
    with run.window():
        start = time.perf_counter()
        while True:
            batch = st.traffic.batch(i)
            if run.trace:
                with run.span("prepare"):
                    prep = _prepare(st.pipeline, w, batch, st.gen_seed)
                with run.span("sample"):
                    latents = st.pipeline.sample(prep)
                with run.span("decode"):
                    imgs = decode_to_uint8(st.model, latents)
                with run.span("fetch"):
                    imgs = imgs.cpu().numpy()
            else:
                prep = _prepare(st.pipeline, w, batch, st.gen_seed)
                imgs = st.pipeline.generate_batch(prep)
            st.outputs.append((i, batch, imgs[prep.valid]))
            i += 1
            if time.perf_counter() - start >= run.seconds:
                break
    images = sum(len(o[2]) for o in st.outputs)
    run.attempted = images
    run.end_to_end["images_per_s"] = images / run.window_s
    launches = {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in kernels.LAUNCHES}
    run.counts.update(batches=i, images=images,
                      unet_forwards=i * forwards_per_batch(w["generation"]),
                      unet_rows=int(prep.inputs.init_latents.shape[0])
                      * st.pipeline.spec.num_branches,
                      launches=launches, trace_launches=launches if run.trace else {})


def work_counts(run: Run) -> None:
    """The window's work by shapes, for the traced run's readers: the UNet
    forward over the batch's rows (every CFG branch of every fill), the
    MutualEncoder over the fills, the decode of a batch."""
    from benchmark.core import work

    t = run.workload["traffic"]
    fills = t["outfits_per_batch"] * t["items_per_outfit"]
    n_fwd, batches = run.counts["unet_forwards"], run.counts["batches"]
    unet = work.unet_work(run.model_cfg, run.counts["unet_rows"])
    mutual = work.mutual_work(run.model_cfg, fills)
    decode = work.decode_work(run.model_cfg, fills)
    run.counts["work"] = {"unet": (unet, n_fwd), "decode": (decode, batches)}
    run.counts["flops"] = n_fwd * (unet.flops + mutual.flops) + batches * decode.flops


def picks(run: Run, st: State) -> List[tuple]:
    """(batch index, outfit) of the `check.outfits` outfits checked: the
    i-th sits in slot i of its batch (the slots taken in turn, so that
    checking as many outfits as a batch holds covers every slot), each in a
    batch drawn from the seed among the window's finished ones, a different
    batch for each while they last."""
    order = traffic_mod.rng(run.seed, 2).permutation(len(st.outputs))
    chosen = set()
    for i in range(run.workload["check"]["outfits"]):
        k = int(order[i % len(order)])
        chosen.add((k, i % len(st.outputs[k][1]["uids"])))
    return sorted(chosen)


def reference_images(run: Run, tr: traffic_mod.GenTraffic, chosen, gen_seed: int,
                     outputs, prec=None) -> np.ndarray:
    """The reference's uint8 images of the chosen outfits' fills, in the
    order of the program's."""
    import torch

    from benchmark.reference.sampling import (fill_noise, generate_outfits, hash_token_ids,
                                              train_prompt)

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


def program_images(run: Run, chosen, outputs) -> np.ndarray:
    olen = run.workload["traffic"]["items_per_outfit"]
    return np.concatenate([outputs[k][2][b * olen:(b + 1) * olen] for k, b in chosen])


def level_gap(prog: np.ndarray, ref: np.ndarray, olen: int) -> float:
    """The worst outfit's mean |program - reference| in uint8 levels (the
    images in outfits of `olen`), so that one outfit gone wrong is not
    averaged away by the others."""
    gap = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return float(gap.reshape((-1, olen) + gap.shape[1:]).mean(axis=(1, 2, 3, 4)).max())


def free(st: State) -> None:
    import torch

    st.model = st.pipeline = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run: Run, st: State) -> None:
    chosen = picks(run, st)
    ref = reference_images(run, st.traffic, chosen, st.gen_seed, st.outputs)
    run.checks["image_mean_abs_levels"] = Check(
        level_gap(program_images(run, chosen, st.outputs), ref,
                  run.workload["traffic"]["items_per_outfit"]),
        run.workload["check"]["limits"]["image_mean_abs_levels"])


def run(run: Run, program_fault: Optional[Callable] = None) -> None:
    """Set-up, window, the peak, the program freed, the check. A
    `program_fault(state)` (tests only) breaks the program after set-up."""
    import torch

    st = setup(run)
    if program_fault is not None:
        program_fault(st)
    window(run, st)
    if run.device.startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    free(st)
    if run.trace:
        work_counts(run)
    run.mark("window_closed")
    check(run, st)
    run.mark("checked")
