"""The port's tracing (`core/tracing.py`) on the CPU at the tiny config: off,
a span is the shared null context and records nothing; on, names, nesting
by time and threads; the sampler's spans and `gen.unet_forwards` per
scheduler, one `unet.resnet` / `unet.transformer` per block per forward; a
train step's spans in order and `train.steps`; the sampler's latents and a
train step's loss and parameters bitwise equal with tracing on and off; the
generation service's and the train command's timings. The module imports
no JAX: its case on the card (`-m cuda`) puts one span around a known kernel
and reads the offset between the program's record and the profiler's
events, run there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_port_tracing.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from difashion_tpu_torch.cli import serve
from difashion_tpu_torch.cli.train import host_means
from difashion_tpu_torch.config import Config
from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.data.datasets import HistLatentStore
from difashion_tpu_torch.data.tokenizer import HashTokenizer
from difashion_tpu_torch.engine import generate as tgen
from difashion_tpu_torch.engine.pipeline import GenerationPipeline
from difashion_tpu_torch.engine.train import TrainBatch, build_train_step
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.nn.attention import Transformer2D
from difashion_tpu_torch.nn.layers import ResnetBlock2D

CATES = {c: f"cate{c}" for c in range(1, 6)}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every case starts and ends with tracing off and no records."""
    tracing.disable()
    tracing.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def cfg():
    c = Config.preset_tiny()
    return dataclasses.replace(c, generation=dataclasses.replace(
        c.generation, num_inference_steps=2, fitb_batch_size=2, gor_batch_size=2))


@pytest.fixture(scope="module")
def model(cfg):
    return create_difashion(cfg.model, seed=0, device="cpu")


def _counted(before):
    return {k: v - before.get(k, 0) for k, v in tracing.COUNTERS.items()}


def _parent(rec, recs):
    """The innermost other record of `rec`'s thread that holds it in time,
    or None."""
    around = [r for r in recs if r is not rec and r.thread == rec.thread
              and r.start_ns <= rec.start_ns and rec.end_ns <= r.end_ns]
    return max(around, key=lambda r: (r.start_ns, -r.end_ns), default=None)


def _inputs(cfg, F=4, seed=0):
    """Dense generation inputs of F // 4 GOR outfits at the tiny size."""
    h, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    D = cfg.model.text.hidden_size
    g = torch.Generator().manual_seed(seed)
    B = F // 4
    return tgen.GenerationInputs(
        init_latents=torch.randn(F, h, h, C, generator=g),
        outfit_idx=torch.arange(F) // 4,
        known_latents=torch.randn(B, 4, h, h, C, generator=g),
        gen_mask=torch.ones(B, 4, dtype=torch.bool),
        gen_index=torch.arange(F).reshape(B, 4),
        hist_latents=torch.randn(F, h, h, C, generator=g),
        cate_text=torch.randn(F, 77, D, generator=g),
        null_text=torch.randn(77, D, generator=g),
        null_latent=torch.randn(h, h, C, generator=g))


def _sampler(model, scheduler="pndm", steps=2):
    spec = tgen.make_guidance_spec(3.0, 2.0, 2.5)
    return tgen.build_sampler(model, num_inference_steps=steps, spec=spec, eta=0.1,
                              scheduler=scheduler)


# ---- the module ----------------------------------------------------------------


def test_off_is_the_shared_null_context_and_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.NULL and tracing.span("b") is tracing.NULL
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    assert tracing.traced("c")(lambda x: x + 1)(1) == 2
    assert tracing.take() == []


def test_on_records_names_nesting_parents_and_threads():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
        with tracing.span("inner2"):
            pass
    other = []

    def work():
        with tracing.span("elsewhere"):
            other.append(threading.get_native_id())

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    theirs = tracing.take(thread=other[0])
    assert [r.name for r in theirs] == ["elsewhere"]
    recs = tracing.take()
    assert [r.name for r in recs] == ["inner", "inner2", "outer"]   # closing order
    inner, inner2, outer = recs
    assert _parent(outer, recs) is None
    assert _parent(inner, recs) is outer and _parent(inner2, recs) is outer
    assert {r.thread for r in recs} == {threading.get_native_id()}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns
    assert tracing.take() == []
    before = dict(tracing.COUNTERS)
    tracing.disable()
    tracing.count("x.things", 3)          # counters count with spans off
    assert _counted(before)["x.things"] == 3


# ---- the sampler, the UNet -----------------------------------------------------


@pytest.mark.parametrize("scheduler,iterations", [("pndm", 3), ("ddim", 2), ("dpmpp", 2)])
def test_sampler_spans_and_forward_count(cfg, model, scheduler, iterations):
    sample = _sampler(model, scheduler)
    before = dict(tracing.COUNTERS)
    tracing.enable()
    sample(_inputs(cfg))
    recs = tracing.take()
    assert _counted(before)["gen.unet_forwards"] == iterations
    names = [r.name for r in recs]
    parent = {id(r): _parent(r, recs) for r in recs}
    (top,) = [r for r in recs if parent[id(r)] is None]
    assert top.name == "gen.sample"
    for name in ("gen.mutual", "gen.unet", "gen.scheduler"):
        mine = [r for r in recs if r.name == name]
        assert len(mine) == iterations and all(parent[id(r)] is top for r in mine)
    kids = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if parent[id(r)] is top]
    assert kids == ["gen.mutual", "gen.unet", "gen.scheduler"] * iterations
    blocks = {name: sum(isinstance(m, kind) for m in model.unet.modules())
              for name, kind in (("unet.resnet", ResnetBlock2D),
                                 ("unet.transformer", Transformer2D))}
    assert blocks["unet.resnet"] > 0 and blocks["unet.transformer"] > 0
    for name, n in blocks.items():
        assert names.count(name) == n * iterations
        assert all(parent[id(r)].name == "gen.unet" for r in recs if r.name == name)


def test_decode_prepare_and_fetch_spans(cfg, model):
    pipe = GenerationPipeline(model, cfg, CATES, HashTokenizer(cfg.model.text.vocab_size),
                              None)
    batch = {"uids": np.array([1]), "oids": np.array([100]),
             "outfits": np.zeros((1, 4), np.int64), "category": np.array([[1, 2, 3, 4]])}
    tracing.enable()
    prep = pipe.prepare_batch(batch, "GOR", 3)
    imgs = pipe.generate_batch(prep)
    recs = tracing.take()
    top = [r.name for r in recs if _parent(r, recs) is None]
    assert top == ["gen.prepare", "gen.sample", "gen.decode", "gen.fetch"]
    assert imgs.shape[0] == 4 and imgs.dtype == np.uint8


# ---- the train step --------------------------------------------------------------


def _train_batch(cfg, seed=0, B=2):
    h, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    g = torch.Generator().manual_seed(seed)
    return TrainBatch(images=None, latent_mean=torch.randn(B, 4, h, h, C, generator=g),
                      latent_logvar=torch.rand(B, 4, h, h, C, generator=g) * -6 - 2,
                      input_ids=torch.randint(0, 100, (B, 4, 77), generator=g),
                      hist_latents=torch.randn(B, 4, h, h, C, generator=g))


def _train_step(cfg, k=1):
    model = create_difashion(cfg.model, seed=0, device="cpu")
    tcfg = dataclasses.replace(cfg.train, gradient_accumulation_steps=k)
    step, init = build_train_step(model, tcfg)
    h, C = cfg.model.unet.sample_size, cfg.model.vae.latent_channels
    null_latent = torch.zeros(h, h, C)
    null_text = torch.zeros(77, cfg.model.text.hidden_size)
    return step, init(), null_latent, null_text


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_spans_in_order(cfg, k):
    step, state, null_latent, null_text = _train_step(cfg, k)
    before = dict(tracing.COUNTERS)
    tracing.enable()
    step(state, _train_batch(cfg), null_latent, null_text, torch.Generator().manual_seed(1))
    recs = tracing.take()
    assert _counted(before)["train.steps"] == 1
    parent = {id(r): _parent(r, recs) for r in recs}
    top = [r for r in sorted(recs, key=lambda r: r.start_ns) if parent[id(r)] is None]
    assert [r.name for r in top] == (["train.forward", "train.backward"] * k
                                     + ["train.allreduce", "train.update"])
    (sync,) = [r for r in recs if r.name == "train.sync"]
    assert parent[id(sync)] is top[-1]
    # the UNet's blocks run inside the forward
    resnets = [r for r in recs if r.name == "unet.resnet"]
    assert resnets and all(parent[id(r)].name == "train.forward" for r in resnets)


@pytest.mark.parametrize("what", ["sampler", "train_step"])
def test_tracing_on_and_off_give_the_same_bits(cfg, model, what):
    def run():
        if what == "sampler":
            return [_sampler(model)(_inputs(cfg, seed=5))]
        step, state, null_latent, null_text = _train_step(cfg)
        _, m = step(state, _train_batch(cfg, seed=2), null_latent, null_text,
                    torch.Generator().manual_seed(4))
        return [m["loss"], m["grad_norm"]] + [p.detach().clone() for p in state.params]

    off = run()
    tracing.enable()
    on = run()
    assert tracing.take()
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


# ---- the operator outputs ---------------------------------------------------------


def test_service_timings_with_tracing_on(cfg, model):
    pipe = GenerationPipeline(model, cfg, CATES, HashTokenizer(cfg.model.text.vocab_size),
                              HistLatentStore({}, np.zeros((8, 8, 4), np.float32)))
    svc = serve.GenerationService(pipe, max_batch=2)
    req = {"task": "FITB", "uids": [1, 2], "oids": [100, 101],
           "outfits": [[0, 3, 4, 5], [6, 0, 7, 8]], "category": [[1, 2, 3, 4], [2, 3, 4, 5]],
           "seed": 7}
    assert "timings" not in svc.generate(req)
    tracing.enable()
    out = svc.generate(req)
    t = out["timings"]
    assert set(t) == {"lock_wait_s", "device_s", "jpeg_s"}
    assert t["lock_wait_s"] >= 0 and t["device_s"] > 0 and t["jpeg_s"] > 0
    assert t["device_s"] + t["jpeg_s"] <= out["latency_s"] + 1e-3
    assert len(out["images"]) == 2
    assert tracing.take(thread=threading.get_native_id()) == []   # the request took its own


def test_train_rows_host_means():
    rec = lambda name, ms: tracing.Record(name, 1, 0, int(ms * 1e6))
    got = host_means([rec("train.batch", 2.0), rec("train.batch", 4.0),
                      rec("train.sync", 10.0), rec("train.allreduce", 0.5),
                      rec("unet.resnet", 1.0)])
    assert got == {"batch_host_ms": 3.0, "sync_host_ms": 10.0, "allreduce_host_ms": 0.5}


# ---- the clock, on the CPU and on the card ----------------------------------------


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def test_record_sits_inside_the_profilers_events(device):
    """One span around one known kernel: the record is stamped inside the
    profiler's event of the span and around the kernel's launch, so the
    offset between the two clocks is a few microseconds of the span's own
    work and never below 0."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 16, device=device)
    (x * 2).sum().item()   # the kernel's first launch, outside the profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    tracing.enable()
    with profile(activities=acts) as prof:
        with tracing.span("probe"):
            y = x * 2
        if device.type == "cuda":
            torch.cuda.synchronize()
    (rec,) = tracing.take()
    events = list(prof.profiler.kineto_results.events())
    (ev,) = [e for e in events if e.name() == "probe" and not str(e.device_type()).endswith("CUDA")]
    offset_us = (rec.start_ns - ev.start_ns()) * 1e-3
    assert 0 <= offset_us < 5000 and rec.end_ns <= ev.end_ns()
    mul = [e for e in events if e.name() == "aten::mul"]
    assert len(mul) == 1 and rec.start_ns <= mul[0].start_ns() <= mul[0].end_ns() <= rec.end_ns
    if device.type == "cuda":
        on_card = lambda e: str(e.device_type()).endswith("CUDA")
        (kernel,) = [e for e in events if on_card(e) and "elementwise" in e.name()]
        assert kernel.linked_correlation_id() == mul[0].correlation_id()
        calls = [e for e in events if not on_card(e) and e.name().startswith("cu")
                 and rec.start_ns <= e.start_ns() <= rec.end_ns]
        assert calls   # the launch, inside the record
        print(f"clock offset: record - profiler event {offset_us:.1f} us in a "
              f"{(rec.end_ns - rec.start_ns) * 1e-3:.1f} us record; launch at "
              f"{(calls[0].start_ns() - rec.start_ns) * 1e-3:.1f} us; kernel correlation "
              f"{kernel.correlation_id()} linked {kernel.linked_correlation_id()}; calls "
              f"{[(c.name(), c.correlation_id(), c.linked_correlation_id()) for c in calls]}; "
              f"threads: call {calls[0].device_resource_id()}, span "
              f"{ev.device_resource_id()}, record {rec.thread}")
    del y
