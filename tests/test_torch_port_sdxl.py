"""The port on the SDXL architecture, in fp32 on the CPU at the tiny XL
preset (`ModelConfig.tiny_xl`: 3 levels with 1 / 2 / 3 transformer blocks,
the added time / text conditioning, two text towers), against the plain
SDXL reference of the benchmark (`benchmark/reference/sdxl.py`) on the same
seeded weights (`benchmark/core/weights_xl.py`): each tower, a whole GOR
generation through `GenerationPipeline` (the `generate_xl` runner), the
published preset's towers, the spans and the counter, the train command's
refusal. Towers within 1e-5 of the reference's largest magnitude, as
`benchmark/tests/test_bench_reference.py` holds the SD towers."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark.core import harness
from benchmark.core.program_readers import unet_span_ms
from benchmark.core.program_trace import ProgramTrace
from benchmark.core.weights_xl import make_weights, reference_towers
from benchmark.reference import sdxl
from difashion_tpu_torch.config import Config, ModelConfig
from difashion_tpu_torch.core import tracing
from difashion_tpu_torch.engine.generate import (
    GenerationInputs,
    build_sampler,
    make_guidance_spec,
    pad_generation_inputs,
    shard_generation_inputs,
)
from difashion_tpu_torch.models.difashion import DiFashion
from difashion_tpu_torch.nn.attention import BasicTransformerBlock
from difashion_tpu_torch.weights import load_difashion, param_count, towers_of

ROOT = Path(__file__).resolve().parents[1]
CELL = "sdxl_base.gor_pndm50_b1"
SEED = 2 ** 31 + 29


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops are far too small for torch's intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mc(cfg=None) -> dict:
    return dataclasses.asdict(cfg or ModelConfig.tiny_xl())


def _close(a, b):
    return (a - b).abs().max().item() <= 1e-5 * (1 + b.abs().max().item())


@pytest.fixture(scope="module")
def towers():
    """(the port's tiny XL bundle, the reference's towers), seed 7, fp32."""
    mc = _mc()
    with torch.device("meta"):
        prog = DiFashion(Config.from_dict({"model": mc}).model)
    prog = prog.to_empty(device="cpu")
    load_difashion(prog, make_weights(mc, 7, "cpu", torch.float32))
    return prog.eval(), reference_towers(mc, 7, "cpu", torch.float32)


def _ids(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 990, (n, 77), generator=g)
    ids[:, 9:] = 0
    ids[:, 0], ids[:, 8] = 998, 999     # BOS, EOS: the largest id
    return ids


@pytest.mark.parametrize("tower", ["unet", "text_encoder", "text_encoder_2", "encode_text",
                                   "vae", "fashion_encoder"])
def test_tower_matches_the_reference(towers, tower):
    prog, ref = towers
    g = torch.Generator().manual_seed(1)
    ids = _ids(3)
    with torch.no_grad():
        if tower == "unet":
            x, t = torch.randn(3, 8, 8, 8, generator=g), torch.tensor([10, 500, 990])
            ctx, pooled = torch.randn(3, 77, 48, generator=g), torch.randn(3, 16, generator=g)
            time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64], [512, 768, 3, 9, 1024, 1024],
                                     [1024, 1024, 0, 0, 1024, 1024]])
            pairs = [(prog.apply_unet(x, t, ctx, pooled, time_ids),
                      ref["unet"](x, t, ctx, pooled, time_ids))]
            # the added conditioning moves the output
            assert not _close(prog.apply_unet(x, t, ctx, pooled * 0, time_ids), pairs[0][1])
        elif tower in ("text_encoder", "text_encoder_2"):
            ctx, pooled = getattr(prog, tower)(ids, pooled=True)
            ref_ctx, ref_pooled = ref[tower](ids)
            pairs = [(ctx, ref_ctx), (pooled, ref_pooled)]
            if tower == "text_encoder":   # the context alone skips the unused last layer
                pairs.append((getattr(prog, tower)(ids), ref_ctx))
        elif tower == "encode_text":
            ctx, pooled = prog.encode_text(ids, pooled=True)
            assert ctx.shape == (3, 77, 48) and pooled.shape == (3, 16)
            pairs = list(zip((ctx, pooled), sdxl.encode_text(ref, ids)))
        elif tower == "vae":
            z = torch.randn(2, 4, 8, 8, generator=g)
            pairs = [(prog.decode_latents(z), ref["vae"].decode(z))]
        else:
            x = torch.randn(3, 4, 8, 8, generator=g)
            pairs = [(prog.apply_mutual(x), ref["fashion_encoder"](x))]
    for a, b in pairs:
        assert a.shape == b.shape and _close(a, b)


def test_sdxl_base_preset_is_the_published_architecture():
    """ModelConfig.sdxl_base() through DiFashion (on the meta device): the
    keys and shapes that the strict loader holds to are the reference's
    (the benchmark's runner loads them at full size on the card); 70
    BasicTransformerBlocks, d = 64, a 2048-wide context, a 1280-wide pooled
    embedding and a 2816-wide added input; the towers' sizes are the
    reference's and the configuration file's."""
    cfg = ModelConfig.sdxl_base()
    with torch.device("meta"):
        model = DiFashion(cfg)
    mc = _mc(cfg)
    for t in towers_of(model):
        own, theirs = getattr(model, t).state_dict(), sdxl.build_tower(t, mc).state_dict()
        assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in theirs.items()}
    blocks = [m for m in model.unet.modules() if isinstance(m, BasicTransformerBlock)]
    assert len(blocks) == 70 == sdxl.transformer_blocks_per_forward(mc["unet"])
    assert {b.attn1.head_dim for b in blocks} == {64}
    assert {b.attn2.to_k.in_features for b in blocks} == {2048}
    assert model.unet.add_embedding.linear_1.in_features == 2816
    assert model.text_encoder_2.text_projection.out_features == 1280
    assert towers_of(model) == ("unet", "vae", "text_encoder", "fashion_encoder",
                                "text_encoder_2")
    file = json.loads((ROOT / "benchmark" / "configs" / "sdxl_base.json").read_text())
    assert Config.from_dict({"model": file["model"]}).model == cfg
    for t in sdxl.TOWERS:
        n = param_count(getattr(model, t))
        assert n == param_count(sdxl.build_tower(t, mc)) == file["parameters"][t], t
    assert file["parameters"]["unet"] == 2567475204


@pytest.fixture(scope="module")
def tiny_base(tmp_path_factory):
    """A benchmark-like folder holding the new cell at the tiny XL preset:
    3 steps, 64 px, 2 batches drawn, the cell's limit."""
    base = tmp_path_factory.mktemp("bench_xl")
    (base / "configs").mkdir()
    (base / "workloads").mkdir()
    (base / "configs" / "tiny_xl.json").write_text(json.dumps(
        {"name": "tiny_xl", "reduced": [], "model": _mc()}))
    w = json.loads((ROOT / "benchmark" / "workloads" / f"{CELL}.json").read_text())
    w["generation"].update(num_inference_steps=3, height=64, width=64)
    w["traffic"]["batches"] = 2
    (base / "workloads" / "tiny_xl.gor.json").write_text(json.dumps(dict(w, config="tiny_xl")))
    return base


def _run(base, trace=False, **workload):
    run = harness.Run(cell="tiny_xl.gor", seed=SEED, seconds=0.0, trace=trace, device="cpu",
                      t0=time.perf_counter(), base=base)
    run.workload.update(workload)
    harness.load_runner(run.workload["runner"]).run(run)
    return run


def test_gor_generation_matches_the_reference(tiny_base):
    """A whole GOR batch through `GenerationPipeline` (the generate_xl
    runner: pooled category table, per-branch blend, time ids) against the
    reference's `generate_outfits`, in fp32: a level flips at most."""
    run = _run(tiny_base, dtype="float32")
    assert run.counts["batches"] == 1 and run.counts["unet_rows"] == 16
    assert run.checks["image_mean_abs_levels"].value < 1e-2


def test_traced_run_counts_the_xl_work(tiny_base):
    """A traced run on the CPU: the SDXL work is counted (the add
    embedding's products among the flops) and the profiled batch holds no
    device time, so the span readers read nothing."""
    run = _run(tiny_base, trace=True, dtype="float32")
    unet, n = run.counts["work"]["unet"]
    assert n == run.counts["unet_forwards"] == 4
    assert (16, 64, 128, True) in unet.dense   # add_embedding.linear_1 over 16 rows
    assert run.program is None and unet_span_ms(run, "unet.transformer") is None
    assert run.checks["image_mean_abs_levels"].ok


@pytest.mark.parametrize("preset,blocks", [("tiny", 10), ("tiny_xl", 18)])
def test_transformer_block_counter_and_spans(preset, blocks):
    """`unet.transformer_blocks` counts the blocks a forward runs (spans off
    as well), `unet.add_embedding` spans each XL forward (no SD one), and
    `text.encode` the bundle's encode of both towers."""
    from difashion_tpu_torch.models.difashion import create_difashion

    cfg = getattr(ModelConfig, preset)()
    assert sdxl.transformer_blocks_per_forward(_mc(cfg)["unet"]) == blocks
    model = create_difashion(cfg, seed=0, device="cpu")
    ids = _ids(2)
    x, t = torch.randn(2, 8, 8, 8), torch.tensor([5, 700])
    time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2)
    before = dict(tracing.COUNTERS)
    tracing.reset()
    with torch.no_grad():
        ctx, pooled = model.encode_text(ids, pooled=True)
        added = {} if pooled is None else {"text_embeds": pooled, "time_ids": time_ids}
        model.apply_unet(x, t, ctx, **added)
        assert tracing.take() == []
        tracing.enable()
        try:
            model.encode_text(ids)
            model.apply_unet(x, t, ctx, **added)
            model.apply_unet(x, t, ctx, **added)
        finally:
            tracing.disable()
    names = [r.name for r in tracing.take()]
    counted = tracing.COUNTERS["unet.transformer_blocks"] - before.get("unet.transformer_blocks", 0)
    assert counted == 3 * blocks
    assert names.count("text.encode") == 1
    assert names.count("unet.add_embedding") == (2 if preset == "tiny_xl" else 0)


def test_block_counter_counts_a_recomputed_forward_once():
    """Under gradient checkpointing the blocks run again in the backward;
    the counter counts the forward's blocks once."""
    from difashion_tpu_torch.models.unet import UNet2DCondition

    cfg = ModelConfig.tiny_xl().unet
    torch.manual_seed(0)
    unet = UNet2DCondition(cfg)
    unet.set_gradient_checkpointing(True)
    before = tracing.COUNTERS.get("unet.transformer_blocks", 0)
    out = unet(torch.randn(2, 8, 8, 8), torch.tensor([5, 700]), torch.randn(2, 77, 48),
               text_embeds=torch.randn(2, 16),
               time_ids=torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2))
    out.float().square().mean().backward()
    assert unet.blocks_per_forward == 18
    assert tracing.COUNTERS["unet.transformer_blocks"] - before == 18


@pytest.mark.parametrize("fault", ["no_text_2", "no_added_conditioning", "input_width"])
def test_model_config_holds_the_xl_conditioning_together(fault):
    """A second text tower without the UNet's added conditioning, the
    added conditioning without a second tower, or an added input width
    other than the pooled width + 6 time embeddings is refused when the
    config is built (from the JSON too)."""
    cfg = ModelConfig.tiny_xl()
    if fault == "no_text_2":
        bad = dict(text_2=None)
    elif fault == "no_added_conditioning":
        bad = dict(unet=dataclasses.replace(cfg.unet, addition_embed_type=None))
    else:
        bad = dict(unet=dataclasses.replace(cfg.unet, projection_class_embeddings_input_dim=40))
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, **bad)
    mc = _mc(cfg)
    for key, value in bad.items():
        mc[key] = dataclasses.asdict(value) if value is not None else None
    with pytest.raises(ValueError):
        Config.from_dict({"model": mc})


def test_span_readers_check_the_block_count():
    """The span readers report a span's ms a forward where the program
    counted the configuration's blocks, and nothing (with a note) where it
    did not."""
    run = type("R", (), {})()
    run.model_cfg, run.notes = _mc(ModelConfig.sdxl_base()), []
    run.program = ProgramTrace(device_s=1.0, total_s={"unet.transformer": 0.51,
                                                      "unet.resnet": 0.255},
                               counts={"gen.unet_forwards": 51,
                                       "unet.transformer_blocks": 70 * 51})
    assert unet_span_ms(run, "unet.transformer") == pytest.approx(10.0)
    assert unet_span_ms(run, "unet.resnet") == pytest.approx(5.0)
    run.program.counts["unet.transformer_blocks"] = 16 * 51
    assert unet_span_ms(run, "unet.resnet") is None and len(run.notes) == 1
    run.program.counts.pop("unet.transformer_blocks")
    assert unet_span_ms(run, "unet.transformer") is None


def test_padded_and_sharded_inputs_carry_the_pooled_prompts(towers):
    """pad_generation_inputs / shard_generation_inputs pad and slice the
    pooled category prompts as the fills; the padded batch's sampler rows
    are the unpadded batch's."""
    prog, _ = towers
    F_, s = 4, 8
    g = torch.Generator().manual_seed(3)
    r = lambda *shape: torch.randn(*shape, generator=g)
    with torch.no_grad():
        ctx, pooled = prog.encode_text(_ids(F_ + 1, seed=2), pooled=True)
    inputs = GenerationInputs(
        init_latents=r(F_, s, s, 4), outfit_idx=torch.zeros(F_, dtype=torch.long),
        known_latents=r(1, F_, s, s, 4), gen_mask=torch.ones(1, F_, dtype=torch.bool),
        gen_index=torch.arange(F_).view(1, F_), hist_latents=r(F_, s, s, 4),
        cate_text=ctx[:F_], null_text=ctx[F_], null_latent=r(s, s, 4),
        cate_pooled=pooled[:F_], null_pooled=pooled[F_],
        time_ids=torch.tensor([64.0, 64, 0, 0, 64, 64]))
    padded = pad_generation_inputs(inputs, 3)
    assert padded.cate_pooled.shape == (6, 16) and torch.equal(padded.cate_pooled[:F_],
                                                               inputs.cate_pooled)
    shard = shard_generation_inputs(inputs, 1, 2)
    assert torch.equal(shard.cate_pooled, inputs.cate_pooled[2:])
    assert shard.null_pooled is inputs.null_pooled and shard.time_ids is inputs.time_ids
    sampler = build_sampler(prog, num_inference_steps=2,
                            spec=make_guidance_spec(12.0, 4.0, 5.0), eta=0.1)
    want = sampler(inputs)
    got = sampler(padded)[:F_]
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    # the pooled prompts reach the UNet
    other = sampler(inputs._replace(cate_pooled=inputs.cate_pooled * 0))
    assert not torch.allclose(other, want, rtol=1e-3, atol=1e-3)


def test_train_command_refuses_the_xl_config(tmp_path):
    from difashion_tpu_torch.cli import train

    path = tmp_path / "xl.json"
    path.write_text(Config(model=ModelConfig.tiny_xl()).to_json())
    with pytest.raises(SystemExit, match="second text tower"):
        train.main(["--config", str(path), "--device", "cpu", "--data_path",
                    str(tmp_path / "absent"), "--output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
