"""The port's training slice against the JAX package on the CPU at the tiny
config: `TrainConfig`, the schedule's training quantities, `difashion_loss`
and its gradients (injected draws; weights carried across with
`core/importer.py::export_params`), the optimizer chain (clip, AdamW, EMA,
the LR schedules, the skip of non-finite updates, 8-bit AdamW) against optax,
and the port's own accumulation and gradient-checkpointing contracts."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from difashion_tpu.core import config as jcfg
from difashion_tpu.core.importer import export_params
from difashion_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from difashion_tpu.engine import train as jtrain
from difashion_tpu.models.clip_text import init_clip_text
from difashion_tpu.models.difashion import DiFashionModel
from difashion_tpu.models.mutual import init_mutual_encoder
from difashion_tpu.models.unet import init_unet
from difashion_tpu.models.vae import AutoencoderKL as JVAE
from difashion_tpu_torch import config as tcfg
from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule
from difashion_tpu_torch.engine import train as ttrain
from difashion_tpu_torch.engine.optim8bit import dequantize, quantize
from difashion_tpu_torch.models.difashion import create_difashion
from difashion_tpu_torch.weights import load_tower

from golden_oracle import oracle
from test_train_loss_golden import CASES

B, OLEN = 2, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    """The towers the loss uses of the JAX bundle behind the committed
    `train_loss_*` fixtures (`create_difashion(tiny, PRNGKey(11))`: same keys,
    same inits; the VAE is not initialised, since a moments batch never runs
    it), and the port with those weights loaded."""
    cfg = jcfg.ModelConfig.tiny()
    r_unet, _, r_text, r_mut = jax.random.split(jax.random.PRNGKey(11), 4)
    unet, unet_p = init_unet(cfg.unet, r_unet)
    text, text_p = init_clip_text(cfg.text, r_text)
    mutual, mutual_p = init_mutual_encoder(cfg.mutual, r_mut)
    model = DiFashionModel(config=cfg, unet=unet, vae=JVAE(cfg.vae), text_encoder=text,
                           fashion_encoder=mutual, schedule=JSchedule.create(cfg.scheduler))
    params = {"unet": unet_p, "text_encoder": text_p, "fashion_encoder": mutual_p,
              "vae": {}}
    port = create_difashion(tcfg.ModelConfig.tiny(), seed=0, device="cpu")
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    load_tower(port.unet, export_params(unet_p, "unet"), "unet")
    load_tower(port.text_encoder, export_params(text_p, "text"), "text_encoder")
    load_tower(port.fashion_encoder, export_params(mutual_p, "mutual", mutual_dims=dims),
               "fashion_encoder")
    port.prepare_for_training()
    return cfg, model, params, port


def case_inputs(cfg, uh, um, pred_type, gamma):
    """The inputs and injected draws of tests/test_train_loss_golden.py for a
    case (the same seed, the same order of draws), as numpy arrays."""
    n, h, C = B * OLEN, cfg.unet.sample_size, cfg.vae.latent_channels
    rng = np.random.RandomState(
        zlib.crc32(repr((uh, um, pred_type, bool(gamma))).encode()) % 9973)
    x = {}
    x["mean"] = rng.randn(B, OLEN, h, h, C).astype(np.float32) * 2.0
    x["logvar"] = rng.uniform(-8.0, -2.0, size=x["mean"].shape).astype(np.float32)
    x["hist"] = (rng.randn(B, OLEN, h, h, C) * 0.3).astype(np.float32)
    x["null_latent"] = (rng.randn(h, h, C) * 0.05).astype(np.float32)
    x["ids"] = rng.randint(0, cfg.text.vocab_size, size=(B, OLEN, 77)).astype(np.int32)
    x["enc_eps"] = rng.randn(n, h, h, C).astype(np.float32)
    x["noise"] = rng.randn(n, h, h, C).astype(np.float32)
    x["t_outfit"] = rng.randint(0, 1000, size=(B,))
    x["p_mask"] = rng.uniform(0.0, 1.0, size=(n,)).astype(np.float32)
    x["p_cate"] = rng.uniform(0.0, 1.0, size=(n,)).astype(np.float32)
    return x


INJECTED = ("enc_eps", "noise", "t_outfit", "p_mask", "p_cate")


def port_loss(port, x, null_text, tc):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    batch = ttrain.TrainBatch(images=None, latent_mean=t["mean"], latent_logvar=t["logvar"],
                              input_ids=t["ids"].long(), hist_latents=t["hist"])
    return ttrain.difashion_loss(port, batch, t["null_latent"], torch.from_numpy(null_text),
                                 None, tc, injected={k: t[k] for k in INJECTED})[0]


def jax_loss_fn(model, params, x, null_text, jc):
    trainable, frozen = jtrain.split_params(params)
    batch = jtrain.TrainBatch(images=None, latent_mean=jnp.asarray(x["mean"]),
                              latent_logvar=jnp.asarray(x["logvar"]),
                              input_ids=jnp.asarray(x["ids"]),
                              hist_latents=jnp.asarray(x["hist"]))
    inj = {k: jnp.asarray(x[k], jnp.int32 if k == "t_outfit" else jnp.float32)
           for k in INJECTED}
    return lambda tr: jtrain.difashion_loss(
        model, tr, frozen, batch, jnp.asarray(x["null_latent"]), jnp.asarray(null_text),
        jax.random.PRNGKey(0), jc, injected=inj)[0], trainable


def null_text_of(port):
    with torch.no_grad():
        return port.encode_text(torch.zeros(1, 77, dtype=torch.long))[0].numpy()


def test_train_config_matches_jax():
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(jcfg.TrainConfig())


def test_schedule_training_quantities_match_jax():
    cfg = jcfg.ModelConfig.tiny().scheduler
    js, ts = JSchedule.create(cfg), DiffusionSchedule.create(tcfg.SchedulerConfig())
    rng = np.random.RandomState(0)
    t = np.array([0, 1, 250, 999], np.int32)
    x0, eps = (rng.randn(4, 3, 5, 5).astype(np.float32) for _ in range(2))
    tt, tx0, teps = torch.from_numpy(t).long(), torch.from_numpy(x0), torch.from_numpy(eps)
    pairs = [(ts.add_noise(tx0, teps, tt), js.add_noise(x0, eps, t)),
             (ts.get_velocity(tx0, teps, tt), js.get_velocity(x0, eps, t)),
             (ts.snr(tt), js.snr(t)),
             (ts.pred_original_from_epsilon(tt, tx0, teps),
              js.pred_original_from_epsilon(t, x0, eps)),
             (ts.pred_original_from_epsilon(tt[2], tx0[:1], teps[:1], clip=False),
              js.pred_original_from_epsilon(t[2], x0[:1], eps[:1], clip=False))]
    for pred in ("epsilon", "v_prediction"):
        pairs.append((ts.min_snr_weights(tt, 5.0, pred), js.min_snr_weights(t, 5.0, pred)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uh,um,pred_type,gamma", CASES)
def test_loss_matches_jax_and_torch_oracle(bundle, uh, um, pred_type, gamma):
    cfg, model, params, port = bundle
    x = case_inputs(cfg, uh, um, pred_type, gamma)
    null_text = null_text_of(port)
    kw = dict(use_history=uh, use_mutual_guidance=um, prediction_type=pred_type,
              snr_gamma=gamma)
    with torch.no_grad():
        got = float(port_loss(port, x, null_text, tcfg.TrainConfig(**kw)))
    fn, trainable = jax_loss_fn(model, params, x, null_text, jcfg.TrainConfig(**kw))
    want = float(jax.jit(fn)(trainable))
    fixture = float(oracle(f"train_loss_uh{uh}_um{um}_{pred_type}_g{gamma}",
                           _missing_fixture)["loss"])
    # fp32 on both sides: sums in another order only (the fixtures' own bound)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, fixture, rtol=1e-5, atol=1e-5)


def _missing_fixture():
    raise AssertionError("committed train_loss fixture is missing")


def test_loss_gradients_match_jax_grad(bundle):
    """The recipe case: every trainable tensor's gradient against jax.grad,
    mapped to the port's names by export_params on the gradient tree. Relative
    L2 <= 1e-4 per tensor: both sides are fp32 and differ by the order of
    their sums, about 1e-6 of a gradient; the margin covers tensors whose
    gradient is small against the rounding of the sums that feed it. Plus an
    absolute 1e-8 in L2: where the exact gradient is 0 (the tiny UNet's mid
    level has one token, so its self-attention's softmax has one key and its
    q and k get no gradient), the flash backward's LSE recompute leaves
    dS = P (dP - D) at the fp32 rounding of dP - D, about 1e-11 an element."""
    cfg, model, params, port = bundle
    x = case_inputs(cfg, *CASES[0])
    null_text = null_text_of(port)
    for p in port.parameters():
        p.grad = None
    port_loss(port, x, null_text, tcfg.TrainConfig()).backward()
    fn, trainable = jax_loss_fn(model, params, x, null_text, jcfg.TrainConfig())
    grads = jax.jit(jax.grad(fn))(trainable)
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    want = {f"unet.{k}": v for k, v in export_params(grads["unet"], "unet").items()}
    want.update({f"fashion_encoder.{k}": v for k, v in export_params(
        grads["fashion_encoder"], "mutual", mutual_dims=dims).items()})
    named = dict(port.trainable_parameters())
    assert set(named) == set(want)
    checked = 0
    for name, p in named.items():
        w = want[name]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-8, name
        checked += np.linalg.norm(w) > 0
    assert checked > 100
    assert all(p.grad is None for p in port.text_encoder.parameters())


# ---- the optimizer chain against optax ----------------------------------------

SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
OPT_CASES = {
    "constant": dict(),
    "constant_with_warmup": dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=2),
    "cosine": dict(lr_scheduler="cosine", lr_warmup_steps=1, max_train_steps=4),
    "scale_lr": dict(scale_lr=True, dp_size=1, train_batch_size=3),
    "8bit": dict(use_8bit_adam=True),
}


def _opt_inputs(seed=0):
    """Parameters and three steps of gradients; the second is clipped (its
    global norm is far above 1), the others are not."""
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (0.05, 3.0, 0.1)]
    return params, grads


def _jax_steps(jc, params, grads):
    """The JAX train step's update after the gradient (engine/train.py:312-345)."""
    tx = jtrain.make_optimizer(jc)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state, ema, ema_step, norms = tx.init(p), dict(p), 0, []
    for g in grads:
        g = {k: jnp.asarray(v) for k, v in g.items()}
        norms.append(float(optax.global_norm(g)))
        updates, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        d = jtrain.ema_decay_schedule(jnp.asarray(ema_step, jnp.int32), jc.ema_decay)
        ema = jax.tree_util.tree_map(lambda e, q: d * e + (1.0 - d) * q, ema, p)
        ema_step += 1
    return p, ema, norms


def _port_state(tc, params):
    opt = ttrain.make_optimizer(tc)
    tp = [torch.tensor(params[k]) for k in SHAPES]
    ema = ttrain.EMAState(params=[t.clone() for t in tp], step=0)
    return opt, ttrain.TrainState(names=list(SHAPES), params=tp,
                                  opt_state=opt.init(tp), ema=ema)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_and_ema_match_optax(case):
    kw = dict(learning_rate=1e-3, **OPT_CASES[case])
    params, grads = _opt_inputs()
    want_p, want_ema, want_norms = _jax_steps(jcfg.TrainConfig(**kw), params, grads)
    tc = tcfg.TrainConfig(**kw)
    opt, state = _port_state(tc, params)
    for g, norm in zip(grads, want_norms):
        m = ttrain.apply_gradients(state, [torch.tensor(g[k]) for k in SHAPES], opt, tc)
        assert m["update_skipped"] == 0.0
        np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-6)
    assert state.opt_state.count == 3 and state.ema.step == 3 and state.step == 3
    # fp32 on both sides, one rounding apart per operation; the 8-bit moments
    # may round one element to the neighbouring int8 level
    tol = dict(rtol=1e-5, atol=1e-6) if case == "8bit" else dict(rtol=1e-6, atol=1e-7)
    for i, k in enumerate(SHAPES):
        np.testing.assert_allclose(state.params[i].numpy(), np.asarray(want_p[k]), **tol)
        np.testing.assert_allclose(state.ema.params[i].numpy(), np.asarray(want_ema[k]),
                                   **tol)


def test_lr_schedules_match_optax():
    kw = dict(learning_rate=2e-4, lr_warmup_steps=3, max_train_steps=10)
    for sched, jfn in (("constant_with_warmup", optax.linear_schedule(0.0, 2e-4, 3)),
                       ("cosine", optax.warmup_cosine_decay_schedule(0.0, 2e-4, 3, 10))):
        fn = ttrain.lr_schedule(tcfg.TrainConfig(lr_scheduler=sched, **kw))
        got = [fn(c) for c in range(12)]
        np.testing.assert_allclose(got, [float(jfn(c)) for c in range(12)], rtol=1e-6)
        assert got[0] == 0.0
    # optax's rule: a warmup of 0 steps holds the initial value
    fn = ttrain.lr_schedule(tcfg.TrainConfig(lr_scheduler="constant_with_warmup"))
    assert fn(0) == fn(5) == 0.0


def test_nonfinite_gradient_skips_the_update():
    tc = tcfg.TrainConfig(learning_rate=1e-3)
    params, grads = _opt_inputs(seed=1)
    opt, state = _port_state(tc, params)
    ttrain.apply_gradients(state, [torch.tensor(grads[0][k]) for k in SHAPES], opt, tc)
    held = [p.clone() for p in state.params]
    moments = [t.clone() for t in state.opt_state.mu + state.opt_state.nu]
    ema = [e.clone() for e in state.ema.params]
    bad = [torch.tensor(grads[1][k]) for k in SHAPES]
    bad[1][3] = float("nan")
    m = ttrain.apply_gradients(state, bad, opt, tc)
    assert m["update_skipped"] == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(state.params, held))
    assert all(torch.equal(a, b) for a, b in
               zip(state.opt_state.mu + state.opt_state.nu, moments))
    assert state.opt_state.count == 1 and state.ema.step == 1 and state.step == 2
    # EMA still moves towards the held parameters, with the decay of step 1
    d = ttrain.ema_decay_schedule(1, tc.ema_decay)
    for e0, e1, p in zip(ema, state.ema.params, state.params):
        torch.testing.assert_close(e1, d * e0 + (1 - d) * p, rtol=1e-6, atol=1e-7)


def test_adam8bit_quantization_matches_jax():
    from difashion_tpu.engine.optim8bit import _quantize

    x = np.random.RandomState(2).randn(1000).astype(np.float32) * 3
    x[256:512] = 0.0
    q, s = quantize(torch.from_numpy(x))
    jq, js = _quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    back = dequantize(q, s, torch.Size([1000])).numpy()
    assert np.abs(back - x).max() <= np.abs(x).max() / 127 + 1e-6
    assert not back[256:512].any()


# ---- the port's own contracts: accumulation, checkpointing, the step -----------

def _batch(cfg, seed, duplicate=False):
    rng = np.random.RandomState(seed)
    h, C = cfg.unet.sample_size, cfg.vae.latent_channels
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    batch = ttrain.TrainBatch(
        images=None, latent_mean=t(B, OLEN, h, h, C),
        latent_logvar=torch.full((B, OLEN, h, h, C), -6.0),
        input_ids=torch.from_numpy(rng.randint(0, cfg.text.vocab_size, (B, OLEN, 77))),
        hist_latents=t(B, OLEN, h, h, C) * 0.3)
    if duplicate:   # both outfits the same: only the draws tell them apart
        batch = ttrain.TrainBatch(None, *(x[:1].repeat(B, *([1] * (x.dim() - 1)))
                                          for x in batch[1:]))
    return batch


def _nulls(cfg):
    h, C = cfg.unet.sample_size, cfg.vae.latent_channels
    return torch.zeros(h, h, C), torch.zeros(77, cfg.text.hidden_size)


def test_accumulation_is_the_mean_of_fresh_microbatches():
    cfg = tcfg.ModelConfig.tiny()
    model = create_difashion(cfg, seed=1, device="cpu").prepare_for_training()
    tc = tcfg.TrainConfig(gradient_accumulation_steps=2, mixed_precision="no")
    batch, (nl, nt) = _batch(cfg, 3, duplicate=True), _nulls(cfg)
    params = [p for _, p in model.trainable_parameters()]
    grads, losses = ttrain.accumulate_gradients(model, params, batch, nl, nt,
                                                torch.Generator().manual_seed(5), tc)
    gen = torch.Generator().manual_seed(5)
    want, want_losses = None, []
    for i in range(2):
        mb = ttrain.TrainBatch(None, *(x[i:i + 1] for x in batch[1:]))
        loss, _ = ttrain.difashion_loss(model, mb, nl, nt, gen, tc)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, params)]
        want = g if want is None else [a + b for a, b in zip(want, g)]
        want_losses.append(loss.detach())
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w / 2, rtol=1e-5, atol=1e-7)
    assert torch.equal(torch.stack(losses), torch.stack(want_losses))
    # the two microbatches hold the same data: different losses mean fresh draws
    assert float(losses[0]) != float(losses[1])


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_gradient_checkpointing_gives_the_same_gradients(bundle, policy):
    cfg, _, _, port = bundle
    x = case_inputs(cfg, *CASES[0])
    null_text = null_text_of(port)

    def grads(enabled):
        port.unet.set_gradient_checkpointing(enabled, policy)
        for p in port.parameters():
            p.grad = None
        port_loss(port, x, null_text, tcfg.TrainConfig()).backward()
        port.unet.set_gradient_checkpointing(False)
        return [p.grad.clone() for _, p in port.trainable_parameters()
                if p.grad is not None]

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_train_step_recipe_on_cpu():
    """Two recipe steps (bf16 autocast, AdamW, EMA) through build_train_step:
    finite loss, no skip, parameters move, EMA moves by (1 - d) of the way."""
    cfg = tcfg.ModelConfig.tiny()
    model = create_difashion(cfg, seed=2, device="cpu")
    tc = tcfg.TrainConfig(learning_rate=1e-4)
    step, init = ttrain.build_train_step(model, tc)
    state = init()
    assert model.fashion_encoder.training and not model.vae.training
    assert not any(p.requires_grad for p in model.text_encoder.parameters())
    gen = torch.Generator().manual_seed(0)
    nl, nt = _nulls(cfg)
    for i in range(2):
        before = [p.detach().clone() for p in state.params]
        ema_before = [e.clone() for e in state.ema.params]
        d = ttrain.ema_decay_schedule(state.ema.step, tc.ema_decay)
        state, m = step(state, _batch(cfg, 10 + i), nl, nt, gen)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
        assert m["update_skipped"] == 0.0
        assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
        # atol: the fp32 rounding of two parameters of magnitude ~1
        for e0, e1, p in zip(ema_before, state.ema.params, state.params):
            torch.testing.assert_close(e1 - e0, (1 - d) * (p.detach() - e0),
                                       rtol=1e-4, atol=3e-7)
    assert state.step == 2 and state.opt_state.count == 2 and state.ema.step == 2
