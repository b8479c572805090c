"""The port's diffusion schedule, samplers (PNDM, DDIM, DPM-Solver++) and
generation engine against the JAX package, on the CPU at the tiny config in
fp32: the host plans row for row, single steps, the plan properties of
tests/test_diffusion.py (DDIM and DPM++ recover x0 under a perfect model, the
DPM++ plan against the stateful reference, v-prediction against epsilon, the
refusals), the guidance table in all 8 modes, the dense mutual gather, the
whole CFG + mutual + history loop (against JAX's `build_sampler` and the
committed torch-oracle trajectories that the JAX package also matches, with
JAX's own noise fed to DDIM at eta > 0), the padding of the inputs, and the
decode to uint8."""
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.core.config import ModelConfig
from difashion_tpu.diffusion import ddim as jddim
from difashion_tpu.diffusion import dpmpp as jdpmpp
from difashion_tpu.diffusion import pndm as jpndm
from difashion_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from difashion_tpu.engine import generate as jgen
from difashion_tpu_torch.config import SchedulerConfig
from difashion_tpu_torch.diffusion import ddim as tddim
from difashion_tpu_torch.diffusion import dpmpp as tdpmpp
from difashion_tpu_torch.diffusion import pndm as tpndm
from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule
from difashion_tpu_torch.engine import generate as tgen

from golden_oracle import oracle
from test_diffusion import StatefulDPMpp2M, _fake_model
from test_sampler_golden import CASES, _problem
from test_torch_port_models import jax_bundle, port_from_jax
from test_torch_port_models import one_torch_thread  # noqa: F401  (autouse fixture)

# fp32 whole-loop accumulation with CFG scale 12: the bound of
# tests/test_sampler_golden.py
LOOP_TOL = dict(rtol=5e-4, atol=2e-4)


@pytest.fixture(scope="module")
def bundle():
    cfg, model, params = jax_bundle()
    return cfg, model, params, port_from_jax(cfg, params)


def _port_inputs(inputs):
    return tgen.GenerationInputs(*(torch.from_numpy(np.array(a)) for a in inputs))


def test_schedule_tables_match_jax():
    ours = DiffusionSchedule.create(SchedulerConfig())
    theirs = JSchedule.create(ModelConfig().scheduler)
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    assert ours.final_alpha_cumprod == theirs.final_alpha_cumprod


@pytest.mark.parametrize("steps", [1, 2, 4, 20, 50, 100])
def test_pndm_plan_matches_jax_row_for_row(steps):
    ours = tpndm.make_pndm_plan(DiffusionSchedule.create(SchedulerConfig()), steps)
    theirs = jpndm.make_pndm_plan(JSchedule.create(ModelConfig().scheduler), steps)
    # one step has no corrector iteration
    assert len(ours) == len(theirs) == (1 if steps == 1 else steps + 1)
    for name in ("t_unet", "alpha_t", "alpha_prev", "ets_coeffs", "cm", "append",
                 "use_cur", "save_cur"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_pndm_steps_match_jax(pred):
    sched = DiffusionSchedule.create(SchedulerConfig())
    plan = tpndm.make_pndm_plan(sched, 8)
    jrows = jpndm.make_pndm_plan(JSchedule.create(ModelConfig().scheduler), 8).rows()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 3, 3).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate = jpndm.pndm_init_state(x.shape)
    tstate = tpndm.pndm_init_state(tx)
    for i in range(len(plan)):
        eps = rng.randn(*x.shape).astype(np.float32)
        jstate, jx = jpndm.pndm_step(jstate, {k: v[i] for k, v in jrows.items()},
                                     jnp.asarray(eps), jx, prediction_type=pred)
        tstate, tx = tpndm.pndm_step(tstate, plan.row(i), torch.from_numpy(eps), tx,
                                     prediction_type=pred)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)


MODES = list(itertools.product([12.0, 1.0], [4.0, 1.0], [5.0, 1.0], [True, False],
                               [True, False]))


def test_guidance_spec_matches_jax_in_every_mode():
    seen = set()
    for cs, hs, ms, uh, um in MODES:
        ours = tgen.make_guidance_spec(cs, hs, ms, use_history=uh, use_mutual=um)
        theirs = jgen.make_guidance_spec(cs, hs, ms, use_history=uh, use_mutual=um)
        for name in ("hist_sel", "mutual_sel", "text_sel", "weights"):
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        seen.add((cs > 1, uh and hs > 1, um and ms > 1))
    assert len(seen) == 8


def test_mutual_condition_input_matches_jax():
    rng = np.random.RandomState(1)
    B, olen, s, C = 3, 4, 5, 4
    gen_mask = rng.rand(B, olen) < 0.5
    gen_mask[:, 0] = True
    fills = [(b, j) for b in range(B) for j in range(olen) if gen_mask[b, j]]
    gen_index = np.zeros((B, olen), np.int32)
    for k, (b, j) in enumerate(fills):
        gen_index[b, j] = k
    outfit_idx = np.array([b for b, _ in fills], np.int32)
    lat = rng.randn(len(fills), s, s, C).astype(np.float32)
    known = rng.randn(B, olen, s, s, C).astype(np.float32)
    args = (lat, outfit_idx, known, gen_mask, gen_index)
    want = np.asarray(jgen.mutual_condition_input(*map(jnp.asarray, args)))
    got = tgen.mutual_condition_input(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _fixture_cases():
    for mode, B, steps, cs, hs, ms, uh, um in CASES:
        yield (f"sampler_{mode}_B{B}_s{steps}_cs{cs}_hs{hs}_ms{ms}_uh{uh}_um{um}",
               mode, B, steps, zlib.crc32(repr((mode, steps)).encode()) % 997,
               (cs, hs, ms, uh, um))
    yield ("sampler_gor_s50_full_cfg", "gor", 1, 50, 31, (12.0, 4.0, 5.0, True, True))


@pytest.mark.parametrize("name,mode,B,steps,seed,guidance", list(_fixture_cases()))
def test_whole_loop_matches_torch_oracle(bundle, name, mode, B, steps, seed, guidance):
    cfg, model, params, port = bundle
    inputs, _ = _problem(cfg, model, params, mode, B, seed=seed)
    cs, hs, ms, uh, um = guidance
    spec = tgen.make_guidance_spec(cs, hs, ms, use_history=uh, use_mutual=um)
    sampler = tgen.build_sampler(port, num_inference_steps=steps, spec=spec, eta=0.1,
                                 return_trajectory=True)
    final, traj = sampler(_port_inputs(inputs))

    def missing():
        raise AssertionError(f"committed fixture {name} is missing")
    ref = oracle(name, missing)["traj"]
    assert traj.shape == ref.shape and traj.shape[0] == steps + 1
    assert torch.equal(final, traj[-1])
    for i in range(ref.shape[0]):
        np.testing.assert_allclose(traj[i].numpy(), ref[i], **LOOP_TOL,
                                   err_msg=f"diverged at iteration {i}")


@pytest.mark.parametrize("mode,B", [("fitb", 2), ("gor", 1)])
def test_whole_loop_matches_jax_sampler(bundle, mode, B):
    cfg, model, params, port = bundle
    inputs, _ = _problem(cfg, model, params, mode, B, seed=101 + B)
    jspec = jgen.make_guidance_spec(12.0, 4.0, 5.0)
    _, want = jax.jit(jgen.build_sampler(model, num_inference_steps=20, spec=jspec,
                                         eta=0.1, return_trajectory=True))(params, inputs)
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    _, got = tgen.build_sampler(port, num_inference_steps=20, spec=spec, eta=0.1,
                                return_trajectory=True)(_port_inputs(inputs))
    want = np.asarray(want)
    assert got.shape == want.shape == (21,) + tuple(inputs.init_latents.shape)
    for i in range(want.shape[0]):
        np.testing.assert_allclose(got[i].numpy(), want[i], **LOOP_TOL,
                                   err_msg=f"diverged at iteration {i}")


def test_decode_to_uint8_matches_jax(bundle):
    _, model, params, port = bundle
    lat = (np.random.RandomState(2).randn(3, 8, 8, 4) * 1.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jgen.decode_to_uint8(model, p, x))(
        params, jnp.asarray(lat)))
    got = tgen.decode_to_uint8(port, torch.from_numpy(lat)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 64, 64, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # fp32 sums in another order move a value across a rounding boundary
    # now and then: such pixels differ by 1 and stay rare
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    imgs = tgen.decode_and_postprocess(port, torch.from_numpy(lat))
    assert imgs.dtype == torch.float32 and 0.0 <= imgs.min() and imgs.max() <= 1.0


def test_unknown_scheduler_raises(bundle):
    port = bundle[3]
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    with pytest.raises(ValueError, match="unknown scheduler"):
        tgen.build_sampler(port, num_inference_steps=4, spec=spec, eta=0.1,
                           scheduler="euler")


# ---- DDIM and DPM-Solver++ ----------------------------------------------------

def _scheds():
    return DiffusionSchedule.create(SchedulerConfig()), JSchedule.create(ModelConfig().scheduler)


@pytest.mark.parametrize("steps", [1, 20, 50])
def test_ddim_plan_matches_jax_row_for_row(steps):
    ours, theirs = _scheds()
    a, b = tddim.make_ddim_plan(ours, steps, eta=0.3), jddim.make_ddim_plan(theirs, steps, 0.3)
    assert len(a) == len(b) == steps and a.eta == b.eta
    for name in ("t_unet", "alpha_t", "alpha_prev"):
        assert getattr(a, name).dtype == getattr(b, name).dtype
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("steps,spacing", [(2, "linspace"), (8, "linspace"), (20, "linspace"),
                                           (1000, "linspace"), (20, "leading")])
def test_dpmpp_plan_matches_jax_row_for_row(steps, spacing):
    ours, theirs = _scheds()
    a = tdpmpp.make_dpmpp_plan(ours, steps, spacing)
    b = jdpmpp.make_dpmpp_plan(theirs, steps, spacing)
    assert len(a) == len(b) == steps
    for name in ("t_unet", "alpha_t", "sigma_t", "c_x", "c_d", "d0", "d1"):
        assert getattr(a, name).dtype == getattr(b, name).dtype
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_steps_match_jax(pred, eta):
    ours, theirs = _scheds()
    plan = tddim.make_ddim_plan(ours, 6, eta)
    jrows = jddim.make_ddim_plan(theirs, 6, eta).rows()
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 3, 3).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(len(plan)):
        eps, noise = (rng.randn(*x.shape).astype(np.float32) for _ in range(2))
        jx = jddim.ddim_step({k: v[i] for k, v in jrows.items()}, jnp.asarray(eps), jx,
                             eta=eta, noise=jnp.asarray(noise), prediction_type=pred)
        tx = tddim.ddim_step(plan.row(i), torch.from_numpy(eps), tx, eta=eta,
                             noise=torch.from_numpy(noise), prediction_type=pred)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_dpmpp_steps_match_jax(pred):
    ours, theirs = _scheds()
    plan = tdpmpp.make_dpmpp_plan(ours, 8)
    jrows = jdpmpp.make_dpmpp_plan(theirs, 8).rows()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 3, 3).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = jdpmpp.dpmpp_init_state(x.shape), tdpmpp.dpmpp_init_state(tx)
    for i in range(len(plan)):
        eps = rng.randn(*x.shape).astype(np.float32)
        jstate, jx = jdpmpp.dpmpp_step(jstate, {k: v[i] for k, v in jrows.items()},
                                       jnp.asarray(eps), jx, prediction_type=pred)
        tstate, tx = tdpmpp.dpmpp_step(tstate, plan.row(i), torch.from_numpy(eps), tx,
                                       prediction_type=pred)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)


def test_ddim_recovers_x0_under_a_perfect_model():
    """One step from t to the final alpha inverts add_noise at eta 0."""
    sched = _scheds()[0]
    rng = np.random.RandomState(7)
    x0 = np.clip(rng.randn(2, 4, 4, 4) * 0.5, -1, 1).astype(np.float32)
    eps = rng.randn(2, 4, 4, 4).astype(np.float32)
    plan = tddim.make_ddim_plan(sched, 1)
    t = plan.t_unet[0]
    xt = sched.add_noise(torch.from_numpy(x0), torch.from_numpy(eps), torch.tensor([t, t]))
    out = tddim.ddim_step(plan.row(0), torch.from_numpy(eps), xt).numpy()
    a_prev = plan.alpha_prev[0]
    np.testing.assert_allclose(out, np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev) * eps,
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="noise"):
        tddim.ddim_step(plan.row(0), torch.from_numpy(eps), xt, eta=0.5)


@pytest.mark.parametrize("n_steps", [8, 20])
def test_dpmpp_plan_matches_stateful_reference(n_steps):
    sched = _scheds()[0]
    rng = np.random.RandomState(1)
    x_ref = rng.randn(2, 4, 4, 4)
    x = torch.from_numpy(x_ref.astype(np.float32))
    ref = StatefulDPMpp2M(sched, n_steps)
    plan = tdpmpp.make_dpmpp_plan(sched, n_steps)
    np.testing.assert_array_equal(plan.t_unet, ref.timesteps)
    state = tdpmpp.dpmpp_init_state(x)
    for i in range(len(plan)):
        t = int(plan.t_unet[i])
        eps = _fake_model(x.double().numpy(), t)
        state, x = tdpmpp.dpmpp_step(state, plan.row(i), torch.from_numpy(eps).float(), x)
        x_ref = ref.step(_fake_model(x_ref, t), t, x_ref)
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=3e-4, atol=3e-5)


def test_dpmpp_v_prediction_matches_epsilon_run():
    sched = _scheds()[0]
    plan = tdpmpp.make_dpmpp_plan(sched, 10)
    x_eps = torch.from_numpy(np.random.RandomState(2).randn(3, 5).astype(np.float32))
    x_v = x_eps
    st_e, st_v = tdpmpp.dpmpp_init_state(x_eps), tdpmpp.dpmpp_init_state(x_v)
    for i in range(len(plan)):
        row = plan.row(i)
        eps = torch.from_numpy(_fake_model(x_eps.numpy(), row["t_unet"])).float()
        x0 = (x_eps - row["sigma_t"] * eps) / row["alpha_t"]
        v = row["alpha_t"] * eps - row["sigma_t"] * x0
        st_e, x_eps = tdpmpp.dpmpp_step(st_e, row, eps, x_eps)
        st_v, x_v = tdpmpp.dpmpp_step(st_v, row, v, x_v, prediction_type="v_prediction")
        np.testing.assert_allclose(x_v.numpy(), x_eps.numpy(), rtol=1e-5, atol=1e-5)


def test_dpmpp_recovers_x0_under_a_perfect_model():
    sched = _scheds()[0]
    x0_true = np.array([0.3, -1.0, 0.8])
    acp = np.asarray(sched.alphas_cumprod, np.float64)
    plan = tdpmpp.make_dpmpp_plan(sched, 12)
    x = torch.tensor([2.0, 0.5, -0.7])
    state = tdpmpp.dpmpp_init_state(x)
    for i in range(len(plan)):
        t = int(plan.t_unet[i])
        eps = (x.double().numpy() - np.sqrt(acp[t]) * x0_true) / np.sqrt(1.0 - acp[t])
        state, x = tdpmpp.dpmpp_step(state, plan.row(i), torch.from_numpy(eps).float(), x)
    np.testing.assert_allclose(x.numpy(), x0_true, rtol=1e-4, atol=1e-4)


def test_dpmpp_refusals():
    sched = _scheds()[0]
    T = sched.num_train_timesteps
    with pytest.raises(ValueError):
        tdpmpp.make_dpmpp_plan(sched, T + 1)
    with pytest.raises(ValueError):
        tdpmpp.make_dpmpp_plan(sched, 1)
    with pytest.raises(ValueError, match="exceeds num_train_timesteps"):
        tdpmpp.make_dpmpp_plan(sched, T, timestep_spacing="leading")
    with pytest.raises(ValueError, match="timestep_spacing"):
        tdpmpp.make_dpmpp_plan(sched, 8, timestep_spacing="trailing")
    plan = tdpmpp.make_dpmpp_plan(sched, T)
    for name in ("alpha_t", "sigma_t", "c_x", "c_d", "d0", "d1"):
        assert np.all(np.isfinite(getattr(plan, name))), name


@pytest.mark.parametrize("mode,B,steps,ddim_eta", [("gor", 1, 10, 0.0), ("fitb", 2, 10, 0.5)])
def test_whole_loop_ddim_matches_jax_sampler(bundle, mode, B, steps, ddim_eta):
    """DDIM through the whole loop; at eta > 0 the port takes the step noise
    that JAX's sampler draws from its rng."""
    cfg, model, params, port = bundle
    inputs, _ = _problem(cfg, model, params, mode, B, seed=71 + B)
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    rng = jax.random.PRNGKey(5)
    _, want = jax.jit(jgen.build_sampler(model, num_inference_steps=steps, spec=spec, eta=0.1,
                                         scheduler="ddim", ddim_eta=ddim_eta,
                                         return_trajectory=True))(params, inputs, rng)
    sampler = tgen.build_sampler(port, num_inference_steps=steps, spec=spec, eta=0.1,
                                 scheduler="ddim", ddim_eta=ddim_eta, return_trajectory=True)
    noise = None
    if ddim_eta > 0:
        noise = torch.from_numpy(np.array(jax.random.normal(
            rng, (steps,) + tuple(inputs.init_latents.shape), jnp.float32)))
        with pytest.raises(ValueError, match="generator or the step noise"):
            sampler(_port_inputs(inputs))
    _, got = sampler(_port_inputs(inputs), step_noise=noise)
    want = np.asarray(want)
    assert got.shape == want.shape == (steps,) + tuple(inputs.init_latents.shape)
    for i in range(steps):
        np.testing.assert_allclose(got[i].numpy(), want[i], **LOOP_TOL,
                                   err_msg=f"diverged at iteration {i}")


def test_whole_loop_dpmpp_matches_jax_sampler(bundle):
    cfg, model, params, port = bundle
    inputs, _ = _problem(cfg, model, params, "fitb", 2, seed=61)
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    _, want = jax.jit(jgen.build_sampler(model, num_inference_steps=8, spec=spec, eta=0.1,
                                         scheduler="dpmpp", return_trajectory=True))(
        params, inputs)
    _, got = tgen.build_sampler(port, num_inference_steps=8, spec=spec, eta=0.1,
                                scheduler="dpmpp", return_trajectory=True)(_port_inputs(inputs))
    want = np.asarray(want)
    assert got.shape == want.shape
    for i in range(want.shape[0]):
        np.testing.assert_allclose(got[i].numpy(), want[i], **LOOP_TOL,
                                   err_msg=f"diverged at iteration {i}")


@pytest.mark.parametrize("mode,steps", [("fitb", 8), ("gor", 20)])
def test_whole_loop_dpmpp_matches_torch_oracle(bundle, mode, steps):
    """The fast-serving loop against `sampler_dpmpp_{fitb_s8,gor_s20}.npz`,
    the stateful DPM-Solver++ oracle's trajectories (inputs as
    tests/test_sampler_golden.py builds them)."""
    cfg, model, params, port = bundle
    B = 2 if mode == "fitb" else 1
    inputs, _ = _problem(cfg, model, params, mode, B, seed=53 + steps)
    sampler = tgen.build_sampler(port, num_inference_steps=steps,
                                 spec=tgen.make_guidance_spec(12.0, 4.0, 5.0), eta=0.1,
                                 scheduler="dpmpp", return_trajectory=True)
    final, traj = sampler(_port_inputs(inputs))
    name = f"sampler_dpmpp_{mode}_s{steps}"

    def missing():
        raise AssertionError(f"committed fixture {name} is missing")
    ref = oracle(name, missing)["traj"]
    assert traj.shape == ref.shape and traj.shape[0] == steps
    assert torch.equal(final, traj[-1])
    for i in range(ref.shape[0]):
        np.testing.assert_allclose(traj[i].numpy(), ref[i], **LOOP_TOL,
                                   err_msg=f"diverged at iteration {i}")


def test_pad_generation_inputs_matches_jax(bundle):
    cfg, model, params, _ = bundle
    inputs, _ = _problem(cfg, model, params, "fitb", 2, seed=9)
    want = jgen.pad_generation_inputs(inputs, 4)
    got = tgen.pad_generation_inputs(_port_inputs(inputs), 4)
    for name, a, b in zip(want._fields, got, want):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    same = _port_inputs(inputs)
    assert tgen.pad_generation_inputs(same, 1) is same
