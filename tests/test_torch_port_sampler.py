"""The port's diffusion schedule, PNDM sampler and generation engine against the
JAX package, on the CPU at the tiny config in fp32: the host plan row for row,
the guidance table in all 8 modes, the dense mutual gather, the whole
CFG + mutual + history + PNDM loop (against JAX's `build_sampler` and the
committed torch-oracle trajectories that the JAX package also matches), and
the decode to uint8."""
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.core.config import ModelConfig
from difashion_tpu.diffusion import pndm as jpndm
from difashion_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from difashion_tpu.engine import generate as jgen
from difashion_tpu_torch.config import SchedulerConfig
from difashion_tpu_torch.diffusion import pndm as tpndm
from difashion_tpu_torch.diffusion.schedule import DiffusionSchedule
from difashion_tpu_torch.engine import generate as tgen

from golden_oracle import oracle
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


def test_later_schedulers_are_not_ported_yet(bundle):
    port = bundle[3]
    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    for name in ("ddim", "dpmpp"):
        with pytest.raises(NotImplementedError):
            tgen.build_sampler(port, num_inference_steps=4, spec=spec, eta=0.1,
                               scheduler=name)
    with pytest.raises(ValueError):
        tgen.build_sampler(port, num_inference_steps=4, spec=spec, eta=0.1,
                           scheduler="euler")
