"""The port's UNet and VAE in channels-last memory, on the CPU at the tiny
config: every conv weight and every input of a GroupNorm or a convolution is
channels-last contiguous on every path (the UNet, the VAE encode and decode,
the sampler, a train step, with and without gradient checkpointing, on
latent moments and on images), and the layout changes no number: the same
model converted to contiguous (NCHW) memory gives the same outputs, and the
weights' export, the checkpoint files and the 8-bit optimizer's blocks are
what they were for contiguous weights, byte for byte. Tolerance of the NCHW
comparison 1e-4 / 1e-4, as for the port's towers against JAX's: fp32
convolutions summed in another order, through a whole tower."""
import copy
import os

import numpy as np
import pytest
import torch
from torch import nn

from difashion_tpu_torch.checkpoint import CheckpointStore
from difashion_tpu_torch.config import ModelConfig, TrainConfig
from difashion_tpu_torch.engine.generate import (
    GenerationInputs,
    build_sampler,
    make_guidance_spec,
)
from difashion_tpu_torch.engine.optim8bit import AdamW8bit, quantize
from difashion_tpu_torch.engine.train import TrainBatch, build_train_step, difashion_loss
from difashion_tpu_torch.models.difashion import DiFashion, _init_, create_difashion
from difashion_tpu_torch.nn.layers import GroupNorm
from difashion_tpu_torch.weights import load_tower

TOL = dict(rtol=1e-4, atol=1e-4)
CL = torch.channels_last


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return create_difashion(ModelConfig.tiny(), seed=0, device="cpu")


def nchw_copy(m):
    """The same weights in contiguous (NCHW) memory."""
    return copy.deepcopy(m).to(memory_format=torch.contiguous_format)


class LayoutProbe:
    """Forward pre-hooks on every GroupNorm and Conv2d of `module`: the
    inputs that were not channels-last contiguous, by module name."""

    def __init__(self, module):
        self.seen, self.bad = 0, []
        self.hooks = [m.register_forward_pre_hook(self._hook(name))
                      for name, m in module.named_modules()
                      if isinstance(m, (GroupNorm, nn.Conv2d))]

    def _hook(self, name):
        def hook(mod, args):
            self.seen += 1
            if not args[0].is_contiguous(memory_format=CL):
                self.bad.append((name, tuple(args[0].shape), args[0].stride()))
        return hook

    def close(self):
        for h in self.hooks:
            h.remove()
        assert self.seen and not self.bad, self.bad[:5]


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def test_models_build_channels_last(model):
    for tower in (model.unet, model.vae):
        for name, p in tower.named_parameters():
            if p.dim() == 4:
                assert p.is_contiguous(memory_format=CL), name
    # the seeded init draws each weight in its logical order: the same values
    # as for contiguous weights
    with torch.device("meta"):
        other = DiFashion(ModelConfig.tiny())
    other = other.to(memory_format=torch.contiguous_format).to_empty(device="cpu")
    _init_(other, torch.Generator().manual_seed(0))
    got, want = model.state_dict(), other.eval().state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def _unet_inputs(cfg, b=2):
    s = cfg.unet.sample_size
    sample = _rand(b, s, s, cfg.unet.in_channels).permute(0, 3, 1, 2)   # an NHWC view
    return sample, torch.tensor([10, 500][:b]), _rand(b, 77, cfg.unet.cross_attention_dim, seed=1)


@pytest.mark.parametrize("path", ["unet", "encode", "decode"])
def test_towers_run_channels_last(model, path):
    """Every GroupNorm and convolution input channels-last; outputs
    channels-last and equal to the NCHW copy's."""
    cfg = model.config
    ref = nchw_copy(model)
    probe = LayoutProbe(model)
    with torch.no_grad():
        if path == "unet":
            args = _unet_inputs(cfg)
            got, want = model.unet(*args), ref.unet(args[0].contiguous(), *args[1:])
        elif path == "encode":
            x = _rand(2, cfg.vae.sample_size, cfg.vae.sample_size, 3).permute(0, 3, 1, 2)
            got, want = model.vae.encode(x).mean, ref.vae.encode(x.contiguous()).mean
        else:
            s = cfg.unet.sample_size
            z = _rand(2, s, s, cfg.vae.latent_channels).permute(0, 3, 1, 2)
            got, want = model.vae.decode(z), ref.vae.decode(z.contiguous())
    probe.close()
    # channels innermost (the encoder's mean is a channel slice of its moments)
    assert got.stride(1) == 1 and (path == "encode" or got.is_contiguous(memory_format=CL))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_sampler_runs_channels_last(model):
    cfg = model.config
    F, s, C = 2, cfg.unet.sample_size, cfg.vae.latent_channels
    D = cfg.unet.cross_attention_dim
    inputs = GenerationInputs(
        init_latents=_rand(F, s, s, C), outfit_idx=torch.zeros(F, dtype=torch.long),
        known_latents=_rand(1, F, s, s, C, seed=1) * 0.2, gen_mask=torch.ones(1, F, dtype=bool),
        gen_index=torch.arange(F).view(1, F), hist_latents=_rand(F, s, s, C, seed=2) * 0.2,
        cate_text=_rand(F, 77, D, seed=3), null_text=_rand(77, D, seed=4),
        null_latent=_rand(s, s, C, seed=5) * 0.05)
    outs = []
    for m in (model, nchw_copy(model)):
        probe = LayoutProbe(m.unet) if m is model else None
        sampler = build_sampler(m, num_inference_steps=3, spec=make_guidance_spec(12.0, 4.0, 5.0),
                                eta=0.1)
        outs.append(sampler(inputs))
        if probe is not None:
            probe.close()
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **TOL)


@pytest.mark.parametrize("images,checkpointing", [(False, False), (False, True), (True, False)])
def test_train_step_runs_channels_last(images, checkpointing):
    """One training loss and its backward (the GroupNorm backward recomputes
    the plain version; a checkpointed block recomputes its forward in the
    backward, under the same hooks): channels-last throughout, the loss and
    the gradients equal to the NCHW copy's."""
    cfg = ModelConfig.tiny()
    tc = TrainConfig(mixed_precision="no", gradient_checkpointing=checkpointing)
    B, olen, s, C = tc.train_batch_size, 4, cfg.unet.sample_size, cfg.vae.latent_channels
    batch = TrainBatch(
        images=_rand(B, olen, cfg.vae.sample_size, cfg.vae.sample_size, 3).clamp(-1, 1)
        if images else None,
        latent_mean=None if images else _rand(B, olen, s, s, C),
        latent_logvar=None if images else _rand(B, olen, s, s, C, seed=1) - 6.0,
        input_ids=torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.text.vocab_size, (B, olen, 77))),
        hist_latents=_rand(B, olen, s, s, C, seed=3) * 0.3)
    results = []
    for layout in ("channels_last", "nchw"):
        model = create_difashion(cfg, seed=0, device="cpu")
        if layout == "nchw":
            model = model.to(memory_format=torch.contiguous_format)
        build_train_step(model, tc)[1]()        # the trainable split, checkpointing
        probe = LayoutProbe(model) if layout == "channels_last" else None
        with torch.no_grad():
            null_text = model.encode_text(torch.zeros(1, 77, dtype=torch.long))[0]
        loss, _ = difashion_loss(model, batch, _rand(s, s, C, seed=4) * 0.05, null_text,
                                 torch.Generator().manual_seed(7), tc)
        loss.backward()
        if probe is not None:
            probe.close()
        results.append((loss.detach(), [p.grad.clone() for _, p in model.trainable_parameters()
                                        if p.grad is not None]))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), **TOL)
    assert len(g0) == len(g1) > 0
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))


def test_weights_export_and_import_keep_their_bytes(model):
    """The state dict of a channels-last tower, exported as numpy arrays, is
    byte for byte that of its NCHW copy; loading it into a fresh model gives
    the same values and keeps that model's channels-last layout."""
    ref = nchw_copy(model)
    for tower in ("unet", "vae"):
        exported = {k: np.ascontiguousarray(v.numpy())
                    for k, v in getattr(model, tower).state_dict().items()}
        before = {k: v.numpy() for k, v in getattr(ref, tower).state_dict().items()}
        assert exported.keys() == before.keys()
        assert all(exported[k].tobytes() == before[k].tobytes() for k in before)
        fresh = create_difashion(model.config, seed=1, device="cpu")
        load_tower(getattr(fresh, tower), exported, tower)
        for k, v in getattr(fresh, tower).state_dict().items():
            assert torch.equal(v, getattr(model, tower).state_dict()[k]), k
            if v.dim() == 4:
                assert v.is_contiguous(memory_format=CL), k


def test_checkpoint_files_keep_their_bytes(tmp_path):
    """A checkpoint of a channels-last model holds contiguous tensors, the
    bytes an NCHW model saves; restoring it gives the same values in the
    template's channels-last tensors."""
    cfg = ModelConfig.tiny()
    model = create_difashion(cfg, seed=0, device="cpu")
    state = build_train_step(model, TrainConfig())[1]()
    with torch.no_grad():
        for p in state.params:
            p.add_(0.5)
        state.opt_state.mu[0].add_(1.0)
    store = CheckpointStore(str(tmp_path))
    store.save(state, 3)
    store.save_frozen({t: getattr(model, t).state_dict() for t in ("vae", "text_encoder")})
    saved = torch.load(os.path.join(store.ckpt_path(3), "trainable.pt"), weights_only=True)
    frozen = torch.load(os.path.join(str(tmp_path), "frozen.pt"), weights_only=True)
    four_d = 0
    for name, p in zip(state.names, state.params):
        assert saved[name].is_contiguous() and torch.equal(saved[name], p), name
        four_d += p.dim() == 4
    assert four_d > 0
    assert all(v.is_contiguous() and torch.equal(v, model.vae.state_dict()[k])
               for k, v in frozen["vae"].items())
    fresh = create_difashion(cfg, seed=1, device="cpu")
    template = build_train_step(fresh, TrainConfig())[1]()
    restored = store.load(template, 3)
    for a, b in zip(restored.params, state.params):
        assert torch.equal(a, b)
        if a.dim() == 4:
            assert a.is_contiguous(memory_format=CL)
    assert torch.equal(restored.opt_state.mu[0], state.opt_state.mu[0])


def test_8bit_blocks_follow_the_logical_order():
    """The 8-bit optimizer's blocks cover a channels-last weight's elements
    in their logical order: the same codes, scales and update as for the
    contiguous weight."""
    w = _rand(8, 6, 3, 3)
    g = _rand(8, 6, 3, 3, seed=1)
    q_cl, s_cl = quantize(w.contiguous(memory_format=CL))
    q, s = quantize(w)
    assert torch.equal(q_cl, q) and torch.equal(s_cl, s)
    opt = AdamW8bit(lambda count: 1e-2)
    params = [w.clone().contiguous(memory_format=CL), w.clone()]
    for p in params:
        opt.update_([p], [g.clone()], opt.init([p]))
    assert torch.equal(params[0], params[1])
