"""A rank of the port's data-parallel checks under gloo on the CPU.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/_torch_dist_child.py <work dir>

Reads `<work dir>/inputs.pt` (the tiny model's weights, a global batch,
injected draws and generation inputs, written by
tests/test_torch_port_distributed.py) and writes `<work dir>/rank<r>.pt`:
the startup parameter check and its refusal, one train step of each
data-parallel case (plain, with accumulation, ZeRO-1 alone and with
accumulation, injected draws), the ZeRO-1 state gathered whole and its
checkpoint, and sharded generation. Imports torch and the port only.
"""
import os
import sys
import traceback

import numpy as np
import torch

CASES = {"ddp": (1, False), "ddp_k2": (2, False), "zero1": (1, True), "zero1_k2": (2, True),
         "injected": (1, False)}
TOWERS = ("unet", "vae", "text_encoder", "fashion_encoder")
SEED = 5


def train_config(k=1, **kw):
    from difashion_tpu_torch.config import TrainConfig

    return TrainConfig(learning_rate=1e-4, mixed_precision="no",
                       gradient_accumulation_steps=k, **kw)


def batch_of(arrays, device="cpu"):
    from difashion_tpu_torch.engine.train import TrainBatch

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}
    return TrainBatch(images=None, latent_mean=t["mean"], latent_logvar=t["logvar"],
                      input_ids=t["ids"].long(), hist_latents=t["hist"])


def host(tensors, names):
    return {n: t.detach().clone() for n, t in zip(names, tensors)}


def run_case(model, inp, dp, case, init):
    """One step of `case` from the initial weights: its loss, grad norm,
    parameters, state bytes, and (rank 0) the whole state."""
    from difashion_tpu_torch.checkpoint import CheckpointStore, snapshot
    from difashion_tpu_torch.core.distributed import host_shard
    from difashion_tpu_torch.engine import train as ttrain
    from difashion_tpu_torch.engine.memory import state_bytes

    k, zero1 = CASES[case]
    with torch.no_grad():
        for p, v in zip([p for _, p in model.trainable_parameters()], init):
            p.copy_(v)
    step, init_state = ttrain.build_train_step(model, train_config(k), dp=dp, zero1=zero1)
    state = init_state()
    batch = batch_of(host_shard(inp["batch"], dp.rank, dp.world))
    original = ttrain.difashion_loss
    if case == "injected":
        local = {k: torch.from_numpy(v) for k, v in
                 host_shard(inp["injected"], dp.rank, dp.world).items()}
        ttrain.difashion_loss = lambda model, mb, nl, nt, gen, cfg, injected=None, draws=None: \
            original(model, mb, nl, nt, gen, cfg, injected=local)
    try:
        state, m = step(state, batch, inp["null_latent"], inp["null_text"],
                        torch.Generator().manual_seed(SEED))
    finally:
        ttrain.difashion_loss = original
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "skipped": m["update_skipped"], "bytes": state_bytes(state),
           "params": host(state.params, state.names)}
    if zero1:
        try:
            snapshot(state)
        except ValueError as e:
            out["snapshot_refused"] = str(e)
    whole = ttrain.gather_zero1_state(state)
    if dp.rank == 0:
        out["mu"] = host(whole.opt_state.mu, state.names)
        out["nu"] = host(whole.opt_state.nu, state.names)
        out["ema"] = host(whole.ema.params, state.names)
        if case in ("ddp", "zero1"):
            CheckpointStore(os.path.join(inp["work"], f"ckpt_{case}")).save(whole, 1)
    return out


def sharded_generation(model, inp, dp):
    from difashion_tpu_torch.core.distributed import gather_rows
    from difashion_tpu_torch.engine import generate as tgen

    spec = tgen.make_guidance_spec(12.0, 4.0, 5.0)
    sampler = tgen.build_sampler(model, num_inference_steps=2, spec=spec, eta=0.1)
    out = {}
    for name, arrays in inp["gen"].items():
        inputs = tgen.GenerationInputs(*(torch.from_numpy(a) for a in arrays))
        local = tgen.shard_generation_inputs(inputs, dp.rank, dp.world)
        rows = sampler(local, dp=dp)
        out[name] = {"rows": int(rows.shape[0]),
                     "latents": gather_rows(rows, dp.world)[:inputs.init_latents.shape[0]]}
    # DDIM with eta > 0: the step noise of the global batch, each rank its rows
    inputs = tgen.GenerationInputs(*(torch.from_numpy(a) for a in inp["gen"]["gor"]))
    ddim = tgen.build_sampler(model, num_inference_steps=2, spec=spec, eta=0.1,
                              scheduler="ddim", ddim_eta=0.5)
    rows = ddim(tgen.shard_generation_inputs(inputs, dp.rank, dp.world),
                generator=torch.Generator().manual_seed(SEED), dp=dp)
    out["gor_ddim"] = {"rows": int(rows.shape[0]), "latents": gather_rows(rows, dp.world)}
    return out


def main(work):
    torch.set_num_threads(1)
    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.core import distributed
    from difashion_tpu_torch.engine.train import lr_schedule
    from difashion_tpu_torch.models.difashion import create_difashion

    dp = distributed.initialize_distributed("gloo", "cpu")
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    inp["work"] = work
    out = {"rank": dp.rank, "world": dp.world, "world_size": distributed.world_size(),
           "scale_lr": lr_schedule(train_config(scale_lr=True, train_batch_size=4))(0)}
    model = create_difashion(ModelConfig.tiny(), seed=dp.rank, device="cpu")
    model.load_state_dict(inp["weights"])
    distributed.check_same_parameters(model, TOWERS, dp.world)
    probe = model.fashion_encoder.mlp[0].bias
    kept = probe.detach().clone()
    with torch.no_grad():
        if dp.rank == 1:
            probe[0] += 1.0
        try:
            distributed.check_same_parameters(model, TOWERS, dp.world)
        except RuntimeError as e:
            out["refused"] = str(e)
        probe.copy_(kept)
    init = [p.detach().clone() for _, p in model.trainable_parameters()]
    for case in CASES:
        out[case] = run_case(model, inp, dp, case, init)
    with torch.no_grad():
        for p, v in zip([p for _, p in model.trainable_parameters()], init):
            p.copy_(v)
    model.eval()
    out["generation"] = sharded_generation(model, inp, dp)
    distributed.destroy()
    torch.save(out, os.path.join(work, f"rank{dp.rank}.pt"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    try:
        main(sys.argv[1])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
