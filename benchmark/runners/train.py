"""Runner `train`: the program's training step (`engine/train.py::
build_train_step`) under the cell's recipe, fed from latent moments made
from the seed.

Set-up builds the program's model in fp32 master weights from the
benchmark's seeded weights (through its loader), the step and its state,
and drives that same state through the first `check.steps` steps of the
feed through the step's own call: those steps warm every shape and are the
ones the reference follows from the seed. What the check compares is read
from the state then: each step's loss, each parameter's gradient as the
optimizer got it (from AdamW's first moment after step 1: mu = (1 - b1) g),
and each parameter's change and its EMA's change after the last of them.
The window goes on from there with the same state and the next steps of
the feed; train_images_per_s counts whole steps' rows over the time from
the window's start to the synchronisation after its last step. A traced run
calls what `train_step` composes (`accumulate_gradients`,
`apply_gradients`, the loss mean) under spans of its own.

After the window (and a traced run's profiled steps) the state's counters
of steps taken are held to the calls made, and the state as it stands is
copied and takes one more step of the feed through the step's own call:
its loss, its gradient ((mu' - b1 mu) / (1 - b1)) and each parameter's and
EMA's change, read as above. The reference takes that step from the
copies, so a step that goes wrong only after set-up shows.

The check, after the peak is read and the program freed: the plain fp32
reference takes the first steps from the same weights, batches and draws,
and the step after the window from the copied state, the generator in the
same state; each number's gap (below) is held to the cell's limit.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark.core import traffic as traffic_mod
from benchmark.core.harness import Check, Run
from benchmark.core.weights import make_tower, make_weights, reference_towers

TRAINABLE = ("unet", "fashion_encoder")


@dataclass
class Readings:
    """What the check compares, read from a run of the step (the program's
    or the reference's): per parameter name."""

    losses: List[float] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)      # |g| at step 1, clipped
    change: Dict[str, float] = field(default_factory=dict)    # |p_k - p_0| after k steps
    ema_change: Dict[str, float] = field(default_factory=dict)


@dataclass
class State:
    model: object
    step_fn: object
    state: object
    traffic: traffic_mod.TrainTraffic
    generator: object
    null_latent: object
    null_text: object
    readings: Readings
    next_step: int = 0


@dataclass
class Late:
    """The state as the window left it (copies on the device, in the order
    of `names`), where the step after the window starts (the feed's step,
    AdamW's updates, the generator's state), how far the state's counters
    of steps taken lagged the calls made, and the program's readings of
    that step."""

    names: List[str]
    step: int
    count: int
    gen_state: object
    params: Optional[list]
    mu: Optional[list]
    nu: Optional[list]
    ema: Optional[list]
    uncounted: int
    readings: Readings = field(default_factory=Readings)

    def drop_copies(self) -> None:
        self.params = self.mu = self.nu = self.ema = None


def gen_seed(seed: int) -> int:
    return (int(seed) * 8 + 6) % (2 ** 63 - 1)


def train_config(run: Run):
    from difashion_tpu_torch.config import TrainConfig

    return TrainConfig(**run.workload["recipe"])


def _batch(tr, step, device):
    from difashion_tpu_torch.engine.train import TrainBatch

    b = tr.batch(step)
    return TrainBatch(images=None, latent_mean=b["latent_mean"],
                      latent_logvar=b["latent_logvar"], input_ids=b["input_ids"],
                      hist_latents=b["hist_latents"])


def setup(run: Run, fault=None) -> State:
    import torch

    from difashion_tpu_torch.config import Config
    from difashion_tpu_torch.engine.train import autocast, build_train_step
    from difashion_tpu_torch.models.difashion import DiFashion
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.weights import load_difashion

    w, mc = run.workload, run.model_cfg
    run.mark("imports")
    if run.device.startswith("cuda"):
        kernels.build_all(w["kernels"])
    run.mark("kernels")
    cfg = Config.from_dict({"model": mc})
    tcfg = train_config(run)
    with torch.device("meta"):
        model = DiFashion(cfg.model)
    model = model.to_empty(device=run.device)
    load_difashion(model, make_weights(mc, run.seed, run.device, torch.float32))
    step_fn, init_state = build_train_step(model, tcfg)
    state = init_state()
    run.mark("weights_and_state")
    s, c = mc["unet"]["sample_size"], mc["vae"]["latent_channels"]
    tr = traffic_mod.training(w["traffic"], run.seed, (s, s, c), run.device,
                              mc["text"]["vocab_size"])
    with torch.no_grad(), autocast(model, tcfg):
        null_text = model.encode_text(tr.ids_table[:1])[0].float()
    st = State(model, step_fn, state, tr, torch.Generator(device=run.device).manual_seed(
        gen_seed(run.seed)), tr.null_latent, null_text, Readings())
    run.mark("traffic")
    if fault is not None:
        fault(st)
    first_steps(run, st)
    run.mark("first_steps")
    return st


def first_steps(run: Run, st: State) -> None:
    """The check's steps through the step's own call; the readings after
    step 1 (gradients) and after the last (changes against the weights of
    the seed, made again)."""
    import torch

    r, n = st.readings, run.workload["check"]["steps"]
    b1 = run.workload["recipe"].get("adam_beta1", 0.9)
    for _ in range(n):
        _, m = st.step_fn(st.state, _batch(st.traffic, st.next_step, run.device),
                          st.null_latent, st.null_text, st.generator)
        st.next_step += 1
        r.losses.append(float(m["loss"]))
        if st.next_step == 1:
            norms = torch._foreach_norm(st.state.opt_state.mu)
            r.grad = {k: float(v) / (1 - b1) for k, v in zip(st.state.names, norms)}
    r.change, r.ema_change = changes(run, st.state.names, st.state.params,
                                     st.state.ema.params if st.state.ema else None)


def changes(run: Run, names, params, ema):
    """|p - p_0| and |ema - p_0| per parameter, p_0 the seed's weights made
    again one tower at a time."""
    import torch

    out, out_ema = {}, {}
    index = {k: i for i, k in enumerate(names)}
    for tower in TRAINABLE:
        start = make_tower(tower, run.model_cfg, run.seed, run.device, torch.float32)
        for key, p0 in start.items():
            i = index[f"{tower}.{key}"]
            out[names[i]] = float((params[i].detach() - p0).double().norm())
            if ema is not None:
                out_ema[names[i]] = float((ema[i] - p0).double().norm())
        del start
    return out, out_ema


def window(run: Run, st: State) -> None:
    from difashion_tpu_torch.engine.train import accumulate_gradients, apply_gradients
    from difashion_tpu_torch.nn import kernels

    import torch

    before = dict(kernels.LAUNCHES)
    tcfg = train_config(run)
    optimizer = None
    if run.trace:
        from difashion_tpu_torch.engine.train import make_optimizer

        # the step's own optimizer holds no state (AdamState lives in the
        # TrainState), so one made alike applies the same update
        optimizer = make_optimizer(tcfg)
    steps = 0
    with run.window(profile=False):
        start = time.perf_counter()
        while True:
            batch = _batch(st.traffic, st.next_step, run.device)
            if run.trace:
                with run.span("fwd_bwd"):
                    grads, losses = accumulate_gradients(
                        st.model, st.state.params, batch, st.null_latent, st.null_text,
                        st.generator, tcfg)
                with run.span("optimizer"):
                    apply_gradients(st.state, grads, optimizer, tcfg)
                    torch.stack(losses).mean()
            else:
                st.step_fn(st.state, batch, st.null_latent, st.null_text, st.generator)
            st.next_step += 1
            steps += 1
            if time.perf_counter() - start >= run.seconds:
                break
    launches = {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in kernels.LAUNCHES}
    # the device trace: more steps, profiled apart (the profiler slows the
    # host, which paces this step; the window's rate and spans stay clean)
    before = dict(kernels.LAUNCHES)
    traced = run.workload["trace_steps"] if run.trace else 0
    with run.profiled():
        for _ in range(traced):
            st.step_fn(st.state, _batch(st.traffic, st.next_step, run.device),
                       st.null_latent, st.null_text, st.generator)
            st.next_step += 1
    rows = run.workload["traffic"]["outfits_per_step"] * run.workload["traffic"][
        "items_per_outfit"]
    run.attempted = steps * rows
    run.end_to_end["train_images_per_s"] = steps * rows / run.window_s
    run.counts.update(steps=steps, rows=rows, launches=launches, traced_steps=traced,
                      trace_launches={k: kernels.LAUNCHES[k] - before.get(k, 0)
                                      for k in kernels.LAUNCHES})


def late_step(run: Run, st: State) -> Late:
    """The step after the window: the counters checked, the state copied,
    one step of the feed through the step's own call, its readings."""
    import torch

    s = st.state
    b1 = run.workload["recipe"].get("adam_beta1", 0.9)
    counters = (s.step, s.opt_state.count, s.ema.step)
    copy = lambda ts: [t.detach().clone() for t in ts]
    late = Late(list(s.names), st.next_step, s.opt_state.count, st.generator.get_state(),
                copy(s.params), copy(s.opt_state.mu), copy(s.opt_state.nu),
                copy(s.ema.params), max(abs(c - st.next_step) for c in counters))
    _, m = st.step_fn(s, _batch(st.traffic, st.next_step, run.device), st.null_latent,
                      st.null_text, st.generator)
    st.next_step += 1
    with torch.no_grad():
        norms = [[(s.opt_state.mu[i] - b1 * late.mu[i]).double().norm() / (1 - b1),
                  (s.params[i] - late.params[i]).double().norm(),
                  (s.ema.params[i] - late.ema[i]).double().norm()]
                 for i in range(len(late.names))]
        norms = torch.stack([torch.stack(n) for n in norms]).tolist()
    r = late.readings
    r.losses.append(float(m["loss"]))
    for k, (g, c, e) in zip(late.names, norms):
        r.grad[k], r.change[k], r.ema_change[k] = g, c, e
    return late


def work_counts(run: Run) -> None:
    """Per step: the UNet's forward, its backward (twice the forward's
    operations: the recipe keeps every activation, no recompute) and the
    MutualEncoder's alike, and the frozen text tower's forward."""
    from benchmark.core import work

    rows, steps = run.counts["rows"], run.counts["steps"]
    unet = work.unet_work(run.model_cfg, rows)
    mutual = work.mutual_work(run.model_cfg, rows)
    text = work.text_work(run.model_cfg, rows)
    run.counts["work"] = {"unet": (unet, run.counts["traced_steps"])}   # what the trace holds
    run.counts["flops"] = steps * (3 * (unet.flops + mutual.flops) + text.flops)


def free(st: State) -> None:
    import torch

    st.model = st.step_fn = st.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(run: Run, prec=None):
    """The reference's towers (the trainable ones training), its parameters
    by name in the reference's order, a Trainer over them and its encoding
    of the empty prompt."""
    import torch

    from benchmark.reference.sampling import hash_token_ids
    from benchmark.reference.training import RECIPE, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mc = run.model_cfg
    towers = reference_towers(mc, run.seed, run.device, torch.float32, prec,
                              towers=("unet", "fashion_encoder", "text_encoder"))
    named = [(f"{t}.{k}", p) for t in TRAINABLE for k, p in towers[t].named_parameters()]
    for t in TRAINABLE:
        towers[t].train().requires_grad_(True)
    trainer = Trainer(towers, mc, dict(RECIPE, **run.workload["recipe"]),
                      [p for _, p in named], block=1)
    null_text = towers["text_encoder"](torch.as_tensor(
        hash_token_ids([""], mc["text"]["vocab_size"]), device=run.device).long())[0]
    return named, trainer, null_text


def _reference_batch(run: Run, st: State, step: int, gen, rows_kept: Optional[int]):
    """The feed's batch `step` and its draws from `gen`; `rows_kept` (a
    fault for the control's readings) keeps that many outfits of each and
    the mean is taken over them."""
    from benchmark.reference.training import step_draws

    mc, t = run.model_cfg, run.workload["traffic"]
    s, c = mc["unet"]["sample_size"], mc["vae"]["latent_channels"]
    b = st.traffic.batch(step)
    draws = step_draws(gen, t["outfits_per_step"], t["items_per_outfit"], (c, s, s),
                       mc["mutual"]["hid_dim"], mc["scheduler"]["num_train_timesteps"],
                       run.device)
    if rows_kept is not None:
        olen = t["items_per_outfit"]
        b = {k: v[:rows_kept] for k, v in b.items()}
        draws = {k: v[:rows_kept] if k == "t" else v[:rows_kept * olen]
                 for k, v in draws.items()}
    return b, draws


def reference_readings(run: Run, st: State, prec=None, rows_kept: Optional[int] = None
                       ) -> Readings:
    """The reference's readings over the first steps: the same weights,
    batches and draws (the generator seeded alike)."""
    import torch

    named, trainer, null_text = _reference(run, prec)
    gen = torch.Generator(device=run.device).manual_seed(gen_seed(run.seed))
    r = Readings()
    start = {k: p.detach().clone() for k, p in named}
    for step in range(run.workload["check"]["steps"]):
        b, draws = _reference_batch(run, st, step, gen, rows_kept)
        loss, grads = trainer.step(b, draws, st.null_latent, null_text)
        r.losses.append(loss)
        if step == 0:
            r.grad = {k: float(g.double().norm()) for (k, _), g in zip(named, grads)}
    for (k, p), e in zip(named, trainer.ema):
        r.change[k] = float((p.detach() - start[k]).double().norm())
        r.ema_change[k] = float((e - start[k]).double().norm())
    return r


def reference_late(run: Run, st: State, late: Late, prec=None,
                   rows_kept: Optional[int] = None) -> Readings:
    """The reference's readings of the step after the window, taken from the
    program's state as the window left it (`late`'s copies: how many steps
    the window takes depends on the card, and the first steps, the start
    from the seed, are checked by `reference_readings`): the same step of
    the feed, the generator in the same state."""
    import torch

    named, trainer, null_text = _reference(run, prec)
    index = {k: i for i, k in enumerate(late.names)}
    order = [index[k] for k, _ in named]
    with torch.no_grad():
        for (_, p), i in zip(named, order):
            p.copy_(late.params[i])
    trainer.resume(late.count, [late.mu[i] for i in order], [late.nu[i] for i in order],
                   [late.ema[i] for i in order])
    gen = torch.Generator(device=run.device)
    gen.set_state(late.gen_state)
    b, draws = _reference_batch(run, st, late.step, gen, rows_kept)
    loss, grads = trainer.step(b, draws, st.null_latent, null_text)
    r = Readings(losses=[loss])
    for (k, p), g, e, i in zip(named, grads, trainer.ema, order):
        r.grad[k] = float(g.double().norm())
        r.change[k] = float((p.detach() - late.params[i]).double().norm())
        r.ema_change[k] = float((e - late.ema[i]).double().norm())
    return r


def leaf_gaps(prog: Readings, ref: Readings, name: str, floor: float = 1e-3
              ) -> Dict[str, float]:
    """Per parameter, for `name` (grad, change or ema_change): the gap
    between the program's norm and the reference's, against the larger of
    the reference's norm of that parameter and of the median parameter.
    Parameters whose reference gradient is under `floor` times the median
    parameter's (moved by round-off alone under Adam) are left out."""
    med_g = float(np.median(list(ref.grad.values())))
    kept = [k for k, v in ref.grad.items() if v >= floor * med_g]
    p, q = getattr(prog, name), getattr(ref, name)
    med = float(np.median([q[k] for k in kept]))
    return {k: abs(p[k] - q[k]) / max(q[k], med) for k in kept}


def gaps(prog: Readings, ref: Readings, leaf=max, tag: str = "leaf",
         names=("grad", "change", "ema_change")) -> Dict[str, float]:
    """The compared numbers. loss: the largest relative gap of a step's
    loss. Each of `names`: `leaf` (the largest, or the median) of the
    parameters' gaps."""
    out = {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses))}
    for name in names:
        out[f"{name}_{tag}_gap"] = float(leaf(list(leaf_gaps(prog, ref, name).values())))
    return out


def compare(first: Readings, late: Readings, ref_first: Readings, ref_late: Readings,
            uncounted: int = 0) -> Dict[str, float]:
    """Every number the check compares: the first steps' gaps (the worst
    parameter), the late step's (`late_`: its loss, and the median
    parameter's change and EMA change; its gradient, read alike, swings from
    seed to seed as far as the fp8 control's, PERF.md §2), and the steps the
    state's counters missed."""
    out = gaps(first, ref_first)
    out.update({f"late_{k}": v for k, v in gaps(late, ref_late, leaf=np.median, tag="median",
                                                names=("change", "ema_change")).items()})
    out["steps_uncounted"] = float(uncounted)
    return out


def check(run: Run, st: State, late: Late) -> None:
    ref_late = reference_late(run, st, late)
    late.drop_copies()
    ref = reference_readings(run, st)
    limits = run.workload["check"]["limits"]
    for k, v in compare(st.readings, late.readings, ref, ref_late, late.uncounted).items():
        run.checks[k] = Check(v, limits[k])


def run(run: Run, program_fault=None, window_fault=None) -> None:
    """Set-up (with the check's first steps), window, the peak, the step
    after the window, the program freed, the check. A `program_fault(state)`
    (tests only) breaks the program after it is built, a `window_fault`
    after the first steps."""
    import torch

    st = setup(run, program_fault)
    if window_fault is not None:
        window_fault(st)
    window(run, st)
    if run.device.startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    late = late_step(run, st)
    free(st)
    if run.trace:
        work_counts(run)
    run.mark("window_closed")
    check(run, st, late)
    run.mark("checked")
