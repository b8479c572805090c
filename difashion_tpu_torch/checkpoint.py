"""Checkpoint store: step-accurate save and restore with retention.
Counterpart of `difashion_tpu/core/checkpoint.py`, with its layout and
semantics; the port's own files are `torch.save` dictionaries of CPU tensors
keyed by parameter name:

  <dir>/checkpoint-<step>/
      trainable.pt     {name: tensor} of {unet, fashion_encoder} ("unet.<key>")
      ema.pt           {name: tensor}, the EMA copy (if enabled)
      opt_state.pt     the optimizer state, by parameter name
      meta.json        {step, ema_step}
  <dir>/frozen.pt      {vae: state dict, text_encoder: state dict}, saved once

It also reads the JAX package's layout, the same names in flax msgpack
(`core/msgpack.py`): `checkpoint-<step>/{trainable,opt_state,ema}.msgpack`
and `frozen.msgpack`, the parameters as flax trees ({unet, fashion_encoder}
/ {vae, text_encoder}) in flax's layouts (`core/flax_layout.py` translates
the paths and layouts), the optimizer state as optax's
`chain(clip_by_global_norm, adamw)` state: (EmptyState, (ScaleByAdamState(
count, mu, nu) or Adam8bitState(count, mu_q, mu_s, nu_q, nu_s), EmptyState,
EmptyState or ScaleByScheduleState(count))). The update counts must agree
and become the port's host int. 8-bit moments are blocks of 256 over each
leaf's flattened elements, and every conv and dense kernel orders its
elements differently on the two sides (HWIO / [in, out] there, OIHW /
[out, in] here), so an 8-bit checkpoint is refused, not requantized. The
MutualEncoder's kernels need the model config's latent (channels, size) to
be placed (`mutual_dims`). A directory may hold checkpoints of
both layouts (a JAX run resumed by the port): `latest` and the pruning go by
the step in the name, whatever the layout; `save` writes the port's.
A JAX-layout file is read leaf by leaf, each leaf through a map of its own
bytes, into the template's tensors (staged on the host in the target's
dtype and strides, so the copy to the card needs no device temporary):
neither the host nor the device ever holds a second copy of the state, only
about one leaf's pages and staging buffer on the host.

A checkpoint is written into `checkpoint-<step>.tmp/` and renamed into place;
a checkpoint of the same step is moved aside first and deleted only after the
rename, so a crash mid-save leaves the old checkpoint or the new one on disk,
never neither. `total_limit` keeps the newest checkpoints only.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from difashion_tpu_torch.core import msgpack
from difashion_tpu_torch.core.flax_layout import (
    KINDS,
    flax_path_to_hf_key,
    hf_key_to_flax_path,
    to_flax,
    to_port,
)
from difashion_tpu_torch.engine.optim8bit import Adam8bitState
from difashion_tpu_torch.config import TrainConfig
from difashion_tpu_torch.engine.train import AdamState, EMAState, TrainState

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
_OPT_LISTS = {AdamState: ("mu", "nu"), Adam8bitState: ("mu_q", "mu_s", "nu_q", "nu_s")}
log = logging.getLogger("difashion_tpu_torch")


def _host(tensors: List[torch.Tensor], names: List[str]) -> Dict[str, torch.Tensor]:
    """CPU copies in the default contiguous layout, so that a file's bytes do
    not depend on the parameters' memory format."""
    return {n: _saved(t, copy=True) for n, t in zip(names, tensors)}


def _saved(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    return t.detach().to("cpu", memory_format=torch.contiguous_format, copy=copy)


def _copy_into(tensors: List[torch.Tensor], names: List[str], saved: Dict[str, torch.Tensor],
               what: str) -> None:
    """Copy saved[name] into each tensor in place (device and dtype kept)."""
    if set(saved) != set(names):
        missing, extra = set(names) - set(saved), set(saved) - set(names)
        raise KeyError(f"{what}: missing {sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
    with torch.no_grad():
        for n, t in zip(names, tensors):
            if saved[n].shape != t.shape:
                raise ValueError(f"{what}: {n} has shape {tuple(saved[n].shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(saved[n])


def snapshot(state: TrainState) -> dict:
    """Everything a checkpoint holds, as CPU tensors: the device -> host copy
    that `save_async` makes before its write starts. A ZeRO-1 state holds
    one rank's slices: make it whole first (`gather_zero1_state`)."""
    if state.zero1 is not None:
        raise ValueError("a ZeRO-1 state holds one rank's slices of the moments and the "
                         "EMA: save engine/train.py::gather_zero1_state's whole state")
    opt = state.opt_state
    fields = _OPT_LISTS[type(opt)]
    return {
        "step": int(state.step),
        "trainable": _host(state.params, state.names),
        "opt_state": {"kind": type(opt).__name__, "count": int(opt.count),
                      **{f: _host(getattr(opt, f), state.names) for f in fields}},
        "ema": None if state.ema is None else {
            "params": _host(state.ema.params, state.names), "step": int(state.ema.step)},
    }


class CheckpointStore:
    def __init__(self, directory: str, total_limit: Optional[int] = None):
        self.dir = directory
        self.total_limit = total_limit
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ---- frozen towers (saved once) -----------------------------------------

    def save_frozen(self, frozen: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """{tower: state dict} of the frozen towers."""
        torch.save({tower: {k: _saved(v) for k, v in sd.items()}
                    for tower, sd in frozen.items()}, os.path.join(self.dir, "frozen.pt"))

    def load_frozen(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{tower: state dict} from frozen.pt, else from the JAX package's
        frozen.msgpack (views of the mapped file in the port's layout)."""
        path = os.path.join(self.dir, "frozen.pt")
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
        mf = msgpack.MappedFile(os.path.join(self.dir, "frozen.msgpack"))
        return {tower: {key: to_port(p, KINDS[tower])(mf.tensor(leaf))
                        for key, p, leaf in _tower_leaves(tower, tree)}
                for tower, tree in mf.tree.items()}

    def has_frozen(self) -> bool:
        return any(os.path.exists(os.path.join(self.dir, f))
                   for f in ("frozen.pt", "frozen.msgpack"))

    # ---- per-step checkpoints ------------------------------------------------

    def ckpt_path(self, step: int) -> str:
        return os.path.join(self.dir, f"checkpoint-{step}")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save_async(self, state: TrainState, step: int) -> None:
        """Copy the state to the host now, write the files on a thread (the
        train loop waits for the copy, not for the disk). A later save, or
        `wait()`, joins a write in flight first and re-raises its failure: a
        checkpoint the log announced either exists or stops the run."""
        self.wait()
        snap = snapshot(state)

        def run():
            try:
                self._write(snap, step)
            except BaseException as e:   # surfaced by wait()
                self._writer_error = e

        self._writer = threading.Thread(target=run, daemon=True)
        self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            err, self._writer_error = self._writer_error, None
            if err is not None:
                raise RuntimeError("async checkpoint write failed") from err

    def save(self, state: TrainState, step: int) -> str:
        return self._write(snapshot(state), step)

    def _write(self, snap: dict, step: int) -> str:
        if snap["step"] != step:
            log.warning("checkpoint label %d != state.step %d: resume will use state.step",
                        step, snap["step"])
        path, tmp = self._tmp_dir(step)
        torch.save(snap["trainable"], os.path.join(tmp, "trainable.pt"))
        torch.save(snap["opt_state"], os.path.join(tmp, "opt_state.pt"))
        meta = {"step": snap["step"]}
        if snap["ema"] is not None:
            torch.save(snap["ema"]["params"], os.path.join(tmp, "ema.pt"))
            meta["ema_step"] = snap["ema"]["step"]
        return self._commit(tmp, path, meta)

    def _commit(self, tmp: str, path: str, meta: dict) -> str:
        """Write meta.json into `tmp`, rename `tmp` into `path` (an old
        checkpoint of the step moved aside first, deleted after), prune."""
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
        self._prune()
        return path

    def _tmp_dir(self, step: int) -> Tuple[str, str]:
        path = self.ckpt_path(step)
        tmp = path + ".tmp"
        # never reuse a stale .tmp of a crashed writer: its leftover files would
        # be committed into the new checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        return path, tmp

    def load(self, template: TrainState, step: Optional[int] = None,
             mutual_dims: Optional[Tuple[int, int]] = None) -> TrainState:
        """Restore into a TrainState (a fresh one from `build_train_step`'s
        init, or one whose `opt_state` is None for inference): the trainable
        parameters, the optimizer state and the EMA are copied into its
        tensors in place. step None: the latest. The checkpoint may be in
        the port's layout or the JAX package's; the JAX layout needs
        `mutual_dims` (the MutualEncoder's latent channels and size, from the
        model config) to place the MutualEncoder's weights.
        EMA: restored where the checkpoint has it and the template wants it;
        seeded from the restored parameters where only the template wants it;
        dropped, with a warning, where only the checkpoint has it."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.ckpt_path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        names = template.names
        jax_layout = os.path.exists(os.path.join(path, "trainable.msgpack"))
        if jax_layout and mutual_dims is None:
            raise ValueError(f"checkpoint-{step} is in the JAX layout: pass mutual_dims, the "
                             "MutualEncoder's latent (channels, size) from the model config "
                             "(4*64*64 == 16*32*32: the flat size does not decide them)")
        reader = (_JaxReader(path, names, mutual_dims) if jax_layout
                  else _PortReader(path, names))
        reader.params("trainable", template.params)
        opt = template.opt_state
        if opt is not None:
            reader.opt_state(opt, step)
        ema = template.ema
        has_ema = os.path.exists(os.path.join(path, "ema.msgpack" if jax_layout else "ema.pt"))
        if ema is not None and has_ema:
            reader.params("ema", ema.params)
            ema = EMAState(params=ema.params, step=int(meta.get("ema_step", meta["step"])))
        elif ema is not None:
            # EMA newly enabled on resume: seed the average from the restored
            # weights (the warmup decay restarts) instead of training EMA-free
            log.warning("checkpoint-%d has no EMA but the config enables it: seeding EMA "
                        "from the restored trainable params", step)
            with torch.no_grad():
                for e, p in zip(ema.params, template.params):
                    e.copy_(p)
            ema = EMAState(params=ema.params, step=0)
        elif has_ema:
            log.warning("checkpoint-%d carries EMA weights but the config disables EMA: "
                        "they will not be restored or updated", step)
        return TrainState(names=names, params=template.params, opt_state=opt, ema=ema,
                          step=int(meta["step"]))

    def save_jax_layout(self, state: TrainState, step: int, train_cfg: TrainConfig,
                        mutual_dims: Tuple[int, int]) -> str:
        """Write `checkpoint-<step>/` in the JAX package's layout (its
        CheckpointStore reads it into the state of `make_optimizer(train_cfg)`):
        the state's parameters, AdamW moments and EMA as flax trees,
        streamed leaf by leaf; a schedule other than "constant" holds the
        count in optax's ScaleByScheduleState too. 8-bit moments are refused
        (their blocks differ, above)."""
        if not isinstance(state.opt_state, AdamState):
            raise ValueError("the JAX layout is written for AdamW states only: 8-bit "
                             "moments are blocked over flax's kernel layouts")
        path, tmp = self._tmp_dir(step)
        names = state.names
        routes = _routes(names, state.params)
        tree = lambda tensors: _flax_tree(names, routes, tensors, mutual_dims)
        opt = state.opt_state
        count = np.asarray(opt.count, np.int32)
        sched = {} if train_cfg.lr_scheduler == "constant" else {"count": count}
        opt_tree = {"0": {}, "1": {"0": {"count": count, "mu": tree(opt.mu), "nu": tree(opt.nu)},
                                   "1": {}, "2": sched}}
        files = {"trainable.msgpack": tree(state.params), "opt_state.msgpack": opt_tree}
        meta = {"step": int(state.step)}
        if state.ema is not None:
            files["ema.msgpack"] = tree(state.ema.params)
            meta["ema_step"] = int(state.ema.step)
        for name, t in files.items():
            with open(os.path.join(tmp, name), "wb") as f:
                msgpack.dump(t, f)
        return self._commit(tmp, path, meta)

    def _prune(self) -> None:
        if self.total_limit is None:
            return
        steps = self.all_steps()
        while len(steps) > self.total_limit:
            shutil.rmtree(self.ckpt_path(steps.pop(0)), ignore_errors=True)


# ---- the two layouts' readers ---------------------------------------------------

class _PortReader:
    """checkpoint-<step>/*.pt of the port's own store."""

    def __init__(self, path: str, names: List[str]):
        self.path, self.names = path, names

    def _read(self, name: str):
        return torch.load(os.path.join(self.path, name), map_location="cpu", weights_only=True)

    def params(self, what: str, tensors: List[torch.Tensor]) -> None:
        _copy_into(tensors, self.names, self._read(f"{what}.pt"), what)

    def opt_state(self, opt, step: int) -> None:
        saved = self._read("opt_state.pt")
        if saved["kind"] != type(opt).__name__:
            raise ValueError(f"checkpoint-{step} holds {saved['kind']} state, the "
                             f"template {type(opt).__name__}")
        for f in _OPT_LISTS[type(opt)]:
            _copy_into(getattr(opt, f), self.names, saved[f], f"opt_state.{f}")
        opt.count = saved["count"]


def _flax_leaves(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tower_leaves(tower: str, tree: dict):
    """(HF key, flax path, leaf) of one tower's flax tree."""
    kind = KINDS[tower]
    return [(flax_path_to_hf_key(p, kind), p, leaf) for p, leaf in _flax_leaves(tree)]


def _named_leaves(tree: dict):
    """{port name: (flax path, kind, leaf)} of a {tower: flax tree} tree."""
    return {f"{tower}.{key}": (p, KINDS[tower], leaf)
            for tower, sub in tree.items() for key, p, leaf in _tower_leaves(tower, sub)}


def _check_names(names: List[str], have, what: str) -> None:
    if set(have) != set(names):
        missing, extra = set(names) - set(have), set(have) - set(names)
        raise KeyError(f"{what}: missing {sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")


class _JaxReader:
    """checkpoint-<step>/*.msgpack of the JAX package's store."""

    def __init__(self, path: str, names: List[str], mutual_dims):
        self.path, self.names, self.mutual_dims = path, names, mutual_dims

    def _copy(self, mf: msgpack.MappedFile, tree: dict, tensors: List[torch.Tensor],
              what: str) -> None:
        leaves = _named_leaves(tree)
        _check_names(self.names, leaves, what)
        with torch.no_grad():
            for name, t in zip(self.names, tensors):
                p, kind, leaf = leaves[name]
                src = to_port(p, kind, self.mutual_dims)(mf.tensor(leaf))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{what}: {name} has shape {tuple(src.shape)}, "
                                     f"expected {tuple(t.shape)}")
                if t.device.type != "cpu":
                    # the target's dtype and strides on the host first, so that
                    # the copy to the card is one memcpy with no device temporary
                    staged = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype)
                    src = staged.copy_(src)
                t.copy_(src)

    def params(self, what: str, tensors: List[torch.Tensor]) -> None:
        with msgpack.MappedFile(os.path.join(self.path, f"{what}.msgpack")) as mf:
            self._copy(mf, mf.tree, tensors, what)

    def opt_state(self, opt, step: int) -> None:
        with msgpack.MappedFile(os.path.join(self.path, "opt_state.msgpack")) as mf:
            try:
                inner = mf.tree["1"]
                adam, sched = inner["0"], inner["2"]
            except (KeyError, TypeError) as e:
                raise ValueError(f"checkpoint-{step}: opt_state.msgpack is not optax's "
                                 "chain(clip_by_global_norm, adamw) state") from e
            if "mu_q" in adam:
                raise ValueError(
                    f"checkpoint-{step}: 8-bit AdamW moments cannot be carried between the "
                    "JAX layout and the port's: their int8 blocks of 256 run over each "
                    "leaf's flattened elements, and every conv and dense kernel orders its "
                    "elements differently (HWIO / [in, out] there, OIHW / [out, in] here). "
                    "Requantizing would change the moments, so the checkpoint is refused; "
                    "resume it with the JAX package, or restart the optimizer state")
            if not isinstance(opt, AdamState):
                raise ValueError(f"checkpoint-{step} holds AdamState state, the template "
                                 f"{type(opt).__name__}")
            count = int(mf.tensor(adam["count"]))
            if "count" in sched and int(mf.tensor(sched["count"])) != count:
                raise ValueError(f"checkpoint-{step}: the schedule's count "
                                 f"{int(mf.tensor(sched['count']))} != Adam's {count}")
            for f in _OPT_LISTS[AdamState]:
                self._copy(mf, adam[f], getattr(opt, f), f"opt_state.{f}")
            opt.count = count


def _routes(names: List[str], params: List[torch.Tensor]) -> Dict[str, Tuple]:
    """{port name: (flax path, kind)} (a module is a conv when its weight is 4-D)."""
    dims = dict(zip(names, (p.dim() for p in params)))
    out = {}
    for name in names:
        tower, key = name.split(".", 1)
        conv = dims.get(f"{tower}.{key.rsplit('.', 1)[0]}.weight") == 4
        out[name] = (hf_key_to_flax_path(key, KINDS[tower], conv), KINDS[tower])
    return out


def _flax_tree(names: List[str], routes: Dict[str, Tuple], tensors: List[torch.Tensor],
               mutual_dims) -> dict:
    """{tower: flax tree} of `tensors` (one per name), in flax's layouts (views)."""
    tree: dict = {}
    for name, t in zip(names, tensors):
        path, kind = routes[name]
        node = tree.setdefault(name.split(".", 1)[0], {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = to_flax(path, kind, mutual_dims)(t)
    return tree
