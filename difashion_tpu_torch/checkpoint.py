"""Checkpoint store: step-accurate save and restore with retention.
Counterpart of `difashion_tpu/core/checkpoint.py`, with its layout and
semantics; the files are `torch.save` dictionaries of CPU tensors keyed by
parameter name (flax msgpack has no reader here):

  <dir>/checkpoint-<step>/
      trainable.pt     {name: tensor} of {unet, fashion_encoder} ("unet.<key>")
      ema.pt           {name: tensor}, the EMA copy (if enabled)
      opt_state.pt     the optimizer state, by parameter name
      meta.json        {step, ema_step}
  <dir>/frozen.pt      {vae: state dict, text_encoder: state dict}, saved once

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
from typing import Dict, List, Optional

import torch

from difashion_tpu_torch.engine.optim8bit import Adam8bitState
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
    that `save_async` makes before its write starts."""
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
        return torch.load(os.path.join(self.dir, "frozen.pt"), map_location="cpu",
                          weights_only=True)

    def has_frozen(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "frozen.pt"))

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
        path = self.ckpt_path(step)
        tmp = path + ".tmp"
        # never reuse a stale .tmp of a crashed writer: its leftover files would
        # be committed into the new checkpoint
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(snap["trainable"], os.path.join(tmp, "trainable.pt"))
        torch.save(snap["opt_state"], os.path.join(tmp, "opt_state.pt"))
        meta = {"step": snap["step"]}
        if snap["ema"] is not None:
            torch.save(snap["ema"]["params"], os.path.join(tmp, "ema.pt"))
            meta["ema_step"] = snap["ema"]["step"]
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

    def load(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore into a TrainState (a fresh one from `build_train_step`'s
        init, or one whose `opt_state` is None for inference): the trainable
        parameters, the optimizer state and the EMA are copied into its
        tensors in place. step None: the latest. EMA: restored where the
        checkpoint has it and the template wants it; seeded from the restored
        parameters where only the template wants it; dropped, with a warning,
        where only the checkpoint has it."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.ckpt_path(step)
        read = lambda name: torch.load(os.path.join(path, name), map_location="cpu",
                                       weights_only=True)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        names = template.names
        _copy_into(template.params, names, read("trainable.pt"), "trainable")
        opt = template.opt_state
        if opt is not None:
            saved = read("opt_state.pt")
            if saved["kind"] != type(opt).__name__:
                raise ValueError(f"checkpoint-{step} holds {saved['kind']} state, the "
                                 f"template {type(opt).__name__}")
            for f in _OPT_LISTS[type(opt)]:
                _copy_into(getattr(opt, f), names, saved[f], f"opt_state.{f}")
            opt.count = saved["count"]
        ema = template.ema
        has_ema = os.path.exists(os.path.join(path, "ema.pt"))
        if ema is not None and has_ema:
            _copy_into(ema.params, names, read("ema.pt"), "ema")
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

    def _prune(self) -> None:
        if self.total_limit is None:
            return
        steps = self.all_steps()
        while len(steps) > self.total_limit:
            shutil.rmtree(self.ckpt_path(steps.pop(0)), ignore_errors=True)
