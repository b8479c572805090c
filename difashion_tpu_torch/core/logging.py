"""Training metrics: `MetricLogger` (an append-only JSONL file, a console line
every `console_every` steps, and the trackers of `report_to`) and
`StepTimer` (wall clock and images per second per device). Counterpart of
`difashion_tpu/core/logging.py`.

Trackers: "tensorboard" (the event writer of `core/tensorboard.py`),
"wandb" and "comet_ml"; a requested tracker whose package is missing is
skipped with a warning, and the JSONL file is written either way.

The JAX module's `profile_trace` (a `jax.profiler` window) and
`enable_compile_cache` (JAX's persistent compilation cache) have no
counterpart here: the port profiles with `torch.profiler`, and its only
compiled artifacts are the CUDA kernels, cached in their build directory
(`nn/kernels/`).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from difashion_tpu_torch.cli.common import logger, setup_logging

__all__ = ["MetricLogger", "StepTimer", "setup_logging"]


class _WandbTracker:
    """Scalars and images to wandb. Honors WANDB_PROJECT / WANDB_MODE; offline
    by default, so a machine without network records runs locally."""

    def __init__(self, out_dir: str, config: Optional[dict] = None):
        import wandb  # ImportError when the package is missing

        self._run = wandb.init(
            project=os.environ.get("WANDB_PROJECT", "difashion-tpu"),
            dir=out_dir, config=config or {},
            mode=os.environ.get("WANDB_MODE", "offline"))

    def add_scalars(self, step, scalars, wall_time=None):
        self._run.log(dict(scalars), step=int(step))

    def add_image(self, tag, image, step):
        import wandb

        self._run.log({tag: wandb.Image(image)}, step=int(step))

    def flush(self):
        pass

    def close(self):
        self._run.finish()


class _CometTracker:
    """Scalars and images to comet_ml."""

    def __init__(self, out_dir: str, config: Optional[dict] = None):
        import comet_ml  # ImportError when the package is missing

        self._exp = comet_ml.Experiment(
            project_name=os.environ.get("COMET_PROJECT_NAME", "difashion-tpu"))
        if config:
            self._exp.log_parameters(config)

    def add_scalars(self, step, scalars, wall_time=None):
        self._exp.log_metrics(dict(scalars), step=int(step))

    def add_image(self, tag, image, step):
        self._exp.log_image(image, name=tag, step=int(step))

    def flush(self):
        pass

    def close(self):
        self._exp.end()


def _build_tracker(name: str, out_dir: str, config: Optional[dict]):
    if name == "tensorboard":
        from difashion_tpu_torch.core.tensorboard import TBEventWriter

        return TBEventWriter(os.path.join(out_dir, "tb"))
    if name == "wandb":
        return _WandbTracker(out_dir, config)
    if name == "comet_ml":
        return _CometTracker(out_dir, config)
    raise ValueError(f"unknown tracker {name!r} (choose from tensorboard, wandb, comet_ml)")


class MetricLogger:
    """Append-only `<out_dir>/metrics.jsonl`, a console line every
    `console_every` steps, and the trackers of `report_to` (default:
    tensorboard, into `<out_dir>/tb/`)."""

    def __init__(self, out_dir: str, console_every: int = 50,
                 report_to: tuple = ("tensorboard",), run_config: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.console_every = console_every
        self._f = open(self.path, "a")
        self._trackers = []
        self.active_trackers = []
        for t in report_to:
            try:
                self._trackers.append(_build_tracker(t, out_dir, run_config))
                self.active_trackers.append(t)
            except ImportError as e:
                logger.warning("tracker %r requested but its package is unavailable (%s): "
                               "skipping; metrics still recorded in %s", t, e, self.path)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        scalars = {k: v for k, v in rec.items() if isinstance(v, float) and k != "time"}
        if scalars:
            for t in self._trackers:
                t.add_scalars(step, scalars, wall_time=rec["time"])
                t.flush()
        if step % self.console_every == 0:
            logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in rec.items() if k != "time"))

    def log_image(self, step: int, tag: str, image) -> None:
        """A uint8 [H, W, 3] image to the trackers; the JSONL records the
        event, not the pixels."""
        self._f.write(json.dumps({"step": int(step), "time": time.time(), "image": tag})
                      + "\n")
        self._f.flush()
        for t in self._trackers:
            t.add_image(tag, image, int(step))
            t.flush()

    def close(self) -> None:
        self._f.close()
        for t in self._trackers:
            t.close()


class StepTimer:
    """Wall clock between `start` and `stop`, and images per second per
    device over it."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, n_chips)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_images: int) -> dict:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        return {"step_time_s": dt,
                "images_per_sec_per_chip": n_images / dt / self.n_chips if dt > 0 else 0.0}
