"""What the port's CLIs share: logging and the config they run."""
from __future__ import annotations

import dataclasses
import logging

from difashion_tpu_torch.config import Config

logger = logging.getLogger("difashion_tpu_torch")


def setup_logging(verbosity: str = "INFO") -> logging.Logger:
    """One stream handler on the package's logger (added once)."""
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, verbosity.upper(), logging.INFO))
    return logger


def load_config(path, tiny: bool) -> Config:
    """A JSON config file, else the tiny preset with `tiny`, else the
    `run_eta0.1.sh` recipe."""
    if path:
        with open(path) as f:
            return Config.from_json(f.read())
    return Config.preset_tiny() if tiny else Config.preset_eta01()


def apply_generation_overrides(cfg: Config, **fields) -> Config:
    """cfg with the given `GenerationConfig` fields overridden (None keeps
    a field)."""
    overrides = {k: v for k, v in fields.items() if v is not None}
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, generation=dataclasses.replace(cfg.generation,
                                                                   **overrides))
