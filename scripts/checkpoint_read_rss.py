#!/usr/bin/env python3
"""The host's peak resident set over `CheckpointStore.load` of an sd2_base
train state in the JAX package's layout (14 GB of flax msgpack), with each
file's structure parsed as shipped (reads of its headers) and, as a
yardstick, from a map of the whole file (how the reader parsed before), in
turns: mapped, shipped, shipped, shipped, mapped, ...

    python3 scripts/checkpoint_read_rss.py [--loads 8]   # from the repository root, one CUDA card

The state is `chip_smoke.py` phase jax_checkpoint's (the recipe's AdamW and
EMA, fp32, step 3) written once with `save_jax_layout` into a temporary
directory, then loaded `--loads` times into one fresh state on the card.
Per load one JSON line: the parse, the read's seconds, the resident set
before it and the peak over it (`chip_smoke.RssPeak`, sampled every 2 ms).
"""
import argparse
import json
import mmap
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)


def whole_file_parse(self, path):
    """`MappedFile.__init__` parsing from a map of the whole file."""
    from difashion_tpu_torch.core import msgpack

    self._f = open(path, "rb")
    mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
    view = memoryview(mm)
    try:
        self.tree = msgpack._Reader(view).obj()
    finally:
        view.release()
        mm.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loads", type=int, default=8)
    args = ap.parse_args()

    import torch

    from difashion_tpu_torch.checkpoint import CheckpointStore
    from difashion_tpu_torch.config import ModelConfig, TrainConfig
    from difashion_tpu_torch.core import msgpack
    from difashion_tpu_torch.engine.train import build_train_step
    from difashion_tpu_torch.models.difashion import create_difashion

    cfg, tc = ModelConfig.sd2_base(), TrainConfig()
    dims = (cfg.mutual.latent_channels, cfg.mutual.latent_size)
    shipped = msgpack.MappedFile.__init__
    with tempfile.TemporaryDirectory() as tmp:
        model = create_difashion(cfg, seed=0, device="cuda")
        state = build_train_step(model, tc)[1]()
        state.step, state.opt_state.count, state.ema.step = 3, 3, 3
        store = CheckpointStore(tmp)
        store.save_jax_layout(state, 3, tc, dims)
        del model, state
        torch.cuda.empty_cache()
        fresh = build_train_step(create_difashion(cfg, seed=1, device="cuda"), tc)[1]()
        for i in range(args.loads):
            parse = "whole_file_map" if i % 4 == 0 else "headers"
            msgpack.MappedFile.__init__ = whole_file_parse if i % 4 == 0 else shipped
            rss0 = chip_smoke.rss_bytes()
            with chip_smoke.RssPeak() as rss:
                t0 = time.perf_counter()
                store.load(fresh, mutual_dims=dims)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            print(json.dumps({"load": i, "parse": parse, "read_seconds": seconds,
                              "host_rss_before_bytes": rss0,
                              "host_peak_rss_over_read_bytes": rss.peak - rss0}), flush=True)
        msgpack.MappedFile.__init__ = shipped


if __name__ == "__main__":
    main()
