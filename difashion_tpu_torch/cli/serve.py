"""Serving entry point: a persistent generation service over HTTP.
Counterpart of `difashion_tpu/cli/serve.py`.

The model stays resident on its device and answers FITB / GOR requests as
JSON with base64 JPEGs (stdlib `http.server`; a deployment fronts it with its
own RPC layer).

  POST /generate  {"task": "FITB"|"GOR", "uids": [..], "oids": [..],
                   "outfits": [[iid x4], ...],    # 0 = a slot to generate
                   "category": [[cid x4], ...], "seed": 123}
  -> {"images": {"<uid>/<oid>": ["<base64 jpeg>", ...]}, "latency_s": ...}
  GET /healthz -> {"status": "ok", "devices": <CUDA devices>}

    python -m difashion_tpu_torch serve --data_path <dir> --ckpt_dir <ckpt> \
        [--scheduler dpmpp --num_inference_steps 20] [--device cuda|cpu]

`--scheduler dpmpp --num_inference_steps 20` is the fast-serving recipe.
`GenerationService.generate_images` is the device half of a request (request
-> prepared batch -> uint8 images), `generate` adds the host half (JPEG,
base64), which needs PIL.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np
import torch

from difashion_tpu_torch.cli.common import apply_generation_overrides
from difashion_tpu_torch.engine.generate import decode_to_uint8


class GenerationService:
    """The warm-model request handler under the HTTP layer. One device: a
    lock serialises requests, so concurrent POSTs cannot stack device batches
    or skew each other's latency. A request holds at most `max_batch`
    outfits, and at most max_batch fills (FITB) or max_batch x 4 (GOR); its
    fills are padded to that count and its outfits to max_batch, so every
    request of a task runs the same shapes and a fill's images do not depend
    on the request it came in."""

    def __init__(self, pipeline, max_batch: int = 16, checkpoint_step=None):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.checkpoint_step = checkpoint_step
        self._lock = threading.Lock()

    def _validate(self, req: dict) -> Tuple[str, dict, int]:
        task = req.get("task", "FITB")
        if task not in ("FITB", "GOR"):
            raise ValueError(f"task must be 'FITB' or 'GOR', got {task!r}")
        batch = {k: np.asarray(req[k], np.int64)
                 for k in ("uids", "oids", "outfits", "category")}
        if len(batch["uids"]) > self.max_batch:
            raise ValueError(f"batch too large (> {self.max_batch})")
        olen = batch["outfits"].shape[1]
        pad_to = self.max_batch * (olen if task == "GOR" else 1)
        # the device batch is the FILL count: multi-blank FITB outfits could
        # otherwise exceed pad_to and run an uncapped device batch
        n_fills = (int((batch["outfits"] == 0).sum()) if task == "FITB"
                   else len(batch["uids"]) * olen)
        if n_fills == 0:
            raise ValueError("no slots to generate (task FITB needs at least one 0 in outfits)")
        if n_fills > pad_to:
            raise ValueError(f"{n_fills} fill slots exceed the service cap {pad_to} "
                             f"(= max_batch {self.max_batch} x {pad_to // self.max_batch})")
        return task, batch, pad_to

    def generate_images(self, req: dict):
        """The device half: (prepared batch, final latents [F, h, w, C],
        uint8 images [F, H, W, 3] on the host). F includes the pad fills
        (prep.valid marks the real ones)."""
        task, batch, pad_to = self._validate(req)
        with self._lock:
            prep = self.pipeline.prepare_batch(batch, task, int(req.get("seed", 123)),
                                               pad_to=pad_to, pad_outfits=self.max_batch)
            latents = self.pipeline.sample(prep)
            imgs = decode_to_uint8(self.pipeline.model, latents).cpu().numpy()
        return prep, latents, imgs

    def generate(self, req: dict) -> dict:
        t0 = time.perf_counter()
        prep, _, imgs = self.generate_images(req)
        from PIL import Image

        out: dict = {}
        for k in range(len(imgs)):
            if not prep.valid[k]:
                continue
            buf = io.BytesIO()
            Image.fromarray(imgs[k]).save(buf, format="JPEG", quality=95)
            out.setdefault(f"{int(prep.fill_uids[k])}/{int(prep.fill_oids[k])}", []).append(
                base64.b64encode(buf.getvalue()).decode())
        return {"images": out, "latency_s": round(time.perf_counter() - t0, 3)}


def make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        MAX_BODY = 16 * 2 ** 20   # a request is ids only; 16 MB is generous

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "devices": torch.cuda.device_count()})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0 or n > self.MAX_BODY:
                    self._send(400, {"error": f"Content-Length must be in (0, {self.MAX_BODY}]"})
                    return
                req = json.loads(self.rfile.read(n))
            except Exception as e:  # a malformed request
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                result = service.generate(req)
            except (ValueError, KeyError) as e:   # the client's error
                self._send(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - an internal failure
                self._send(500, {"error": f"internal error: {type(e).__name__}"})
                return
            try:
                self._send(200, result)
            except (BrokenPipeError, ConnectionResetError):
                pass   # the client left after the work was done

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def build_service(args) -> GenerationService:
    """The warm-model service from parsed CLI args: the tokenizer refusal,
    the config overrides, the checkpoint, the catalog latents and history."""
    from difashion_tpu_torch.cli.common import load_config
    from difashion_tpu_torch.cli.generate import item_latents_and_hist, load_model_for_inference
    from difashion_tpu_torch.data.datasets import FashionData
    from difashion_tpu_torch.data.tokenizer import load_tokenizer
    from difashion_tpu_torch.engine.pipeline import GenerationPipeline

    cfg = apply_generation_overrides(load_config(args.config, args.tiny),
                                     scheduler=args.scheduler,
                                     num_inference_steps=args.num_inference_steps)
    # the hash-tokenizer stand-in would give meaningless conditioning with
    # real weights: refuse unless asked for
    tokenizer = load_tokenizer(args.tokenizer_dir, cfg.model.text.vocab_size,
                               strict=not args.allow_random_weights)
    model, step = load_model_for_inference(cfg, args.ckpt_dir, device=args.device)
    data = FashionData.load(args.data_path)
    item_latents, hist_store = item_latents_and_hist(cfg, args.data_path,
                                                     data.history.get("test", {}))
    pipe = GenerationPipeline(model, cfg, data.id_cate_dict, tokenizer, hist_store,
                              item_latents=item_latents)
    return GenerationService(pipe, max_batch=args.max_batch, checkpoint_step=step)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiFashion generation service (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--config", default=None)
    p.add_argument("--scheduler", choices=["pndm", "ddim", "dpmpp"], default=None,
                   help="override the config's scheduler; dpmpp at ~20 steps is the "
                        "fast-serving mode")
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--tokenizer_dir", default=None,
                   help="CLIP tokenizer asset dir (vocab.json + merges.txt)")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="permit the hash-tokenizer fallback (outputs will be "
                        "meaningless; tests/throughput only)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    from difashion_tpu_torch.cli.common import setup_logging

    args = parse_args(argv)
    log = setup_logging()
    service = build_service(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    log.info("serving checkpoint-%d on %s:%d (%s)", service.checkpoint_step, args.host,
             server.server_address[1], args.device)
    server.serve_forever()


if __name__ == "__main__":
    main()
