#!/usr/bin/env python3
"""The flash-attention backward kernels (`difashion_tpu_torch/csrc/flash_attention_dq.cu`,
`csrc/flash_attention_dkv.cu`) at every tile they can be built with, on one CUDA card.

    python3 scripts/flash_bwd_tiles.py                  # from the repository root
    python3 scripts/flash_bwd_tiles.py --quick          # build, ptxas report, checks only
    python3 scripts/flash_bwd_tiles.py --against DIR    # also time DIR's dQ and dK/dV

It builds both sources with -DFLASH_BWD_ALL_TILES (every candidate tile: for
dQ the consumer warpgroups, i.e. a Q tile of 64 rows each, the KV tile, the
stages and ping-pong or not; for dK/dV the consumer warpgroups, i.e. a KV
tile of 64 rows each, the Q tile, the stages and ping-pong or not; for the
padded head dims 64 and 128) and
prints the ptxas report and the SASS's highest register index and
local-memory traffic per tile. Then at every attention site of the training
step's UNet (sd2_base, the recipe's 8 rows, d = 64) and of the sd15 UNet's at
the same batch (8 heads: d = 40 and 80), in bf16 with the projections'
[B, S, H, D] layout and O and the LSE from the forward kernel: each tile
against the plain version (relative L2 within BWD_TILE_TOL) and its time,
dK/dV at the split plan's count and, where that is more than one, also
unsplit; beside the library backward (F.scaled_dot_product_attention's dQ,
dK and dV together, a yardstick only) and each kernel's bound. One JSON line
per site; last, per kernel, model and padded head dim, the tile with the
least time summed over the site's calls per train step (the sd2_base sums
decide head dim 64: the training path's), and the tiles the library is built
with. With --against DIR, the wrappers `flash_attention_dq` and
`flash_attention_dkv` of the checkout in DIR (an earlier version of the
kernels, built from DIR's own sources; its wrappers' padded copies
included) are timed at the same sites in a process of its own, before and
after this tree's, and printed beside. Exits non-zero if any check fails.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

DEFINE = "FLASH_BWD_ALL_TILES"
# the candidates the sources instantiate under DEFINE:
# dQ (padded head dim, consumer warpgroups, KV tile, stages, ping-pong)
DQ_TILES = [(64, 2, 80, 3, 0), (64, 2, 96, 2, 0), (64, 2, 96, 2, 1), (64, 2, 96, 3, 0),
            (128, 2, 64, 2, 0), (128, 2, 64, 3, 1)]
# dK/dV (padded head dim, consumer warpgroups, Q tile, stages, ping-pong)
DKV_TILES = [(64, 2, 64, 2, 0), (64, 2, 64, 2, 1), (64, 2, 64, 3, 0), (64, 2, 64, 3, 1),
             (128, 1, 64, 2, 0), (128, 1, 64, 3, 0)]
# a gradient of the kernel against the plain version on the same bf16 inputs
# (which rounds P and dS where the kernels do): the bound of
# tests/test_torch_port_cuda.py
BWD_TILE_TOL = 1e-2
QUICK_SHAPES = [("quick_self", 2, 5, 1000, 333, 64, 1), ("quick_cross", 2, 5, 1000, 77, 64, 1),
                ("quick_d40", 1, 8, 300, 77, 40, 1), ("quick_d80", 2, 3, 1030, 300, 80, 1),
                ("quick_ragged", 1, 2, 77, 100, 16, 1)]


def sites():
    """(name, B, H, Sq, Skv, d, calls per train step): the training UNet's
    sites (sd2_base) and the sd15 UNet's at the same batch, d <= 128."""
    from difashion_tpu_torch.config import ModelConfig

    sd2 = chip_smoke.main_path_attention_sites(ModelConfig.sd2_base(), chip_smoke.TRAIN_ROWS)
    sd15 = chip_smoke.main_path_attention_sites(ModelConfig.sd15(), chip_smoke.TRAIN_ROWS)
    return sd2 + [(f"sd15_{n}", *rest) for n, *rest in sd15 if rest[-2] <= 128]


def tile_fns(dq_path, dkv_path):
    dq = ctypes.CDLL(str(dq_path)).flash_attention_dq_tile
    dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dq.restype = ctypes.c_int
    dkv = ctypes.CDLL(str(dkv_path)).flash_attention_dkv_tile
    dkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dkv.restype = ctypes.c_int
    return dq, dkv


def run_dq(fn, args, tile):
    import torch

    from difashion_tpu_torch.nn.kernels.flash_attention import _empty_bshd, _strides

    q, k, v, do, lse, delta, scale = args
    b, h, sq, d = q.shape
    dq = _empty_bshd(b, h, sq, d, q)
    st = (ctypes.c_int64 * 15)(*_strides((q, k, v, do, dq)))
    _, nc, bkv, stages, pp = tile
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[2], d, ctypes.addressof(st),
            scale, nc, bkv, stages, pp, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_dq_tile {tile}: error {rc}")
    return dq


def run_dkv(fn, args, tile, splits):
    import torch

    from difashion_tpu_torch.nn.kernels.flash_attention import _empty_bshd, _strides

    q, k, v, do, lse, delta, scale = args
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dk, dv = _empty_bshd(b, h, skv, d, k), _empty_bshd(b, h, skv, d, v)
    ws = torch.empty(2 * splits * b * h * skv * d if splits > 1 else 1, dtype=torch.float32,
                     device=q.device)
    st = (ctypes.c_int64 * 18)(*_strides((q, k, v, do, dk, dv)))
    _, nc, bq, stages, pp = tile
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, h, sq, skv, d,
            splits, ctypes.addressof(st), scale, nc, bq, stages, pp,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_dkv_tile {tile} splits {splits}: error {rc}")
    return dk, dv


def ptxas_by_tile(log, kernel):
    """{tile label: [ptxas lines]} of `kernel`'s instantiations."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(rf"{kernel}I(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", ln)
        if m:
            cur = (f"{m.group(1)[-8:]} dp{m.group(2)} nc{m.group(3)} {m.group(4)} "
                   f"st{m.group(5)} pp{m.group(6)}")
            out[cur] = []
        elif "Compiling entry function" in ln or "Function properties for" in ln:
            cur = None if kernel not in ln else cur
        elif cur and ("registers" in ln or "spill" in ln or "arning" in ln):
            out[cur].append(ln.strip())
    return out


def sass_by_tile(path, kernel):
    """{tile label: highest register index, local-memory loads and stores} in
    the SASS of each instantiation of `kernel` (cuobjdump from the toolkit)."""
    from difashion_tpu_torch.nn import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    out, cur = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            m = re.search(rf"{kernel}I(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", ln)
            cur = (f"{m.group(1)[-8:]} dp{m.group(2)} nc{m.group(3)} {m.group(4)} "
                   f"st{m.group(5)} pp{m.group(6)}") if m else None
            if cur:
                out[cur] = {"max_reg": 0, "local_loads": 0, "local_stores": 0}
        elif cur:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
            if regs:
                out[cur]["max_reg"] = max(out[cur]["max_reg"], max(regs))
            out[cur]["local_loads"] += " LDL" in ln
            out[cur]["local_stores"] += " STL" in ln
    return out


def inputs(b, h, sq, skv, d, gen):
    """q, k, v, dO in the projections' layout, O and the LSE from the forward
    kernel, D: the backward's arguments."""
    import torch

    from difashion_tpu_torch.nn.kernels.flash_attention import attention_delta, flash_attention

    def proj(s):
        return (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
                .view(b, s, h, d).transpose(1, 2))

    q, k, v, do = proj(sq), proj(skv), proj(skv), proj(sq)
    o, lse = flash_attention(q, k, v)
    return q, k, v, do, lse, attention_delta(o, do), d ** -0.5


def against(directory, site_list):
    """Times of `flash_attention_dq` and `flash_attention_dkv` from the checkout
    in `directory`, in a process of its own (its package, its sources, its
    build)."""
    code = f"""
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.nn.kernels import flash_attention as fa
gen = torch.Generator(device="cuda").manual_seed(0)
out = {{}}
for name, b, h, sq, skv, d, calls in {site_list!r}:
    q, k, v, do = (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
                   .view(b, s, h, d).transpose(1, 2) for s in (sq, skv, skv, sq))
    try:
        o, lse = fa.flash_attention(q, k, v)
        args = (q, k, v, do, lse, fa.attention_delta(o, do), d ** -0.5)
        out[name] = {{"dq_ms": chip_smoke.device_ms(lambda: fa.flash_attention_dq(*args)),
                     "dkv_ms": chip_smoke.device_ms(lambda: fa.flash_attention_dkv(*args))}}
    except Exception as e:
        out[name] = str(e)[:200]
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=directory, timeout=900)
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def label(tile):
    return "nc{}_{}_st{}_pp{}".format(*tile[1:])


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.flash_attention import (
        DKV_NAME,
        DQ_NAME,
        dkv_splits,
        flash_attention_dkv,
        flash_attention_dkv_ref,
        flash_attention_dq,
        flash_attention_dq_ref,
    )

    if not torch.cuda.is_available():
        print("flash_bwd_tiles: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    quick = "--quick" in args
    other = args[args.index("--against") + 1] if "--against" in args else None
    chip_smoke.phase_device()
    (dq_path, dq_log), (dkv_path, dkv_log) = (kernels.build(n, (DEFINE,)) for n in (DQ_NAME, DKV_NAME))
    print(json.dumps({"ptxas": {"dq": ptxas_by_tile(dq_log, "flash_dq_kernel"),
                                "dkv": ptxas_by_tile(dkv_log, "flash_dkv_kernel")}}), flush=True)
    print(json.dumps({"sass": {"dq": sass_by_tile(dq_path, "flash_dq_kernel"),
                               "dkv": sass_by_tile(dkv_path, "flash_dkv_kernel")}}), flush=True)
    dq_fn, dkv_fn = tile_fns(dq_path, dkv_path)
    site_list = QUICK_SHAPES if quick else sites()
    before = against(other, site_list) if other else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad, totals = [], {}
    for name, b, h, sq, skv, d, calls in site_list:
        a = inputs(b, h, sq, skv, d, gen)
        want = (flash_attention_dq_ref(*a),) + flash_attention_dkv_ref(*a)
        dp = 64 if d <= 64 else 128
        group = f"{'sd15' if name.startswith('sd15') else 'sd2_base'} dp{dp}"
        row = {"site": name, "shape_bhqkd": [b, h, sq, skv, d], "calls": calls,
               "dkv_splits": dkv_splits(b, h, sq, skv, d), "dq": {}, "dkv": {}}

        def check(kind, lab, got, ref):
            errs = [chip_smoke.rel_l2(g, w) for g, w in zip(got, ref)]
            ok = max(errs) <= BWD_TILE_TOL and all(bool(torch.isfinite(g).all()) for g in got)
            if not ok:
                bad.append((name, kind, lab))
            return {"rel_l2": errs, "ok": ok}

        def timed(kind, lab, entry, fn, total=True):
            if not quick:
                entry["ms"] = chip_smoke.device_ms(fn)
                if total:
                    totals.setdefault(kind, {}).setdefault(group, {}).setdefault(lab, 0.0)
                    totals[kind][group][lab] += entry["ms"] * max(calls, 1)
            row[kind][lab] = entry

        for tile in (t for t in DQ_TILES if t[0] == dp):
            got = run_dq(dq_fn, a, tile)
            torch.cuda.synchronize()
            timed("dq", label(tile), check("dq", label(tile), (got,), want[:1]),
                  lambda: run_dq(dq_fn, a, tile))
        for tile in (t for t in DKV_TILES if t[0] == dp):
            plan = dkv_splits(b, h, sq, skv, d)
            for splits in sorted({plan, 1}):
                lab = label(tile) + ("" if splits == plan else f"_splits{splits}")
                got = run_dkv(dkv_fn, a, tile, splits)
                torch.cuda.synchronize()
                entry = check("dkv", lab, got, want[1:])
                entry["splits"] = splits
                # the sums are of the plan's split count; unsplit beside it
                timed("dkv", lab, entry, lambda: run_dkv(dkv_fn, a, tile, splits),
                      total=splits == plan)
        # the wrappers as the library builds them
        got = (flash_attention_dq(*a),) + flash_attention_dkv(*a)
        torch.cuda.synchronize()
        row["wrappers"] = check("wrappers", "default", got, want)
        if not quick:
            for kind in ("dq", "dkv"):
                bound_ms, bound_by, ops, _ = chip_smoke.backward_bound(kind, b, h, sq, skv, d)
                fastest = min(row[kind], key=lambda t: row[kind][t]["ms"])
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms, bound_by
                row[f"{kind}_fastest"] = fastest
                row[f"{kind}_fastest_share"] = bound_ms / row[kind][fastest]["ms"]
                row[f"{kind}_fastest_tflops"] = ops / row[kind][fastest]["ms"] / 1e9
            q, k, v, do = (t.detach().requires_grad_() for t in a[:4])
            ol = F.scaled_dot_product_attention(q, k, v)
            row["library_ms"] = chip_smoke.device_ms(
                lambda: torch.autograd.grad(ol, (q, k, v), do, retain_graph=True))
            del q, k, v, do, ol
        print(json.dumps(row), flush=True)
        del a, want, got
        torch.cuda.empty_cache()
    if other:
        after = against(other, site_list)
        print(json.dumps({"against": other, "ms_before": before, "ms_after": after}),
              flush=True)
    built = {}
    for name, kind in ((DQ_NAME, "dq"), (DKV_NAME, "dkv")):
        src = open(os.path.join(kernels.CSRC_DIR, f"{name}.cu")).read()
        built[kind] = {dp: "nc{}_{}_st{}_pp{}".format(*re.search(
            rf"kTile{dp}\[4\] = \{{(\d+), (\d+), (\d+), ([01])\}}", src).groups())
            for dp in (64, 128)}
    print(json.dumps({"ms_summed_over_calls": totals,
                      "fastest": {kind: {group: min(t, key=t.get) for group, t in g.items()}
                                  for kind, g in totals.items()},
                      "built_per_dp": built}), flush=True)
    if bad:
        print(json.dumps({"failed": bad}), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
