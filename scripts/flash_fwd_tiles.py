#!/usr/bin/env python3
"""The flash-attention forward kernel (`difashion_tpu_torch/csrc/flash_attention_fwd.cu`)
at every tile it can be built with, on one CUDA card.

    python3 scripts/flash_fwd_tiles.py                  # from the repository root
    python3 scripts/flash_fwd_tiles.py --quick          # build, ptxas report, one check a tile
    python3 scripts/flash_fwd_tiles.py --against DIR    # also time DIR's flash_attention

It builds the kernel with -DFLASH_FWD_ALL_TILES (every candidate tile: 2 or 3
consumer warpgroups, i.e. a 128- or 192-row Q tile; a KV tile of 128 or 176
rows; 2 or 3 stages; for the padded head dims 64 and 128 where the registers
and shared memory allow), prints its ptxas report per tile, then at every
attention site of the sampler's UNet forward (sd2_base, batch 16, d = 64) and
of the sd15 UNet's (batch 16, 8 heads: d = 40 and 80), in bf16 with the
projections' [B, S, H, D] layout: each tile against the plain version (the
gates of chip_smoke.py) and its time, beside F.scaled_dot_product_attention's
(a yardstick only) and the bound. One JSON line per site; last, per model
and padded head dim, the tile with the least time summed over its sites'
calls per UNet forward (the sd2_base sum decides head dim 64: the main
path's), and the tile the library is built with. The ptxas report and the
SASS's highest register index and local-memory traffic per tile come first. With --against DIR, the `flash_attention` of
the checkout in DIR (an earlier version of the kernel, built from DIR's own
sources) is timed at the same sites in a process of its own, before and after
this tree's, and printed beside. Exits non-zero if any check fails.
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

DEFINE = "FLASH_FWD_ALL_TILES"
# (padded head dim, consumer warpgroups, KV tile, stages): the candidates the
# source instantiates under DEFINE
TILES = [(64, 2, 128, 2), (64, 2, 128, 3), (64, 2, 176, 2), (64, 2, 176, 3),
         (64, 3, 128, 2), (64, 3, 128, 3), (128, 2, 128, 2)]
QUICK_SHAPE = ("quick", 2, 5, 1000, 333, 64, 1)


def sites():
    """(name, B, H, Sq, Skv, d, calls per UNet forward): the sampler's sites
    (sd2_base) and the sd15 UNet's at the same batch."""
    from difashion_tpu_torch.config import ModelConfig

    sd2 = chip_smoke.main_path_attention_sites(ModelConfig.sd2_base(), chip_smoke.UNET_BATCH)
    sd15 = chip_smoke.main_path_attention_sites(ModelConfig.sd15(), chip_smoke.UNET_BATCH)
    return sd2 + [(f"sd15_{n}", *rest) for n, *rest in sd15 if rest[-2] <= 128]


def tile_fn(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_fwd_tile
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_tile(fn, q, k, v, tile):
    """(o, lse) of the kernel at `tile` = (dp, nc, bkv, stages)."""
    import torch

    from difashion_tpu_torch.nn.kernels.flash_attention import _empty_bshd, _strides

    b, h, sq, d = q.shape
    o = _empty_bshd(b, h, sq, d, q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    st = _strides((q, k, v, o))
    arr = (ctypes.c_int64 * 12)(*st)
    _, nc, bkv, stages = tile
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, sq,
            k.shape[2], d, ctypes.addressof(arr), d ** -0.5, nc, bkv, stages,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd_tile {tile}: error {rc}")
    return o, lse


def proj(b, s, h, d, gen):
    import torch

    return (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
            .view(b, s, h, d).transpose(1, 2))


def ptxas_by_tile(log):
    """{tile label: [ptxas lines]} from the compiler's report."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"flash_fwd_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if m:
            cur = f"{m.group(1)[-8:]} dp{m.group(2)} nc{m.group(3)} bkv{m.group(4)} st{m.group(5)}"
            out[cur] = []
        elif cur and ("registers" in ln or "spill" in ln or "arning" in ln):
            out[cur].append(ln.strip())
    return out


def sass_by_tile(path):
    """{tile label: highest register index, local-memory loads and stores} in
    the SASS of each instantiation (cuobjdump from the CUDA toolkit): a
    register index past what __launch_bounds__ allows means the consumers
    are allocated the registers setmaxnreg gives them."""
    from difashion_tpu_torch.nn import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    out, cur = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : .*flash_fwd_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if m:
            cur = f"{m.group(1)[-8:]} dp{m.group(2)} nc{m.group(3)} bkv{m.group(4)} st{m.group(5)}"
            out[cur] = {"max_reg": 0, "local_loads": 0, "local_stores": 0}
        elif cur:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
            if regs:
                out[cur]["max_reg"] = max(out[cur]["max_reg"], max(regs))
            out[cur]["local_loads"] += " LDL" in ln
            out[cur]["local_stores"] += " STL" in ln
    return out


def against(directory, site_list):
    """Times of `flash_attention` from the checkout in `directory`, in a
    process of its own (its package, its sources, its build)."""
    code = f"""
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.nn.kernels.flash_attention import flash_attention
gen = torch.Generator(device="cuda").manual_seed(0)
out = {{}}
for name, b, h, sq, skv, d, calls in {site_list!r}:
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
               .view(b, s, h, d).transpose(1, 2) for s in (sq, skv, skv))
    try:
        out[name] = chip_smoke.device_ms(lambda: flash_attention(q, k, v))
    except Exception as e:
        out[name] = str(e)[:200]
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=directory, timeout=900)
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.flash_attention import NAME, flash_attention_ref

    if not torch.cuda.is_available():
        print("flash_fwd_tiles: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    quick = "--quick" in args
    other = args[args.index("--against") + 1] if "--against" in args else None
    chip_smoke.phase_device()
    path, log = kernels.build(NAME, (DEFINE,))
    print(json.dumps({"ptxas": ptxas_by_tile(log)}), flush=True)
    print(json.dumps({"sass": sass_by_tile(path)}), flush=True)
    fn = tile_fn(path)
    site_list = [QUICK_SHAPE] if quick else sites()
    before = against(other, site_list) if other else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad, totals = [], {}
    for name, b, h, sq, skv, d, calls in site_list:
        q, k, v = (proj(b, s, h, d, gen) for s in (sq, skv, skv))
        ro, rlse = flash_attention_ref(q.float(), k.float(), v.float())
        dp = 64 if d <= 64 else 128
        row = {"site": name, "shape_bhqkd": [b, h, sq, skv, d], "calls": calls, "tiles": {}}
        for tile in (t for t in TILES if t[0] == dp):
            o, lse = run_tile(fn, q, k, v, tile)
            torch.cuda.synchronize()
            err = (o.float() - ro).abs()
            ok = (err.max().item() <= chip_smoke.MAX_ABS_TOL
                  and err.mean().item() <= chip_smoke.MEAN_ABS_TOL
                  and (lse - rlse).abs().max().item() <= chip_smoke.LSE_TOL
                  and bool(torch.isfinite(o).all()))
            label = f"nc{tile[1]}_bkv{tile[2]}_st{tile[3]}"
            entry = {"max_abs_err": err.max().item(), "ok": ok}
            if not quick:
                entry["ms"] = chip_smoke.device_ms(lambda: run_tile(fn, q, k, v, tile))
                group = f"{'sd15' if name.startswith('sd15') else 'sd2_base'} dp{dp}"
                totals.setdefault(group, {}).setdefault(label, 0.0)
                totals[group][label] += entry["ms"] * max(calls, 1)
            row["tiles"][label] = entry
            if not ok:
                bad.append((name, label))
            del o, lse, err
        if not quick:
            bound_ms, bound_by, ops, _ = chip_smoke.attention_bound(b, h, sq, skv, d)
            row.update(sdpa_ms=chip_smoke.device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
                bound_ms=bound_ms, bound_by=bound_by)
            fastest = min(row["tiles"], key=lambda t: row["tiles"][t]["ms"])
            row["fastest"] = fastest
            row["fastest_share_of_bound"] = bound_ms / row["tiles"][fastest]["ms"]
            row["fastest_tflops"] = ops / row["tiles"][fastest]["ms"] / 1e9
        print(json.dumps(row), flush=True)
        del q, k, v, ro, rlse
        torch.cuda.empty_cache()
    if other:
        after = against(other, site_list)
        print(json.dumps({"against": other, "ms_before": before, "ms_after": after}),
              flush=True)
    src = open(os.path.join(kernels.CSRC_DIR, f"{NAME}.cu")).read()
    built = {dp: re.search(rf"kTile{dp}\[3\] = \{{(\d+), (\d+), (\d+)\}}", src).groups()
             for dp in (64, 128)}
    print(json.dumps({"ms_summed_over_calls": totals,
                      "fastest": {group: min(t, key=t.get) for group, t in totals.items()},
                      "built_per_dp": {dp: "nc{}_bkv{}_st{}".format(*g)
                                       for dp, g in built.items()}}), flush=True)
    if bad:
        print(json.dumps({"failed": bad}), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
