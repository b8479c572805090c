#!/usr/bin/env python3
"""The fp32 flash-attention backward kernels (`flash_attention_dq_f32`,
`flash_attention_dkv_f32` in `difashion_tpu_torch/csrc/flash_attention_f32.cu`:
tensor cores, 3xTF32) checked and timed on one CUDA card.

    python3 scripts/flash_bwd_f32.py                  # from the repository root
    python3 scripts/flash_bwd_f32.py --quick          # build, ptxas and SASS report, checks only
    python3 scripts/flash_bwd_f32.py --against DIR    # also time DIR's fp32 dQ and dK/dV
    python3 scripts/flash_bwd_f32.py --phases         # where the wgmma dQ kernel's time goes

It builds the fp32 source and prints each backward instantiation's ptxas
report and, from its SASS, the highest register index, local-memory traffic,
the instruction count and the commonest opcodes (HMMA, the TF32 conversion,
shared loads, ...). Then, in fp32 with TF32 off for PyTorch's own products, at
the edge shapes of the kernels' 64-row tiles (Sq and Skv one below and one
above a tile, d = 4, 20, 36, 100, 128, 4-byte and 16-byte copies) and the
split path at 4096 x 77: dQ, dK and dV against the plain fp32 backward
(relative L2 and per element within F32_TOL) and against the plain 3xTF32
backward, and a second call bit-identical. Without --quick, also at every
attention site of the training step's UNet (sd2_base, the recipe's 8 rows,
d = 64, the [B, S, H, D] layout): each kernel's time, its bounds (3xTF32 at
the TF32 rate; SIMT FFMA at the fp32 rate, the earlier design's) and shares,
the library backward (F.scaled_dot_product_attention's dQ, dK and dV
together, a yardstick only), and dK/dV at several split counts beside the
plan's. With --against DIR the wrappers of the checkout in DIR (built from
its own sources) are timed at the same sites in a process of its own, before
this tree's. With --phases the wgmma dQ kernel, built with
-DF32_PHASE_TIMES, reports the share of its cycles each phase takes at the
training step's self-attention sites. One JSON line per shape or site;
exits non-zero if a check fails.
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

# (name, B, H, Sq, Skv, d): Sq and Skv one below and one above the 64-row
# tiles, head dims up to 128 (16-byte copies: every d here but 17, whose rows
# take 4-byte ones), and the dK/dV split path
EDGE_SHAPES = [("sq63_skv65", 1, 2, 63, 65, 64), ("sq65_skv63", 1, 2, 65, 63, 64),
               ("sq127_skv129_d4", 1, 3, 127, 129, 4), ("sq129_skv127_d20", 2, 1, 129, 127, 20),
               ("d36", 1, 2, 100, 77, 36), ("d100", 1, 2, 130, 200, 100),
               ("d128", 1, 2, 200, 300, 128), ("d17_4byte", 1, 2, 70, 90, 17),
               ("split_4096x77", 8, 5, 4096, 77, 64)]
SPLIT_COUNTS = (1, 2, 3, 4, 6)


BWD_KERNELS = ("dq_tc_kernel", "dkv_tc_kernel", "dq_wg_kernel", "dkv_wg_kernel")


def sass_report(path, names=BWD_KERNELS):
    """{function: highest register, local loads / stores, opcode counts} of
    the kernels `names` (the backward's by default) in the library's SASS
    (cuobjdump from the toolkit); a template's instantiations apart."""
    from difashion_tpu_torch.nn import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    out, cur = {}, None
    pattern = re.compile("(" + "|".join(names) + r")(?:ILi(\d+)E)?")
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            m = pattern.search(ln)
            cur = (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else None
            if cur:
                out[cur] = {"max_reg": 0, "ops": {}}
        elif cur:
            m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", ln)
            if m:
                op = m.group(1) + (m.group(2) or "")
                out[cur]["ops"][op] = out[cur]["ops"].get(op, 0) + 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
            if regs:
                out[cur]["max_reg"] = max(out[cur]["max_reg"], max(regs))
    for rep in out.values():
        ops = rep.pop("ops")
        rep["local_loads"] = sum(n for op, n in ops.items() if op.startswith("LDL"))
        rep["local_stores"] = sum(n for op, n in ops.items() if op.startswith("STL"))
        rep["instructions"] = sum(ops.values())
        rep["ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:24])
    return out


def inputs(b, h, sq, skv, d, gen):
    """q, k, v, dO in the projections' [B, S, H, D] layout, fp32; O and the LSE
    from the forward kernel; D: the backward's arguments."""
    import torch

    from difashion_tpu_torch.nn.kernels.flash_attention import attention_delta, flash_attention

    def proj(s):
        return torch.randn(b, s, h * d, generator=gen, device="cuda").view(b, s, h, d).transpose(1, 2)

    q, k, v, do = proj(sq), proj(skv), proj(skv), proj(sq)
    o, lse = flash_attention(q, k, v)
    return (q, k, v, do, lse, attention_delta(o, do), d ** -0.5), o


def run_dkv_split(args, splits):
    """dK/dV through the split entry at a given split count (1: the plain entry)."""
    import torch

    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.flash_attention import F32_SOURCE, _empty_bshd, _strides

    q, k, v, do, lse, delta, scale = args
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dk, dv = _empty_bshd(b, h, skv, d, k), _empty_bshd(b, h, skv, d, v)
    ws = torch.empty(max(1, 2 * splits * b * h * skv * d), dtype=torch.float32, device=q.device)
    st = (ctypes.c_int64 * 18)(*_strides((q, k, v, do, dk, dv)))
    fn = kernels.load(F32_SOURCE).flash_attention_dkv_split_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), b, h, sq, skv, d,
            splits, ctypes.addressof(st), scale, 2, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_dkv_split_f32 splits {splits}: error {rc}")
    return dk, dv


def against(directory, site_list):
    """Times of the fp32 `flash_attention_dq` and `flash_attention_dkv` of the
    checkout in `directory`, in a process of its own."""
    code = f"""
import json, sys
sys.path.insert(0, {directory!r})
import torch, chip_smoke
from difashion_tpu_torch.nn.kernels import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
out = {{}}
for name, b, h, sq, skv, d, calls in {site_list!r}:
    q, k, v, do = (torch.randn(b, s, h * d, generator=gen, device="cuda")
                   .view(b, s, h, d).transpose(1, 2) for s in (sq, skv, skv, sq))
    o, lse = fa.flash_attention(q, k, v)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), d ** -0.5)
    out[name] = {{"dq_ms": chip_smoke.device_ms(lambda: fa.flash_attention_dq(*args), reps=10),
                 "dkv_ms": chip_smoke.device_ms(lambda: fa.flash_attention_dkv(*args), reps=10)}}
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=directory, timeout=900)
    if res.returncode != 0:
        return {"error": res.stderr[-2000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


PHASES = ("staging", "barrier after staging", "S and dP (wgmma)", "dS and its split",
          "dQ (wgmma)", "barrier after dQ")


def phases(ModelConfig, kernels, source, flash_attention_dq, gen):
    """The wgmma dQ kernel built with -DF32_PHASE_TIMES at the training
    step's self-attention sites: each phase's share of its warpgroups'
    cycles (thread 0 of each, summed over the blocks)."""
    path, _ = kernels.build(source, ("F32_PHASE_TIMES",))
    lib = kernels._LIBS[source] = ctypes.CDLL(str(path))
    read = lib.f32_phase_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    sites = chip_smoke.main_path_attention_sites(ModelConfig.sd2_base(), chip_smoke.TRAIN_ROWS)
    for name, b, h, sq, skv, d, _ in sites:
        if not name.startswith("self"):
            continue
        a, _ = inputs(b, h, sq, skv, d, gen)
        buf = (ctypes.c_ulonglong * 6)()
        flash_attention_dq(*a)
        read(ctypes.addressof(buf))   # the reset
        ms = chip_smoke.device_ms(lambda: flash_attention_dq(*a), reps=5)
        read(ctypes.addressof(buf))
        total = sum(buf)
        print(json.dumps({"site": name, "dq_ms_with_stamps": ms,
                          "share": {p: buf[i] / total for i, p in enumerate(PHASES)}}),
              flush=True)
    kernels._LIBS.pop(source)


def main():
    import torch
    import torch.nn.functional as F

    from difashion_tpu_torch.config import ModelConfig
    from difashion_tpu_torch.nn import kernels
    from difashion_tpu_torch.nn.kernels.flash_attention import (
        F32_SOURCE,
        dkv_splits,
        flash_attention_bwd_3xtf32_ref,
        flash_attention_dkv,
        flash_attention_dkv_ref,
        flash_attention_dq,
        flash_attention_dq_ref,
    )

    if not torch.cuda.is_available():
        print("flash_bwd_f32: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    quick = "--quick" in args
    other = args[args.index("--against") + 1] if "--against" in args else None
    chip_smoke.phase_device()
    if "--phases" in args:
        phases(ModelConfig, kernels, F32_SOURCE, flash_attention_dq,
               torch.Generator(device="cuda").manual_seed(0))
        return
    path, log = kernels.build(F32_SOURCE)
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln or "arning" in ln
                                or "Compiling entry" in ln]}), flush=True)
    print(json.dumps({"sass": sass_report(path)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for name, b, h, sq, skv, d in EDGE_SHAPES:
        a, o = inputs(b, h, sq, skv, d, gen)
        got = (flash_attention_dq(*a),) + flash_attention_dkv(*a)
        again = (flash_attention_dq(*a),) + flash_attention_dkv(*a)
        torch.cuda.synchronize()
        plain = (flash_attention_dq_ref(*a),) + flash_attention_dkv_ref(*a)
        tc = flash_attention_bwd_3xtf32_ref(a[0], a[1], a[2], o, a[4], a[3], a[6])
        row = {"shape": name, "shape_bhqkd": [b, h, sq, skv, d],
               "dkv_splits": dkv_splits(b, h, sq, skv, d, torch.float32),
               "vs_plain": [chip_smoke.rel_l2(g, w) for g, w in zip(got, plain)],
               "vs_3xtf32_plain": [chip_smoke.rel_l2(g, w) for g, w in zip(got, tc)],
               "max_abs_vs_plain": [(g - w).abs().max().item() for g, w in zip(got, plain)],
               "repeat_equal": all(torch.equal(x, y) for x, y in zip(got, again))}
        close = all(torch.allclose(g, w, rtol=chip_smoke.F32_TOL, atol=chip_smoke.F32_TOL)
                    for g, w in zip(got, plain))
        row["ok"] = (close and row["repeat_equal"] and max(row["vs_plain"]) <= chip_smoke.F32_TOL
                     and all(bool(torch.isfinite(g).all()) for g in got))
        if not row["ok"]:
            bad.append(name)
        print(json.dumps(row), flush=True)
        del a, o, got, again, plain, tc
    if quick:
        if bad:
            raise SystemExit(f"flash_bwd_f32: checks failed at {bad}")
        return
    sites = chip_smoke.main_path_attention_sites(ModelConfig.sd2_base(), chip_smoke.TRAIN_ROWS)
    before = against(other, sites) if other else None
    totals = {"dq_ms": 0.0, "dkv_ms": 0.0, "library_ms": 0.0}
    for name, b, h, sq, skv, d, calls in sites:
        a, o = inputs(b, h, sq, skv, d, gen)
        row = {"site": name, "shape_bhqkd": [b, h, sq, skv, d], "calls": calls,
               "dkv_splits": dkv_splits(b, h, sq, skv, d, torch.float32),
               "dq_ms": chip_smoke.device_ms(lambda: flash_attention_dq(*a), reps=10),
               "dkv_ms": chip_smoke.device_ms(lambda: flash_attention_dkv(*a), reps=10)}
        if skv < 128:
            row["dkv_ms_by_splits"] = {
                s: chip_smoke.device_ms(lambda: run_dkv_split(a, s), reps=10)
                for s in SPLIT_COUNTS}
        ql, kl, vl = (t.detach().requires_grad_() for t in a[:3])
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        row["library_ms"] = chip_smoke.device_ms(
            lambda: torch.autograd.grad(ol, (ql, kl, vl), a[3], retain_graph=True), reps=10)
        for kind in ("dq", "dkv"):
            bound, by, ops, _ = chip_smoke.backward_bound(kind, b, h, sq, skv, d, torch.float32)
            simt = chip_smoke.simt_bound_ms(kind, b, h, sq, skv, d)
            row.update({f"{kind}_bound_ms": bound, f"{kind}_bound_by": by,
                        f"{kind}_share": bound / row[f"{kind}_ms"],
                        f"{kind}_simt_bound_ms": simt,
                        f"{kind}_simt_share": simt / row[f"{kind}_ms"],
                        f"{kind}_tflops": ops / row[f"{kind}_ms"] / 1e9})
        if before and name in before:
            row["against"] = before[name]
        for key in totals:
            totals[key] += row[key] * calls
        print(json.dumps(row), flush=True)
        del a, o, ol, ql, kl, vl
        torch.cuda.empty_cache()
    if before and "error" in before:
        print(json.dumps({"against_error": before["error"]}), flush=True)
    if before and "error" not in before:
        totals["against_dq_ms"] = sum(before[n]["dq_ms"] * c for n, *_, c in sites)
        totals["against_dkv_ms"] = sum(before[n]["dkv_ms"] * c for n, *_, c in sites)
    print(json.dumps({"per_fp32_train_step": totals}), flush=True)
    if bad:
        raise SystemExit(f"flash_bwd_f32: checks failed at {bad}")


if __name__ == "__main__":
    main()
