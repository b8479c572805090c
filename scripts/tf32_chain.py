#!/usr/bin/env python3
"""The 3xTF32 product chain of the fp32 dQ kernel by mma.sync and by wgmma on
one CUDA card: the comparison behind the fp32 backward's choice of mma.sync.

    python3 scripts/tf32_chain.py        # from the repository root

Builds `scripts/tf32_chain.cu` (which includes `csrc/flash_attention_f32.cu`
and `csrc/hopper_common.cuh`) with nvcc for sm_90a and times, with CUDA
events:
  * peak_mma: independent mma.sync.m16n8k8.tf32 on registers;
  * peak_wgmma_n64 / _n128: wgmma.m64nNk8.tf32 from shared memory;
  * chain_mma: the dQ kernel's chain (S, dP, dS, dQ += dS K in 3xTF32 with the
    kernel's own device functions) on resident tiles, at self_4096's work
    (40 heads x 64 Q tiles x 64 KV tiles of 64 x 64 at d = 64);
  * chain_wgmma: the same chain by wgmma, 128 rows a block, the KV tile's
    hi / lo and transposed copies staged in shared memory per tile.
One JSON line each: ms, TFLOP/s of TF32 products, and for the chains the
fp32-equivalent rate (a third of it) and the share of the 495 TFLOP/s TF32
peak.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (stdlib only at import)

SM = 132
SELF_4096_TILES = 40 * 64 * 64          # (head, Q tile, KV tile) triples of self_4096 at 8 rows
CHAIN_FLOP = SELF_4096_TILES * 3 * 3 * 2 * 64 ** 3   # 3 products, 3 TF32 passes each


def build():
    """nvcc the prototype into the port's build directory (the form without
    wgmma's immediate scales if the first is refused). Returns (path, log)."""
    from difashion_tpu_torch.nn import kernels

    src = os.path.join(ROOT, "scripts", "tf32_chain.cu")
    h = hashlib.sha256(open(src, "rb").read())
    for name in ("flash_attention_f32.cu", "hopper_common.cuh"):
        h.update((kernels.CSRC_DIR / name).read_bytes())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    for defines in ((), ("-DTF32_NO_IMM_SCALE",)):
        out = kernels.BUILD_DIR / f"libtf32_chain-{h.hexdigest()[:16]}{len(defines)}.so"
        cmd = [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defines, "-o", str(out), src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode == 0:
            return out, logs[-1]
    raise RuntimeError("nvcc failed for tf32_chain.cu:\n" + "\n".join(logs))


def main():
    import torch

    if not torch.cuda.is_available():
        print("tf32_chain: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    chip_smoke.phase_device()
    path, log = build()
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln or "rror" in ln]}),
          flush=True)
    fn = ctypes.CDLL(str(path)).tf32_chain_run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    src = torch.randn(1 << 20, device="cuda")
    out = torch.empty(2560 * 256, device="cuda")
    cases = [  # (name, which, blocks, iters, TF32 FLOP)
        ("peak_mma", 0, SM * 4, 4096, SM * 4 * 4 * 4096 * 8 * 2 * 16 * 8 * 8),
        ("peak_wgmma_n64", 1, SM * 4, 2048, SM * 4 * 2048 * 4 * 2 * 64 * 64 * 8),
        ("peak_wgmma_n128", 2, SM * 4, 2048, SM * 4 * 2048 * 4 * 2 * 64 * 128 * 8),
        ("chain_mma", 3, SELF_4096_TILES // 64, 64, CHAIN_FLOP),
        ("chain_wgmma", 4, SELF_4096_TILES // 128, 64, CHAIN_FLOP),
    ]
    for name, which, blocks, iters, flop in cases:
        def run():
            rc = fn(which, src.data_ptr(), out.data_ptr(), blocks, iters,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(run, reps=10)
        row = {"case": name, "ms": ms, "tf32_tflops": flop / ms / 1e9,
               "share_of_tf32_peak": flop / ms / 1e9 / (chip_smoke.PEAK_TF32_FLOPS / 1e12)}
        if name.startswith("chain"):
            row["fp32_equivalent_tflops"] = row["tf32_tflops"] / 3
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
