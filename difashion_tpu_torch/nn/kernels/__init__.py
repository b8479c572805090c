"""Hand-written CUDA kernels for Hopper and their build.

Each kernel's source is `difashion_tpu_torch/csrc/<name>.cu` (with the shared
headers `csrc/*.cuh`), compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface at first use (into `difashion_tpu_torch/_build/`,
keyed by the hash of the source and the headers) and loaded with `ctypes`. Nothing here is compiled or loaded at import time, so
the package imports on machines without a GPU or a CUDA toolkit.

`LAUNCHES` counts, per kernel, the launches its wrapper has made (the fp32
flash source's three kernels and the fp32 skinny-N kernel under names of
their own, so that the 16-bit counts of a path stay exact; the fused GEGLU
kernel under its own, apart from the skinny-N kernel's). A run resets it
with `reset_launches()` and reads it afterwards to show which kernels a path
went through.

`plain_versions()` is the one switch between the kernels and their plain
PyTorch versions: while it is open, the kernels' callers (`nn.attention.sdpa`,
`nn.layers.GroupNorm`, `nn.layers.Dense`, `nn.layers.GEGLU`) compute the
plain versions on any device, so that a run can hold the kernel path against
it. The wrappers themselves never read it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Iterator, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_f32", "group_norm_silu", "skinny_matmul", "skinny_matmul_f32",
           "geglu_matmul")
COUNTERS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
            "flash_attention_fwd_f32", "flash_attention_dq_f32", "flash_attention_dkv_f32",
            "group_norm_silu", "skinny_matmul", "skinny_matmul_f32", "geglu_matmul")
LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_THREAD = threading.local()   # the devices whose context each thread has bound
_plain = False


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Within this context every kernel's caller (`sdpa`, `GroupNorm`,
    `Dense`, `GEGLU`) computes the kernel's plain version instead, forward
    and backward. The flag is process-wide, not
    per thread, because autograd runs a CUDA backward (and the recompute of a
    checkpointed block) on a thread of its own: run the backward of a plain
    forward inside the context too."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def plain_active() -> bool:
    return _plain


def bind_context(device: int) -> None:
    """Make `device`'s primary context current on the calling thread, once
    per thread, before a launch: its driver calls (the TMA tensor maps'
    encoding) need one, and a thread that has made no CUDA runtime call yet,
    such as the one autograd starts for a CUDA backward whose first operation
    is a kernel's launch, has none (the encode fails with
    CUDA_ERROR_INVALID_CONTEXT)."""
    bound = getattr(_THREAD, "devices", None)
    if bound is None:
        bound = _THREAD.devices = set()
    if device not in bound:
        import torch

        # a runtime call under the stream's device guard binds the context
        torch.cuda.current_stream(device).query()
        bound.add(device)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build(name: str, defines: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile `csrc/<name>.cu` for sm_90a (with `-D` of each of `defines`)
    unless a library built from the same source and defines exists. Returns
    (library path, compiler log: ptxas register and spill report, empty when
    the library was already built)."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(repr(defines).encode())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *(f"-D{d}" for d in defines), "-o", str(tmp), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build several kernels at once, one nvcc process each. Returns the
    compiler log of each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = list(pool.map(build, names))
    return {name: log for name, (_, log) in zip(names, results)}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
