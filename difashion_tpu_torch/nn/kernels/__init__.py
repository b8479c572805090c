"""Hand-written CUDA kernels for Hopper and their build.

Each kernel's source is `difashion_tpu_torch/csrc/<name>.cu` (with the shared
headers `csrc/*.cuh`), compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface at first use (into `difashion_tpu_torch/_build/`,
keyed by the hash of the source and the headers) and loaded with `ctypes`. Nothing here is compiled or loaded at import time, so
the package imports on machines without a GPU or a CUDA toolkit.

`LAUNCHES` counts, per kernel, the launches its wrapper has made. A run resets
it with `reset_launches()` and reads it afterwards to show which kernels a
path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def build(name: str) -> Tuple[Path, str]:
    """Compile `csrc/<name>.cu` for sm_90a unless a library built from the same
    source exists. Returns (library path, compiler log: ptxas register and
    spill report, empty when the library was already built)."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(src),
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
