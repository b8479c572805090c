"""ctypes binding to the native C++ image pipeline (`native/difashion_io.cc`).
Counterpart of `difashion_tpu/data/native.py`: JPEG / PNG decode, white
composite, pad to a square, PIL-compatible Lanczos-3 resize and [-1, 1]
normalization, one image at a time or batched over a pthread pool.

The library is built at first use from the source in the checkout, with
`native/Makefile`'s flags (`g++ -O3 -march=native -fPIC -std=c++17 -Wall
-DDFIO_SOURCE_HASH=<sha256 of the source> -shared ... -ljpeg -lpng
-lpthread`; `CXX` overrides the compiler), into
`difashion_tpu_torch/_build/libdifashion_io-<hash>.so`. The binary committed
under `native/` is never loaded: it was built on another machine. A library
whose embedded hash differs from the source on disk is refused (stale), as
the JAX package refuses it.

Where the library cannot be built (no compiler, no libjpeg / libpng
headers), `native_available()` is False with the reason in `unavailable()`,
and `cli/extract_features.py` takes the PIL pipeline instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC_PATH = _PKG.parent / "native" / "difashion_io.cc"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

log = logging.getLogger("difashion_tpu_torch")
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_LOCK = threading.Lock()


def source_hash(path: Path = SRC_PATH) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def build(src: Path = SRC_PATH, out_dir: Path = BUILD_DIR) -> Path:
    """Compile `src` unless a library of the same source hash is there.
    Returns the library's path; raises RuntimeError when the compiler fails."""
    digest = source_hash(src)
    out = Path(out_dir) / f"libdifashion_io-{digest[:16]}.so"
    if out.exists():
        return out
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, f'-DDFIO_SOURCE_HASH="{digest}"',
           "-shared", "-o", str(tmp), str(src), *LDLIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:   # no compiler at all
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def check_fresh(lib: ctypes.CDLL, path, src: Path = SRC_PATH) -> None:
    """Raise OSError when the library was built from another source than
    the one on disk (its `dfio_source_hash()` is the sha256 it was built
    from)."""
    try:
        lib.dfio_source_hash.restype = ctypes.c_char_p
        built_from = lib.dfio_source_hash().decode()
    except AttributeError:
        built_from = "<pre-hash binary>"
    current = source_hash(src)
    if built_from != current:
        raise OSError(f"stale native library {path}: built from source hash "
                      f"{built_from[:12]}, the source on disk is {current[:12]}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dfio_prepare_image.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float)]
    lib.dfio_prepare_image.restype = ctypes.c_int
    lib.dfio_image_size.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    lib.dfio_image_size.restype = ctypes.c_int
    lib.dfio_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int]
    lib.dfio_loader_create.restype = ctypes.c_void_p
    lib.dfio_loader_load.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.dfio_loader_load.restype = ctypes.c_int64
    lib.dfio_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_library(path) -> ctypes.CDLL:
    """Load a built library after the freshness check."""
    lib = ctypes.CDLL(str(path))
    check_fresh(lib, path)
    return _bind(lib)


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _LOCK:
        if _lib is None:
            if _error is not None:
                raise OSError(_error)
            try:
                _lib = load_library(build())
            except (OSError, RuntimeError) as e:
                _error = f"native image library unavailable: {e}"
                raise OSError(_error) from e
        return _lib


def native_available() -> bool:
    """Build (once) and load the library; False, with a warning, where that
    fails."""
    try:
        _load()
        return True
    except OSError:
        log.warning("%s", _error)
        return False


def unavailable() -> Optional[str]:
    """Why the library could not be built or loaded, None if it was not."""
    return _error


def prepare_image(path: str, size: int = 512) -> np.ndarray:
    """Decode + composite + pad + Lanczos resize -> [size, size, 3] float32 in [-1, 1]."""
    lib = _load()
    out = np.empty((size, size, 3), np.float32)
    if not lib.dfio_prepare_image(path.encode(), size,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise IOError(f"failed to decode {path}")
    return out


class NativeCatalogLoader:
    """Thread-pooled batch loader over a fixed list of catalog paths."""

    def __init__(self, paths: Sequence[str], size: int = 512, n_threads: int = 0):
        self._lib = _load()
        self.size = size
        self.last_failed = 0
        self._paths_buf = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths_buf))(*self._paths_buf)
        self._handle = self._lib.dfio_loader_create(arr, len(self._paths_buf), size, n_threads)
        if not self._handle:
            raise OSError("failed to create the native loader")

    def load(self, ids: Sequence[int]) -> np.ndarray:
        """ids -> [n, size, size, 3] float32 in [-1, 1]; a failed decode
        becomes the white null image (the catalog's convention), counted in
        `last_failed` and warned."""
        if self._handle is None:
            raise ValueError("loader is closed")
        ids_arr = np.ascontiguousarray(ids, np.int64)
        out = np.empty((len(ids_arr), self.size, self.size, 3), np.float32)
        failed = self._lib.dfio_loader_load(
            self._handle, ids_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids_arr), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        self.last_failed = int(failed)
        if failed:
            log.warning("native loader: %d/%d decodes failed (substituted the white null "
                        "image): check the catalog paths", failed, len(ids_arr))
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.dfio_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
