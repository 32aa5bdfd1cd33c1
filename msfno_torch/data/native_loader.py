"""ctypes bindings for the native C++ batch reader, `native/loader.cpp` (port
of msfno_tpu/data/native_loader.py; the C++ source is shared, unchanged).

At first use the reader is compiled with g++ into `msfno_torch/_build/`
(named by a hash of its source, published atomically from a private
temporary name, so a second process never loads a half-written library).
It reads a whole batch of .npy frame files with a C++ thread pool into one
preallocated fp32 buffer.  Without a compiler it falls back to numpy, with a
warning; `get_lib() is not None` (and a backend's `native`) says which path
reads take.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("msfno_torch")

SRC_PATH = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None  # None: not tried yet; False: the numpy fallback
_lock = threading.Lock()


def library_path() -> Path:
    """Where the reader is built: its name carries a hash of the source and
    the flags, so an edited source is rebuilt."""
    digest = hashlib.sha1(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmsfno_loader-{digest}.so"


def _build() -> Path | None:
    out = library_path()
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.build{os.getpid()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC_PATH), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native loader build failed (%s); using the numpy fallback", e)
        tmp.unlink(missing_ok=True)
        return None


def get_lib():
    """The loaded reader, or None when reads take the numpy fallback."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        path = _build()
        if path is None:
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:  # a corrupt library: honour the fallback
            log.warning("native loader %s unloadable (%s); using the numpy fallback", path, e)
            _lib = False
            return None
        lib.msfno_npy_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.msfno_npy_info.restype = ctypes.c_int
        lib.msfno_load_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ]
        lib.msfno_load_npy_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def npy_info(path: str) -> tuple[tuple[int, ...], int]:
    """(shape, word size) of an .npy file, without reading its data."""
    lib = get_lib()
    if lib is None:
        with open(path, "rb") as f:
            ver = np.lib.format.read_magic(f)
            shape, _, dtype = np.lib.format._read_array_header(f, ver)
        return shape, dtype.itemsize
    shape_buf = (ctypes.c_int64 * 8)()
    ndim, ws = ctypes.c_int(), ctypes.c_int()
    rc = lib.msfno_npy_info(str(path).encode(), shape_buf, ctypes.byref(ndim), ctypes.byref(ws))
    if rc != 0:
        raise IOError(f"msfno_npy_info({path}) failed: {rc}")
    return tuple(shape_buf[: ndim.value]), ws.value


def load_npy_batch(paths: list[str], item_shape: tuple[int, ...], n_threads: int = 8,
                   out: np.ndarray | None = None) -> np.ndarray:
    """Read len(paths) .npy files into one (N, *item_shape) fp32 array.  A
    file of another element count is an error; integer and fp64 files are
    converted by value."""
    n = len(paths)
    per_item = int(np.prod(item_shape))
    if out is None:
        out = np.empty((n, *item_shape), dtype=np.float32)
    if out.size != n * per_item or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous fp32 array of {n * per_item} elements")
    lib = get_lib()
    if lib is None:
        for i, p in enumerate(paths):
            out[i] = np.load(p).astype(np.float32).reshape(item_shape)
        return out
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.msfno_load_npy_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  per_item, n_threads)
    if rc != 0:
        raise IOError(f"native batch load failed on file index {-rc - 1}: {paths[-rc - 1]}")
    return out


class NativeNpyBackend:
    """era5.NpyBackend's store read through the C++ reader only (every read,
    single frames too, lands in fp32)."""

    def __init__(self, root: str, n_threads: int = 8):
        self.root = root
        self.n_threads = n_threads
        files = sorted(f for f in os.listdir(root) if f.startswith("era5_"))
        self.n = len(files)
        if self.n == 0:
            raise FileNotFoundError(f"no era5_*.npy files under {root}")
        self.item_shape, _ = npy_info(os.path.join(root, files[0]))
        self.has_sst = os.path.exists(os.path.join(root, "sst_000000.npy"))
        if self.has_sst:
            self.sst_shape, _ = npy_info(os.path.join(root, "sst_000000.npy"))

    @property
    def native(self) -> bool:
        """True when reads go through the C++ reader (not the fallback)."""
        return get_lib() is not None

    def __len__(self):
        return self.n

    def _path(self, kind: str, idx: int) -> str:
        return os.path.join(self.root, f"{kind}_{idx:06d}.npy")

    def era5(self, idx: int) -> np.ndarray:
        return self.era5_batch([idx])[0]

    def era5_batch(self, idcs) -> np.ndarray:
        return load_npy_batch([self._path("era5", i) for i in idcs], self.item_shape,
                              self.n_threads)

    def sst(self, idx: int) -> np.ndarray | None:
        return None if not self.has_sst else self.sst_batch([idx])[0]

    def sst_batch(self, idcs) -> np.ndarray | None:
        if not self.has_sst:
            return None
        return load_npy_batch([self._path("sst", i) for i in idcs], self.sst_shape,
                              self.n_threads)
