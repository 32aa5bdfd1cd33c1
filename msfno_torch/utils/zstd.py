"""zstd frames and crc32c without a compression package.

Reading: `decompress` / `decompress_into` call the decoder of
`msfno_torch/csrc/zstd_decode.cpp` (RFC 8878: every block, literals and
sequence-table type, repeat offsets, the content checksum, concatenated
and skippable frames; a dictionary ID raises).  At first use it is compiled
with g++ into `msfno_torch/_build/` (named by a hash of its source,
published atomically from a private temporary name) and bound with ctypes.
There is no fallback: a failed build or load raises with the compiler's
output.

Writing: `frame` / `frame_parts` emit a valid frame made only of Raw blocks
and, where a block is one repeated byte (Adam's zero moments), RLE blocks.
Such frames need no compressor and every zstd decoder reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_PATH = Path(__file__).resolve().parents[1] / "csrc" / "zstd_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK = 128 * 1024  # the largest block a frame may hold

_lib = None
_lock = threading.Lock()
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha1(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmsfno_zstd-{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.build{os.getpid()}")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC_PATH)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC_PATH.name}: g++ could not run ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC_PATH.name} failed (g++ rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded decoder library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            size_t, char_p = ctypes.c_size_t, ctypes.c_char_p
            lib.msfno_zstd_decompress.argtypes = [_u8p, size_t, _u8p, size_t,
                                                  ctypes.POINTER(size_t), char_p, size_t]
            lib.msfno_zstd_decompress.restype = ctypes.c_int
            lib.msfno_zstd_decompress_alloc.argtypes = [_u8p, size_t, ctypes.POINTER(_u8p),
                                                        ctypes.POINTER(size_t), char_p, size_t]
            lib.msfno_zstd_decompress_alloc.restype = ctypes.c_int
            lib.msfno_zstd_free.argtypes = [_u8p]
            lib.msfno_zstd_free.restype = None
            lib.msfno_crc32c.argtypes = [_u8p, size_t, ctypes.c_uint32]
            lib.msfno_crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def _bytes_view(data) -> np.ndarray:
    """`data` (bytes, bytearray, memoryview, numpy array) as flat uint8,
    without a copy where it is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of `data` into `out` (a contiguous array, viewed
    as bytes); returns the bytes decoded.  More than `out` holds raises."""
    src = _bytes_view(data)
    dst = out.reshape(-1).view(np.uint8)
    if not dst.flags.c_contiguous:
        raise ValueError("decompress_into needs a contiguous output array")
    written = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    rc = get_lib().msfno_zstd_decompress(_ptr(src), src.size, _ptr(dst), dst.size,
                                         ctypes.byref(written), err, len(err))
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return written.value


def decompress(data) -> bytes:
    """Every frame of `data`, decoded."""
    src = _bytes_view(data)
    out, written = _u8p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    lib = get_lib()
    rc = lib.msfno_zstd_decompress_alloc(_ptr(src), src.size, ctypes.byref(out),
                                         ctypes.byref(written), err, len(err))
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, written.value)
    finally:
        lib.msfno_zstd_free(out)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    src = _bytes_view(data)
    return int(get_lib().msfno_crc32c(_ptr(src), src.size, crc))


def _frame_header(n: int) -> bytes:
    """Magic, a single-segment descriptor and the content size (the window
    is the content)."""
    if n < 256:
        return MAGIC + bytes([0x20]) + n.to_bytes(1, "little")
    if n < 65536 + 256:
        return MAGIC + bytes([0x60]) + (n - 256).to_bytes(2, "little")
    if n < 2**32:
        return MAGIC + bytes([0xA0]) + n.to_bytes(4, "little")
    return MAGIC + bytes([0xE0]) + n.to_bytes(8, "little")


def _uniform_blocks(a: np.ndarray) -> np.ndarray:
    """For each BLOCK of `a` (the last one possibly shorter), whether it
    is one repeated byte."""
    nfull = a.size // BLOCK
    full = a[: nfull * BLOCK].reshape(-1, BLOCK)
    out = np.empty(nfull + (a.size > nfull * BLOCK), dtype=bool)
    for i in range(0, nfull, 64):  # 8 MiB at a time: no full-size temporary
        part = full[i:i + 64]
        out[i:i + part.shape[0]] = part.min(axis=1) == part.max(axis=1)
    if out.size > nfull:
        tail = a[nfull * BLOCK:]
        out[-1] = tail.min() == tail.max()
    return out


def frame_parts(data) -> list:
    """A zstd frame of `data` as a list of byte strings to write one after
    another: Raw blocks, and RLE blocks for blocks of one repeated byte."""
    a = _bytes_view(data)
    n = a.size
    parts = [_frame_header(n)]
    uniform = _uniform_blocks(a)
    starts = range(0, n, BLOCK) if n else [0]
    for i, s in enumerate(starts):
        size = min(BLOCK, n - s)
        last = int(s + size >= n)
        if size and uniform[i]:
            parts.append((last | 1 << 1 | size << 3).to_bytes(3, "little") + a[s:s + 1].tobytes())
        else:
            parts.append((last | size << 3).to_bytes(3, "little"))
            parts.append(memoryview(a[s:s + size]))
    return parts


def frame(data) -> bytes:
    """A zstd frame of `data` (Raw and RLE blocks)."""
    return b"".join(frame_parts(data))
