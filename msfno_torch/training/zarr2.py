"""zarr v2 arrays over a key-value store: the leaves of an Orbax checkpoint.

An array `name` is the key `name/.zarray` (JSON: shape, chunks, dtype,
compressor, fill value, order, dimension separator) and one key per chunk,
`name/i.j...` (`name/0` for a scalar).  Chunks are C-ordered bytes at the
whole chunk shape (edge chunks padded), zstd-compressed or stored as they
are; a chunk that is absent holds the fill value.

`read_array` returns a CPU tensor; `array_items` writes one array as one
chunk (this package saves whole arrays).
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from msfno_torch.utils import zstd

# zarr v2 dtype -> (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "<f2": (np.float16, torch.float16), "<f4": (np.float32, torch.float32),
    "<f8": (np.float64, torch.float64), "bfloat16": (np.uint16, torch.bfloat16),
    "|i1": (np.int8, torch.int8), "<i2": (np.int16, torch.int16),
    "<i4": (np.int32, torch.int32), "<i8": (np.int64, torch.int64),
    "|u1": (np.uint8, torch.uint8), "|b1": (np.bool_, torch.bool),
}
_ZARR_OF_TORCH = {t: z for z, (_, t) in DTYPES.items()}
_SPECIAL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _fill(value, zdtype: str):
    """The fill value as a scalar of the stored numpy dtype."""
    np_dtype = DTYPES[zdtype][0]
    if value is None:
        return np_dtype(0)
    value = _SPECIAL.get(value, value)
    if zdtype == "bfloat16":
        return np.uint16(torch.tensor(value, dtype=torch.bfloat16).view(torch.int16).item()
                         & 0xFFFF)
    return np_dtype(value)


def _chunk_key(name: str, idx, sep: str) -> str:
    return f"{name}/{sep.join(map(str, idx)) if idx else '0'}"


def read_array(store, name: str) -> torch.Tensor:
    """The array `name` of `store` (an `OcdbtReader`) as a CPU tensor."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    zdtype = meta["dtype"]
    if zdtype not in DTYPES:
        raise NotImplementedError(f"{name}: zarr dtype {zdtype!r} is not read here")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise NotImplementedError(f"{name}: only C-ordered arrays without filters are read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{name}: compressor {comp.get('id')!r} is not read here")
    sep = meta.get("dimension_separator", ".")
    np_dtype = DTYPES[zdtype][0]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{name}: shape {shape} and chunks {chunks} differ in rank")
    out = np.empty(shape, dtype=np_dtype)
    chunk_bytes = math.prod(chunks) * np.dtype(np_dtype).itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    whole = shape == chunks
    for idx in itertools.product(*(range(g) for g in grid)):
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        key = _chunk_key(name, idx, sep)
        if key not in store:
            out[region] = _fill(meta.get("fill_value"), zdtype)
            continue
        raw = store.read(key)
        buf = out.reshape(-1).view(np.uint8) if whole else np.empty(chunk_bytes, np.uint8)
        if comp is None:
            if len(raw) != chunk_bytes:
                raise ValueError(f"{key}: {len(raw)} bytes, the chunk has {chunk_bytes}")
            buf[:] = np.frombuffer(raw, np.uint8)
        elif zstd.decompress_into(raw, buf) != chunk_bytes:
            raise ValueError(f"{key}: decodes to fewer bytes than its chunk's {chunk_bytes}")
        if not whole:
            chunk = buf.view(np_dtype).reshape(chunks)
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if zdtype == "bfloat16" else t


def _zarr_dtype(t: torch.Tensor) -> str:
    if t.dtype not in _ZARR_OF_TORCH:
        raise TypeError(f"no zarr v2 dtype is written for {t.dtype}")
    return _ZARR_OF_TORCH[t.dtype]


def array_items(name: str, t: torch.Tensor) -> dict[str, list]:
    """The keys of `t` saved as the array `name`: its `.zarray` and one
    chunk, a zstd frame of Raw/RLE blocks (key -> byte strings)."""
    t = t.detach().cpu().contiguous()
    if t.numel() == 0:
        raise ValueError(f"{name}: an array without elements cannot be saved")
    shape = list(t.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _zarr_dtype(t), "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return {f"{name}/.zarray": [json.dumps(meta, separators=(",", ":")).encode()],
            _chunk_key(name, [0] * len(shape), "."): zstd.frame_parts(raw)}
