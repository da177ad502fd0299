"""COCO RLE mask codec: a ctypes wrapper over the native library, with a
numpy path.

Port of ``gdrnpp_bop2022_tpu/utils/mask_rle.py`` (role of the reference's
pycocotools-based lib/utils/mask_utils.py): column-major runs and COCO's
compressed string, so RLE annotations in BOP / COCO jsons interoperate. The
native library is ``native/rle.cpp``, built with g++ at first use into
``gdrnpp_bop2022_torch/_build/`` (``utils/cuda_build.load_host_library``);
where it cannot be built or loaded, the numpy path gives the same bytes.
Host code: masks are numpy arrays.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

RLE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "rle.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load_native() -> Optional[ctypes.CDLL]:
    """The native codec, built and loaded once; None where that fails."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from .cuda_build import load_host_library
    try:
        lib = load_host_library(RLE_SOURCE)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.rle_encode_counts.restype = ctypes.c_int64
    lib.rle_counts_to_string.restype = ctypes.c_int64
    lib.rle_string_to_counts.restype = ctypes.c_int64
    lib.rle_area.restype = ctypes.c_int64
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.rle_encode_counts.argtypes = [p, i64, i64, p, i64]
    lib.rle_decode_counts.argtypes = [p, i64, i64, i64, p]
    lib.rle_decode_counts.restype = None
    lib.rle_counts_to_string.argtypes = [p, i64, ctypes.c_char_p, i64]
    lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, i64, p, i64]
    lib.rle_area.argtypes = [p, i64]
    _LIB = lib
    return _LIB


def native_loaded() -> bool:
    """True when the codec runs through the native library."""
    return _load_native() is not None


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (H, W) mask -> column-major run counts (uint32), starting
    with a run of zeros."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _load_native()
    if lib is not None:
        buf = np.empty(h * w + 1, np.uint32)
        n = lib.rle_encode_counts(mask.ctypes.data, h, w, buf.ctypes.data, buf.size)
        if n <= 0:
            raise RuntimeError(f"rle_encode_counts returned {n}")
        return buf[:n].copy()
    flat = mask.flatten(order="F")
    changes = np.nonzero(np.diff(flat))[0] + 1
    counts = np.diff(np.concatenate([[0], changes, [flat.size]])).astype(np.uint32)
    if flat[0] == 1:
        counts = np.concatenate([[np.uint32(0)], counts])
    return counts


def counts_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, np.uint32)
    lib = _load_native()
    if lib is not None:
        out = np.empty((h, w), np.uint8)
        lib.rle_decode_counts(counts.ctypes.data, len(counts), h, w, out.ctypes.data)
        return out
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    flat = np.pad(flat, (0, h * w - flat.size))
    return flat.reshape(w, h).T.copy()


def counts_to_string(counts: np.ndarray) -> bytes:
    """COCO's compressed string: each count (after the first two as a delta
    to the count two back) as 5-bit groups, char offset 48."""
    counts = np.ascontiguousarray(counts, np.uint32)
    lib = _load_native()
    if lib is not None:
        buf = ctypes.create_string_buffer(len(counts) * 8 + 16)
        n = lib.rle_counts_to_string(counts.ctypes.data, len(counts), buf, len(buf))
        if n < 0:
            raise RuntimeError("rle_counts_to_string: buffer too small")
        return buf.raw[:n]
    out = bytearray()
    for i, c in enumerate(counts.astype(np.int64)):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def string_to_counts(s: bytes) -> np.ndarray:
    lib = _load_native()
    if lib is not None:
        buf = np.empty(len(s) + 1, np.uint32)
        n = lib.rle_string_to_counts(s, len(s), buf.ctypes.data, buf.size)
        if n < 0:
            raise RuntimeError("rle_string_to_counts: buffer too small")
        return buf[:n].copy()
    counts = []
    p = 0
    while p < len(s):
        x = k = 0
        more = True
        while more and p < len(s):
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = (c & 0x20) != 0
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def encode(mask: np.ndarray) -> dict:
    """Binary mask -> COCO RLE {"size": [h, w], "counts": bytes}."""
    h, w = mask.shape
    return {"size": [h, w], "counts": counts_to_string(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    """COCO RLE, compressed (bytes / str counts) or not (a list of ints) ->
    binary (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts.encode() if isinstance(counts, str) else counts)
    else:
        counts = np.asarray(counts, np.uint32)
    return counts_to_mask(counts, h, w)


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts.encode() if isinstance(counts, str) else counts)
    return int(np.asarray(counts, np.int64)[1::2].sum())
