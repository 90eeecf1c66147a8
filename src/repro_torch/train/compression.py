"""Lossless columnar compression for cold storage tiers (the codec of
``src/repro/train/compression.py``; its int8 gradient path comes with
training).

``encode_array``/``decode_array`` round-trip an array through
byte-shuffle + zlib.  Grouping bytes by significance before deflate is
the classic columnar trick (Blosc/Parquet): the high bytes of monotone
ids and the exponent bytes of clustered floats are near-constant runs.
The encoded bytes are the reference's: a tensor is encoded as the numpy
array the reference would have held, and a bf16 tensor under the dtype
string the reference writes for a numpy ``bfloat16`` leaf, ``<V2``.
Decoding such a column gives a ``|V2`` array, which neither package can
turn back into a bf16 array (ROADMAP queue 3).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# wire header: magic, zlib level byte, itemsize, ndim, dtype-str length
_COL_MAGIC = b"RCL1"


def _host_array(a):
    """(contiguous numpy array, dtype string as the reference writes it)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), b"<V2"
        a = t.numpy()
    a = np.ascontiguousarray(a)
    return a, a.dtype.str.encode()


def encode_array(a, level: int = 1) -> bytes:
    """Losslessly encode one column (a numpy array or a tensor):
    byte-shuffle + zlib.

    The shuffle transposes the (rows, itemsize) byte matrix so all
    most-significant bytes are contiguous.  ``level`` 1 is the
    speed/ratio sweet spot for a storage tier whose reads are
    latency-dominated anyway."""
    a, dt = _host_array(a)
    raw = a.tobytes()
    if a.dtype.itemsize > 1 and a.size:
        raw = (np.frombuffer(raw, np.uint8)
               .reshape(-1, a.dtype.itemsize).T.tobytes())
    payload = zlib.compress(raw, level)
    header = struct.pack("<4sBBB", _COL_MAGIC, level, a.dtype.itemsize,
                         a.ndim)
    header += struct.pack("<B", len(dt)) + dt
    header += struct.pack(f"<{a.ndim}q", *a.shape)
    return header + payload


def decode_array(buf: bytes) -> "np.ndarray":
    """Inverse of ``encode_array`` — bit-exact round-trip."""
    magic, _level, itemsize, ndim = struct.unpack_from("<4sBBB", buf, 0)
    if magic != _COL_MAGIC:
        raise ValueError("encode_array: bad magic")
    off = 7
    (dtlen,) = struct.unpack_from("<B", buf, off)
    off += 1
    dt = np.dtype(buf[off:off + dtlen].decode())
    off += dtlen
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    raw = zlib.decompress(buf[off:])
    if itemsize > 1 and raw:
        raw = (np.frombuffer(raw, np.uint8)
               .reshape(itemsize, -1).T.tobytes())
    return np.frombuffer(raw, dt).reshape(shape).copy()


def pack_columns(arrays: dict, level: int = 1) -> dict:
    """Encode a {name: array} mapping column-by-column.  Returns
    {name: encoded bytes}."""
    return {n: encode_array(a, level) for n, a in arrays.items()}


def unpack_columns(blobs: dict) -> dict:
    return {n: decode_array(b) for n, b in blobs.items()}
