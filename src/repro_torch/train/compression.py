"""Lossless columnar compression for cold storage tiers, and the lossy
int8 gradient path (the codec of ``src/repro/train/compression.py``).

``encode_array``/``decode_array`` round-trip an array through
byte-shuffle + zlib.  Grouping bytes by significance before deflate is
the classic columnar trick (Blosc/Parquet): the high bytes of monotone
ids and the exponent bytes of clustered floats are near-constant runs.
The encoded bytes are the reference's: a tensor is encoded as the numpy
array the reference would have held, and a bf16 tensor under the dtype
string the reference writes for a numpy ``bfloat16`` leaf, ``<V2``.
Decoding such a column gives a ``|V2`` array, which neither package can
turn back into a bf16 array (ROADMAP queue 3).

``compressed_psum`` all-reduces per-shard gradients over a mesh axis in
int8 with error feedback, over the logical shards of a
``launch.mesh.LocalMesh`` or the ranks of a ``GroupMesh`` (amax as
float32, codes as int32): staged around its ``pmax`` and its ``psum``
(per-shard values stacked on a leading dim), with the reference's
arithmetic in the reference's order, so the int8 codes are its codes
bit for bit.
"""
from __future__ import annotations

import struct
import zlib

from typing import Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_leaves, tree_unflatten

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


# ----------------------------------------------- lossy gradient path
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_int8(g: torch.Tensor, scale) -> torch.Tensor:
    """round(g / scale) half to even, clipped to +-127, as int8."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, mesh, axis,
                    error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of per-shard gradients over ``axis``, exchanged in int8.

    ``g`` holds the mesh's per-shard gradients stacked on its leading dim
    (``mesh.n_local``, ...: every shard's on a ``LocalMesh``, this rank's
    on a ``GroupMesh``); ``error`` the per-shard errors alike, or one error
    for every shard, or None.  Stages: each shard adds its error; the
    shared scale is ``pmax`` over ``axis`` of each shard's max |g + e|,
    over 127 (at least 1e-12 / 127), which keeps the int8 grids aligned;
    each shard's codes (``quantize_int8``) and new error; the int32
    ``psum`` of the codes over ``axis``; dequantized and divided by the
    axis's size.  Returns (mean gradient f32, new error), both stacked
    per shard; feed the error back in on the next step.

    Rounded as XLA compiles the reference's jitted sync: the division by
    127 is a multiplication by 1/127 rounded to float32, and the new
    error ``gf - q * scale`` one fused multiply-subtract; so codes and
    errors are the reference's bit for bit."""
    n = float(mesh.psum(torch.ones(mesh.n_local, device=g.device),
                        axis)[0])
    gf = g.float()
    if error is not None:
        gf = gf + error
    amax = mesh.pmax(gf.abs().reshape(gf.shape[0], -1).amax(1), axis)
    scale = (torch.clamp(amax, min=1e-12) * _INV127).reshape(
        (-1,) + (1,) * (gf.ndim - 1))
    q = quantize_int8(gf, scale)
    # gf - q * scale rounded once: exact in float64 (q has 8 bits, scale
    # 24), as XLA fuses it into one multiply-subtract
    new_error = (gf.double() - q.double() * scale.double()).float()
    total = mesh.psum(q.to(torch.int32), axis)
    return dequantize(total, scale) / n, new_error


def make_compressed_sync(mesh, dp_axes=("data",)):
    """Returns sync(per_shard_grads, error_tree) -> (mean_grads,
    error_tree), ``compressed_psum`` over every leaf of a tree.

    ``mesh`` is a ``LocalMesh`` or ``GroupMesh`` whose shards all lie on
    the DP axes.  per_shard_grads leaves carry a leading DP dim (one
    slice per shard this process holds: ``mesh.n_local``);
    the means come back replicated (one copy).  The errors come back
    with a leading dim of one row per shard, each shard's own: the
    reference's replicated out_spec holds a different buffer on each
    device, which its next call reads back on that device.  An error
    leaf without that dim (the first step's zeros) is every shard's."""
    axis = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
    if mesh.n_shards != mesh.axis_size(axis):
        raise ValueError(f"make_compressed_sync: {mesh} has axes beyond "
                         f"{dp_axes}")

    def sync(grads, errors):
        g_leaves, spec = tree_flatten(grads)
        means, errs = [], []
        for g, e in zip(g_leaves, tree_leaves(errors)):
            if g.shape[0] != mesh.n_local:
                raise ValueError(f"compressed sync: leading dim "
                                 f"{g.shape[0]} for {mesh.n_local} shards")
            if e is not None and e.ndim < g.ndim:
                e = e.to(g.device).float()[None]
            mean, err = compressed_psum(g, mesh, axis, e)
            means.append(mean[0])
            errs.append(err)
        return tree_unflatten(spec, means), tree_unflatten(spec, errs)

    return sync
