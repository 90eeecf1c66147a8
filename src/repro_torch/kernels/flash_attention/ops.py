"""Checked wrapper of the flash-attention kernel.

The tensors' device chooses the implementation: CUDA tensors launch
``csrc/flash_attention.cu``, CPU tensors take the plain version in
``ref.py``.  There is no fallback from the kernel to the plain version.
"""
import ctypes

import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import mha_ref, per_row

launches = LaunchCounter()

HEAD_DIMS = (16, 32, 64, 128)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    b, hq, sq, d = q.shape
    if q.dtype not in _BF16:
        raise ValueError(f"attention: dtype {q.dtype} (float32 or "
                         "bfloat16 only)")
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} (one of {HEAD_DIMS})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention: q, k and v differ in dtype")
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"attention: {hq} query heads over {k.shape[1]} "
                         "KV heads")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("attention: q, k and v on two devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel reads 16-byte vectors along a dense last dim
        es = t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (s * es) % 16 for s in t.stride()[:3]):
            raise ValueError(f"attention: {name} needs a dense, 16-byte "
                             "aligned last dim")
    if max(b * hq, sq, k.shape[2]) >= 2**31 or b * hq > 65535:
        raise ValueError("attention: sizes beyond the kernel's grid")


def mha(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.

    kv_len (default Skv) masks keys at or beyond it; q_offset (default
    Skv - Sq) is the position of query row 0.  Each is an int or an
    int tensor of shape (), (1,) or (B,): one value per batch row.
    Returns (B, Hq, Sq, D) in q's dtype.  The plain version takes the
    same inputs as the kernel, so both paths check them alike."""
    _check(q, k, v)
    if not q.is_cuda:
        return mha_ref(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    if sq == 0:
        return out
    kvl = per_row(kv_len, b, skv, dev)
    qo = per_row(q_offset, b, skv - sq, dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.restore_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kvl.data_ptr(), qo.data_ptr(), b, hq, hkv, sq, skv, d,
            ctypes.addressof(strides), int(causal), 1.0 / d ** 0.5,
            _BF16[q.dtype], stream_ptr(dev))
    check(rc, "flash_attention")
    launches.add()
    return out


def flash_attention_bhsd(q, k, v, kv_len=None, *, causal=True,
                         q_offset=None, block_q=128, block_k=128,
                         interpret=False):
    """The reference's entry point and signature: q (BH, Sq, D); k, v
    (BH, Skv, D); kv_len an int or int tensor of shape (), (1,) or
    (BH,).  ``block_q``, ``block_k`` and ``interpret`` are the TPU
    kernel's tiling and interpret-mode knobs; they do not change the
    function, and the CUDA kernel keeps its own tiling (64-key tiles)."""
    return mha(q[:, None], k[:, None], v[:, None], kv_len, causal=causal,
               q_offset=q_offset)[:, 0]
