"""Checked wrapper of the flash-attention kernels.

The tensors' device and dtype choose the implementation (``plan``):
bf16 CUDA tensors launch the tensor-core kernel
``csrc/flash_attention_sm90.cu``, float32 CUDA tensors the CUDA-core
kernel ``csrc/flash_attention.cu``, CPU tensors take the plain version in
``ref.py`` (differentiable through autograd).  There is no fallback from a
kernel to the plain version.

When an input on the card requires a gradient, ``mha`` goes through
``_Attention``, whose forward is the same kernel launch (in bf16 it also
saves each row's ``lse``) and whose backward is
``csrc/flash_attention_bwd.cu`` (dQ, dK and dV; its plain version is
``ref.mha_bwd_ref``, autograd through ``mha_ref``).  ``bwd_plan`` picks
the backward's route: bf16 the tensor-core kernels, float32 the
CUDA-core kernel, each at every pair of head dims the forward takes,
MLA's (24, 16) and (96, 64) included.  Both read the row statistics the
forward saved.  Without a gradient nothing is saved and the path is the
serving path's.
"""
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ... import trace
from ..build import LaunchCounter, check, library, stream_ptr
from .ref import mha_bwd_ref, mha_ref, mha_with_lse_ref, per_row

# one per attention call on the card; shapes: (route, D, Dv, causal)
launches = LaunchCounter("flash_attention")
# the bf16 kernel's split-KV merges
merge_launches = LaunchCounter("flash_attention_merge")
# one per backward call on the card; shapes: (route, D, Dv, causal)
backward_launches = LaunchCounter("flash_attention_bwd")
# of them, the tensor-core route and the CUDA-core route
backward_sm90_launches = LaunchCounter("flash_attention_bwd_sm90")
backward_simt_launches = LaunchCounter("flash_attention_bwd_simt")

HEAD_DIMS = (16, 32, 64, 128)   # query/key head dims, and value head dims
MAX_QK_DIM = 128   # a wider query/key than value head dim (MLA): the
                   # kernels stage it at 128 columns at most
_DTYPES = (torch.float32, torch.bfloat16)
SPLIT_KEYS = 128    # keys per split: SPLIT in csrc/flash_attention_sm90.cu
TILE_ROWS = 64      # query-tile rows (query heads x positions): BM there
_INT32 = (-2**31, 2**31)


class Plan(NamedTuple):
    kernel: str      # "plain" (CPU), "sm90" (bf16 card), "simt" (f32 card)
    n_splits: int    # sm90: ceil(Skv / SPLIT_KEYS), from key positions only
    scratch: bool    # sm90: one CTA per split, partials merged by a second
                     # launch (few query tiles), else merged in registers


def plan(dtype, device_type, b, hq, hkv, sq, skv, n_sm=132) -> Plan:
    """Which kernel a call takes.  Both sm90 forms cut the keys into the
    same splits and merge them with the same arithmetic, so a row's bits
    do not depend on the form; the split form only adds CTAs where the
    fused form would leave SMs idle."""
    if device_type != "cuda":
        return Plan("plain", 0, False)
    if dtype == torch.float32:
        return Plan("simt", 0, False)
    n_splits = -(-skv // SPLIT_KEYS)
    q_tiles = -(-sq // (TILE_ROWS // (hq // hkv)))
    return Plan("sm90", n_splits, n_splits > 1 and b * hkv * q_tiles < n_sm)


def head_dims_ok(d: int, dv: int) -> bool:
    """Whether the kernels take a query/key head dim ``d`` with a value
    head dim ``dv``: equal dims from ``HEAD_DIMS``, or (MLA) ``dv`` from
    ``HEAD_DIMS`` under a wider ``d``, a multiple of 8 up to
    ``MAX_QK_DIM``, e.g. minicpm3's (96, 64)."""
    if d == dv:
        return d in HEAD_DIMS
    return dv in HEAD_DIMS and d % 8 == 0 and dv < d <= MAX_QK_DIM


def bwd_plan(dtype, d, device_type="cuda", dv=None) -> str:
    """Which backward kernel a call takes at a query/key head dim ``d``
    and a value head dim ``dv`` (default ``d``): "plain"
    (``ref.mha_bwd_ref``) for CPU tensors; on the card, at every pair
    ``head_dims_ok`` takes, "sm90" for bf16 (``csrc/flash_attention_bwd.cu``'s
    tensor-core kernels, which run 16, 32 and 64 as 64 with zero
    columns, and MLA's (96, 64) as (128, 64)) and "simt" for float32 (its
    CUDA-core kernel, which stages the query/key dim at the least of 16,
    32, 64 and 128 that holds it: (24, 16) as (32, 16)).  Anything else
    raises: there is no fallback."""
    if device_type != "cuda":
        return "plain"
    dv = d if dv is None else dv
    if dtype not in _DTYPES:
        raise ValueError(f"attention backward: dtype {dtype} (float32 or "
                         "bfloat16 only)")
    if not head_dims_ok(d, dv):
        raise ValueError(f"attention backward: head dim {d} with value "
                         f"head dim {dv} (as the forward takes them)")
    return "sm90" if dtype == torch.bfloat16 else "simt"


def _lse_buffer(b, hq, sq, dev):
    """(B, Hq, Sq) float32 for the forward's row statistics, rows padded
    to a multiple of 4 elements (TMA reads them in 16-byte strides)."""
    ld = -(-max(sq, 1) // 4) * 4
    return torch.empty((b, hq, ld), dtype=torch.float32,
                       device=dev)[..., :sq]


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v):
    b, hq, sq, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention: dtype {q.dtype} (float32 or "
                         "bfloat16 only)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention: q, k and v differ in dtype")
    if k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3] \
            or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not head_dims_ok(d, v.shape[3]):
        raise ValueError(f"attention: head dim {d} with value head dim "
                         f"{v.shape[3]} (equal dims from {HEAD_DIMS}, or "
                         f"a value dim from them under a wider query/key "
                         f"dim, a multiple of 8 up to {MAX_QK_DIM})")
    if hq % k.shape[1]:
        raise ValueError(f"attention: {hq} query heads over {k.shape[1]} "
                         "KV heads")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("attention: q, k and v on two devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernels read 16-byte vectors (and TMA boxes) along a dense
        # last dim
        es = t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (s * es) % 16 for s in t.stride()[:3]):
            raise ValueError(f"attention: {name} needs a dense, 16-byte "
                             "aligned last dim")
    if max(b * hq, sq, k.shape[2]) >= 2**31 or b * hq > 65535:
        raise ValueError("attention: sizes beyond the kernel's grid")
    if q.dtype == torch.bfloat16 and hq // k.shape[1] > TILE_ROWS:
        raise ValueError(f"attention: {hq // k.shape[1]} query heads per "
                         f"KV head (at most {TILE_ROWS} in bf16)")


def _row_arg(x, b, default, dev):
    """(tensor to keep alive, device pointer, value): a tensor becomes a
    (B,) int32 device array; None or an int goes to the kernel by value."""
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        t = per_row(x, b, default, dev)
        return t, t.data_ptr(), 0
    x = int(x)
    if not _INT32[0] <= x < _INT32[1]:
        raise ValueError(f"attention: {x} beyond int32")
    return None, None, x


def mha(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) with
    Hq % Hkv == 0 and (D, Dv) as ``head_dims_ok`` allows.

    kv_len (default Skv) masks keys at or beyond it; q_offset (default
    Skv - Sq) is the position of query row 0.  Each is an int or an
    int tensor of shape (), (1,) or (B,): one value per batch row.
    Returns (B, Hq, Sq, Dv) in q's dtype; scores are scaled by
    1/sqrt(D).  The plain version takes the same inputs as the kernels,
    so both paths check them alike.  On the card, an input that requires
    a gradient routes the call through ``_Attention`` (the backward
    kernel); otherwise nothing is saved.  On the card the span
    ``fa.forward`` runs from the checks to the launch being queued."""
    if not q.is_cuda:
        _check(q, k, v)
        return mha_ref(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    with trace.span("fa.forward"):
        _check(q, k, v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            bwd_plan(q.dtype, q.shape[3], "cuda", v.shape[3])
            return _Attention.apply(q, k, v, kv_len, q_offset, causal)
        return _forward(q, k, v, kv_len, causal, q_offset)


def mha_lse(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """``mha``'s output and each row's statistic (``ref.mha_lse_ref``:
    (B, Hq, Sq) float32, natural log, +inf for a row that sees no key),
    from one launch of the kernel ``plan`` picks on the card (bf16 or
    float32) or the plain versions on the CPU.  Nothing is
    differentiated."""
    _check(q, k, v)
    if not q.is_cuda:
        return mha_with_lse_ref(q, k, v, kv_len, causal=causal,
                                q_offset=q_offset)
    lse = _lse_buffer(q.shape[0], q.shape[1], q.shape[2], q.device)
    return _forward(q, k, v, kv_len, causal, q_offset, lse), lse


def _forward(q, k, v, kv_len, causal, q_offset, lse=None):
    """One launch of the forward kernel that ``plan`` picks; either
    kernel also writes each row's statistic into ``lse`` (from
    ``_lse_buffer``) when it is given."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    p = plan(q.dtype, "cuda", b, hq, hkv, sq, skv, _n_sm(dev.index or 0))
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=dev)
    if sq == 0:
        return out
    # the (B,) arrays, if any, stay referenced until the launch is queued
    kvl_t, kvl_ptr, kvl_val = _row_arg(kv_len, b, skv, dev)
    qo_t, qo_ptr, qo_val = _row_arg(q_offset, b, skv - sq, dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kvl_ptr, qo_ptr, kvl_val, qo_val, b, hq, hkv, sq, skv, d)
    lib = library()
    with torch.cuda.device(dev):
        if p.kernel == "sm90":
            scratch = torch.empty(b * hq * sq * p.n_splits * (dv + 2),
                                  dtype=torch.float32, device=dev) \
                if p.scratch else None
            rc = lib.restore_flash_attention_sm90(
                *args, dv, ctypes.addressof(strides), int(causal),
                math.log2(math.e) / d ** 0.5,
                None if scratch is None else scratch.data_ptr(),
                p.n_splits if p.scratch else 0,
                None if lse is None else lse.data_ptr(),
                0 if lse is None else lse.stride(1), stream_ptr(dev))
        else:
            rc = lib.restore_flash_attention(
                *args, dv, ctypes.addressof(strides), int(causal),
                1.0 / d ** 0.5, None if lse is None else lse.data_ptr(),
                0 if lse is None else lse.stride(1), stream_ptr(dev))
    check(rc, "flash_attention")
    launches.add((p.kernel, d, dv, bool(causal)))
    if p.scratch:
        merge_launches.add()
    return out


def _dense(t):
    """``t`` with a dense, 16-byte aligned layout the kernels can read."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _lse_rows(lse, b, hq, sq, dev):
    """``lse`` as the backward kernels read it: (B, Hq, Sq) float32 rows
    at a stride that is a multiple of 4 elements, 16-byte aligned (as the
    bf16 route's TMA needs); copied into such a buffer if it is not."""
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != dev:
        raise ValueError(f"attention backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype} does not fit q")
    ld = lse.stride(1)
    if lse.stride(2) == 1 and ld % 4 == 0 and ld >= sq and \
            lse.stride(0) == hq * ld and lse.data_ptr() % 16 == 0:
        return lse
    return _lse_buffer(b, hq, sq, dev).copy_(lse)


def _delta_rows(lse):
    """Scratch for the bf16 backward's delta = rowsum(dO * O): (B, Hq,
    Sq) float32 at ``lse``'s strides, since the kernels address both
    with lse's row stride (``empty_like`` would pack a padded ``lse``'s
    rows and leave the last rows' ends outside the allocation)."""
    b, hq, sq = lse.shape
    return torch.empty((b, hq, lse.stride(1)), dtype=torch.float32,
                       device=lse.device)[..., :sq]


def backward(q, k, v, out, dout, kv_len=None, *, causal=True,
             q_offset=None, lse=None):
    """(dQ, dK, dV) of ``mha`` at (q, k, v) for the upstream gradient
    ``dout`` (B, Hq, Sq, Dv), given the forward's output ``out``, on the
    route ``bwd_plan`` picks: on the card one call of
    ``csrc/flash_attention_bwd.cu`` (bf16: two tensor-core kernels that
    read the forward's row statistics ``lse``, computed here by one more
    forward launch when not given; float32: three CUDA-core kernels, the
    first of which computes ``lse`` itself when it is not given and
    otherwise only delta = rowsum(dO * O)).
    dK and dV sum over each KV head's query heads.  CPU tensors take the
    plain version, ``ref.mha_bwd_ref``."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    d_v = v.shape[3]
    for t in (out, dout):
        if t.shape != (b, hq, sq, d_v) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError("attention backward: out / dout do not fit q "
                             "and v")
    route = bwd_plan(q.dtype, d, q.device.type, d_v)
    if route == "plain":
        return mha_bwd_ref(q, k, v, dout, kv_len, causal=causal,
                           q_offset=q_offset)
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    dq = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, hkv, skv, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, hkv, skv, d_v), dtype=v.dtype, device=dev)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    out, dout = _dense(out), _dense(dout)
    kvl_t, kvl_ptr, kvl_val = _row_arg(kv_len, b, skv, dev)
    qo_t, qo_ptr, qo_val = _row_arg(q_offset, b, skv - sq, dev)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    rows = (kvl_ptr, qo_ptr, kvl_val, qo_val, b, hq, hkv, sq, skv, d)
    tail = (ctypes.addressof(strides), int(causal))
    if route == "sm90":
        if lse is None:
            lse = mha_lse(q, k, v, kv_len, causal=causal,
                          q_offset=q_offset)[1]
        lse = _lse_rows(lse, b, hq, sq, dev)
        delta = _delta_rows(lse)          # written by the dQ kernel
        with torch.cuda.device(dev):
            rc = library().restore_flash_attention_bwd_sm90(
                *ptrs, lse.data_ptr(), delta.data_ptr(), lse.stride(1),
                *rows, d_v, *tail, math.log2(math.e) / d ** 0.5,
                1.0 / d ** 0.5, stream_ptr(dev))
        check(rc, "flash_attention_bwd (sm90)")
        backward_sm90_launches.add()
    else:
        given = lse is not None
        lse = _lse_rows(lse, b, hq, sq, dev) if given else \
            _lse_buffer(b, hq, sq, dev)
        delta = torch.empty(b * hq * sq, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = library().restore_flash_attention_bwd(
                *ptrs, lse.data_ptr(), delta.data_ptr(), lse.stride(1),
                int(given), *rows, d_v, *tail, 1.0 / d ** 0.5,
                stream_ptr(dev))
        check(rc, "flash_attention_bwd (simt)")
        backward_simt_launches.add()
    backward_launches.add((route, d, d_v, bool(causal)))
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """``mha`` on the card with a gradient: the forward kernel, then the
    backward kernel over the saved q, k, v, output, kv_len and q_offset
    and the row statistics the forward wrote."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal):
        lse = _lse_buffer(q.shape[0], q.shape[1], q.shape[2], q.device)
        out = _forward(q, k, v, kv_len, causal, q_offset, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rows = (kv_len, q_offset)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kv_len, q_offset = ctx.rows
        dq, dk, dv = backward(q, k, v, out, dout, kv_len,
                              causal=ctx.causal, q_offset=q_offset, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention_bhsd(q, k, v, kv_len=None, *, causal=True,
                         q_offset=None, block_q=128, block_k=128,
                         interpret=False):
    """The reference's entry point and signature: q (BH, Sq, D); k, v
    (BH, Skv, D); kv_len an int or int tensor of shape (), (1,) or
    (BH,).  ``block_q``, ``block_k`` and ``interpret`` are the TPU
    kernel's tiling and interpret-mode knobs; they do not change the
    function, and the CUDA kernels keep their own tiling (64-key
    tiles)."""
    return mha(q[:, None], k[:, None], v[:, None], kv_len, causal=causal,
               q_offset=q_offset)[:, 0]
