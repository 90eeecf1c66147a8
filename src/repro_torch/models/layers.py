"""Transformer building blocks of the port, over parameter dicts with the
reference's keys and shapes (``src/repro/models/layers.py``).

Ported: GQA attention (optional qk-norm and biases, rotary embeddings,
M-RoPE), MLA (the compressed latent cache), the SwiGLU MLP and the MoE
with its capacity-dropping dispatch, on one device and expert-parallel
over a mesh.  Attention runs through ``kernels/flash_attention/ops.mha``:
the CUDA kernels for tensors on the card (the backward kernel when an
input requires a gradient), its plain version for tensors on the CPU.
The MoE's slots come from ``kernels/radix_partition/ops.scatter_slots``
(the partition-scatter kernel on the card).

The mesh paths (``models/dist.py``) run on the logical shards of a
``launch.mesh.LocalMesh``, or one rank a shard on a ``GroupMesh``,
staged around their collectives: the expert-parallel MoE
(``_moe_forward_shard_map``, whenever a mesh with a "model" axis is
set), and under ``dist.optimized()`` chunked attention for long queries
(``_sdpa_chunked``) and the sequence-sharded decode
(``_decode_attn_seq_sharded``).  Both attention paths compute partials
with ``ops.mha_lse`` and merge them by their row statistics
(``_merge_key``, ``_merge_weight``, ``_merge_finish``).  Their sharded
state is handed to ``shard_map`` as ``Resident``: on a ``GroupMesh`` a
rank holds only its blocks (the experts under ``P("model", ...)``, the
cache under ``launch/sharding.py::cache_specs``) and its DP block of the
batch (``dist.dp_split``).

Unlike the reference, a decode cache is written in place: ``attn_forward``
writes the new keys and values into the ``cache`` tensors it is given
and returns them.  A caller that must keep a snapshot (the KV store)
copies it.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import trace
from ..kernels.flash_attention import ops as fa
from ..kernels.flash_attention.ref import mha_bwd_lse_ref
from ..kernels.radix_partition import ops as rp
from ..launch.mesh import PartitionSpec as P, Resident, axis_index, \
    shard_map
from . import dist
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``.  The initialisers
    make their tensors on ``gen.device``, so through this one they make
    tensors with the real shapes and dtypes and no storage
    (``Model.init_shapes``, the dry-run): torch has no generator on
    ``meta``, and ``randn`` on ``meta`` takes a CPU one."""
    device = torch.device("meta")


def _init(gen: torch.Generator, shape, dtype, scale=None):
    if gen.device.type == "meta":
        # shapes and dtypes only: ``randn`` on meta runs a Python
        # decomposition a call, whose first use imports torch._dynamo and
        # leaves reference cycles that hold the caller's frames
        return torch.empty(shape, dtype=dtype, device=gen.device)
    scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms


def rmsnorm(x, w, eps):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings


def rope_cos_sin(positions, dim, theta, dtype):
    """positions: (..., S) int; returns cos/sin (..., S, dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mrope_cos_sin(positions3, dim, theta, sections, dtype):
    """positions3: (3, B, S) temporal / height / width position ids;
    returns cos/sin (B, S, dim//2).  Frequency band i takes its angle
    from the axis whose section it falls in (Qwen2-VL M-RoPE)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions3.device) / dim))
    ang = positions3.float()[..., None] * inv          # (3, B, S, D/2)
    axis = torch.repeat_interleave(
        torch.arange(3, device=ang.device),
        torch.tensor(sections, device=ang.device),
        output_size=sum(sections))                      # (D/2,)
    ang = ang.gather(0, axis.expand(ang.shape[1:])[None])[0]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


# ---------------------------------------------------------------------------
# Attention core


def _merge_key(lse):
    """A partial's row statistic as the key of the merge: the row's
    ``lse`` (``ops.mha_lse``), or -inf where the partial saw no key
    (lse = +inf), so that such a partial weighs nothing."""
    return torch.where(torch.isinf(lse), torch.full_like(lse, -math.inf),
                       lse)


def _merge_weight(key, m):
    """exp(key - m) for the largest key ``m`` of a row's partials; 0
    for a partial with no key, and for every partial of a row none of
    whose partials saw a key (m = -inf)."""
    return torch.exp(key - torch.where(torch.isinf(m),
                                       torch.zeros_like(m), m))


def _merge_finish(acc, l, fallback, dtype):
    """acc / l: the weighted sum of a row's partial outputs over the sum
    of their weights; ``fallback`` (the mean of V over all keys, the
    reference's answer for a row that sees no key) where no partial saw
    a key (l = 0), if given."""
    out = acc / l.clamp_min(1e-30)[..., None]
    if fallback is not None:
        out = torch.where((l > 0)[..., None], out, fallback)
    return out.to(dtype)


def _mean_v(v, hq, sq):
    """The mean of V over all its keys, per query head: (B, Hq, Sq, Dv)
    float32, what a row that sees no key gets."""
    m = v.float().mean(2)
    return m.repeat_interleave(hq // v.shape[1], 1)[:, :, None] \
        .expand(-1, -1, sq, -1)


def _sdpa_chunked(q, k, v, *, causal, q_offset, kv_len=None, chunk=2048,
                  unroll=False):
    """Attention over KV chunks of ``chunk`` keys: each chunk is one
    ``ops.mha_lse`` call (the kernel on the card) with the chunk's own
    ``kv_len`` (clamped to [0, chunk]) and ``q_offset - c0``, and the
    (output, statistic) partials are merged in chunk order by a running
    maximum, as the reference's online softmax over chunks.  A row that
    sees no key in any chunk gets the mean of V over all Skv keys, as the
    reference's -1e30 masking gives.

    With an int ``q_offset`` a causal chunk starting at c0 takes only the
    query rows at positions >= c0 (earlier rows see none of its keys and
    would add nothing), and a chunk that no row can see (by an int
    ``kv_len`` or causality) is skipped, so nothing changes the answer.
    ``unroll`` is the reference's switch between a scan and an unrolled
    loop for XLA's cost analysis; the port's loop is eager either way.

    Differentiable (``_ChunkedAttention``): each chunk's gradients come
    from the backward of its call given the merged output and the merged
    row statistic, which is the gradient of the whole softmax
    (``ops.backward`` on the card, whose kernels in either dtype read the
    given statistic; ``ref.mha_bwd_lse_ref`` on the CPU)."""
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    return _ChunkedAttention.apply(q, k, v, kv_len, q_offset, causal, chunk)


def _chunk_calls(sq, skv, causal, q_offset, kv_len, chunk):
    """(c0, width, r0, kv_len, q_offset) of each chunk's call, in chunk
    order: keys [c0, c0 + width), query rows [r0, Sq)."""
    calls = []
    for c0 in range(0, skv, chunk):
        width = min(chunk, skv - c0)
        if kv_len is None:
            kvl = width
        elif not isinstance(kv_len, torch.Tensor):
            kvl = min(max(int(kv_len) - c0, 0), width)
            if kvl == 0:
                continue
        else:
            kvl = (kv_len.to(torch.int32) - c0).clamp(0, width)
        r0 = 0
        if causal and not isinstance(q_offset, torch.Tensor):
            r0 = max(0, c0 - int(q_offset))
            if r0 >= sq:
                continue
        calls.append((c0, width, r0, kvl, q_offset + r0 - c0))
    return calls


class _ChunkedAttention(torch.autograd.Function):
    """``_sdpa_chunked``: the forward merges the chunks' partials; the
    backward runs each chunk's attention backward from the merged output
    and statistic (P = exp(s - lse) of the whole row, delta =
    rowsum(dO O) of the merged output) and sums dQ over the chunks.  A
    row that sees no key anywhere adds dO / Skv to every key's dV and
    nothing else, as the reference's uniform softmax."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_offset, causal, chunk):
        b, hq, sq, _ = q.shape
        skv, dv = k.shape[2], v.shape[3]
        calls = _chunk_calls(sq, skv, causal, q_offset, kv_len, chunk)
        m = torch.full((b, hq, sq), -math.inf, device=q.device)
        l = torch.zeros((b, hq, sq), device=q.device)
        acc = torch.zeros((b, hq, sq, dv), device=q.device)
        for c0, width, r0, kvl, qo in calls:
            o_c, lse_c = fa.mha_lse(q[:, :, r0:], k[:, :, c0:c0 + width],
                                    v[:, :, c0:c0 + width], kvl,
                                    causal=causal, q_offset=qo)
            key = _merge_key(lse_c)
            m_old = m[:, :, r0:]
            m_new = torch.maximum(m_old, key)
            alpha = _merge_weight(m_old, m_new)
            p = _merge_weight(key, m_new)
            l[:, :, r0:] = l[:, :, r0:] * alpha + p
            acc[:, :, r0:] = acc[:, :, r0:] * alpha[..., None] + \
                p[..., None] * o_c.float()
            m[:, :, r0:] = m_new
        out = _merge_finish(acc, l, _mean_v(v, hq, sq), q.dtype)
        lse = torch.where(l > 0, m + torch.log(l),
                          torch.full_like(l, math.inf))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.calls, ctx.causal = calls, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, hq, sq, _ = q.shape
        hkv, skv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
        blind = torch.isinf(lse)[..., None]
        do = torch.where(blind, torch.zeros_like(dout), dout)
        dq = torch.zeros(q.shape, device=q.device)
        dk = torch.zeros(k.shape, device=q.device)
        dv = torch.zeros(v.shape, device=q.device)
        for c0, width, r0, kvl, qo in ctx.calls:
            args = (q[:, :, r0:], k[:, :, c0:c0 + width],
                    v[:, :, c0:c0 + width], out[:, :, r0:], do[:, :, r0:])
            kw = dict(causal=ctx.causal, q_offset=qo)
            if q.is_cuda:
                g = fa.backward(*args, kvl, lse=lse[:, :, r0:], **kw)
            else:
                g = mha_bwd_lse_ref(*args, lse[:, :, r0:], kvl, **kw)
            dq[:, :, r0:] += g[0].float()
            dk[:, :, c0:c0 + width] += g[1].float()
            dv[:, :, c0:c0 + width] += g[2].float()
        spread = torch.where(blind, dout.float(), 0.0).sum(2) / skv
        dv += spread.view(b, hkv, hq // hkv, dv_dim).sum(2)[:, :, None]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _sdpa(q, k, v, *, causal, q_offset, kv_len=None, cfg=None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  The kernel maps each
    query head to its KV head; no KV head is repeated.  ``kv_len`` and
    ``q_offset`` are ints or int32 tensors with one value per row.
    Differentiable: on the card through the backward kernel, on the CPU
    through the plain version's autograd.  Under ``dist.optimized()`` a
    call of 8192 or more queries over more keys than one chunk (2048 if
    Skv divides by it, else 1024) takes the reference's chunked path,
    ``_sdpa_chunked``."""
    sq, skv = q.shape[2], k.shape[2]
    if dist.optimized() and sq >= 8192:
        chunk = 2048 if skv % 2048 == 0 else (
            1024 if skv % 1024 == 0 else 0)
        if chunk and skv > chunk:
            unroll = bool(cfg is not None and not cfg.scan_layers)
            return _sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, chunk=chunk, unroll=unroll)
    return fa.mha(q, k, v, kv_len, causal=causal, q_offset=q_offset)


def _decode_attn_seq_sharded(q, k_new, v_new, cache, cache_index, mesh):
    """Flash-decoding with a SEQUENCE-sharded KV cache over the mesh's
    "model" axis (the reference's shard_map body, staged around its
    collectives).  q/k_new/v_new: (B, Hq|Hkv, 1, Dh); cache: (k, v) of
    (B, Hkv, Smax, Dh), Smax a multiple of the "model" size tp; its
    batch is split over the DP axes when they divide it.

    Stage 1, per (data, model) shard (``shard_map``): the shard owns the
    S-slice [i s_loc, (i + 1) s_loc) of its batch block (a view of the
    cache); it writes k_new and v_new there, in place, when it owns
    ``cache_index``, and computes its partial, one ``ops.mha_lse`` call
    over its slice with kv_len = clamp(idx + 1 - i s_loc, 0, s_loc), not
    causal.  A slice that holds no position <= idx launches nothing and
    adds nothing.  Stage 2, the collectives on the stacked partials: the
    mesh's ``pmax`` of the partials' keys and ``psum`` of their weights
    and weighted outputs over "model", the reference's combine.  Stage 3
    gathers the batch blocks.

    ``cache_index`` is one int for every row.  A per-row (B,) index
    raises, as in the reference, whose shard body cannot take one (its
    ``dynamic_update_slice`` needs a scalar start).

    The cache is what the process holds (``Resident``): on a
    ``LocalMesh`` the whole (B, Hkv, Smax, Dh) tensor; on a ``GroupMesh``
    this rank's block under ``P(dp, None, "model", None)`` (its DP block's
    S-slice, ``Model.init_cache`` allocates it so), and q, k_new and
    v_new the rank's DP block; the output is the rank's DP block.  A
    negative index (no key to see) raises on a ``GroupMesh``."""
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
        raise ValueError("sequence-sharded decode: one cache index for "
                         "every row (a per-row (B,) index is not "
                         "supported, as in the reference)")
    idx = int(cache_index)
    ck, cv = cache
    b, hq = q.shape[0], q.shape[1]
    s_loc = ck.shape[2] // mesh.local_shards("model")
    if idx < 0 and mesh.spans_processes:
        raise ValueError("sequence-sharded decode over ranks: a negative "
                         "cache index (a row that sees no key)")
    dp_spec = dist.dp_split(mesh, b)[0]
    every = P(mesh.axis_names)

    def partial(qb, kn, vn, ckl, cvl):
        base = axis_index("model") * s_loc
        lpos = idx - base
        if 0 <= lpos < s_loc:
            ckl[:, :, lpos:lpos + 1] = kn.to(ckl.dtype)
            cvl[:, :, lpos:lpos + 1] = vn.to(cvl.dtype)
        kvl = min(max(idx + 1 - base, 0), s_loc)
        shape = qb.shape[:3]
        if kvl == 0:
            o = qb.new_zeros(shape + (cvl.shape[3],), dtype=torch.float32)
            lse = torch.full(shape, math.inf, device=qb.device)
        else:
            o, lse = fa.mha_lse(qb, ckl, cvl, kvl, causal=False, q_offset=0)
        return o.float()[None], lse[None]

    rep4 = P(dp_spec, None, None, None)
    cache_spec = P(dp_spec, None, "model", None)
    o, lse = shard_map(partial, mesh,
                       in_specs=(rep4, rep4, rep4, cache_spec, cache_spec),
                       out_specs=(every, every))(
        *(Resident(t) for t in (q, k_new, v_new, ck, cv)))
    key = _merge_key(lse)
    w = _merge_weight(key, mesh.pmax(key, "model"))
    l = mesh.psum(w, "model")
    acc = mesh.psum(w[..., None] * o, "model")
    out = shard_map(lambda a, s: (a[0], s[0]), mesh, in_specs=(every, every),
                    out_specs=(rep4, P(dp_spec)))(Resident(acc), Resident(l))
    fallback = None if idx >= 0 else _mean_v(ck, hq, 1)
    return _merge_finish(*out, fallback, q.dtype), (ck, cv)


# ---------------------------------------------------------------------------
# GQA attention


def init_attn(cfg: ModelConfig, gen) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    p = {
        "wq": _init(gen, (d, cfg.q_dim), dt),
        "wk": _init(gen, (d, cfg.kv_dim), dt),
        "wv": _init(gen, (d, cfg.kv_dim), dt),
        "wo": _init(gen, (cfg.q_dim, d), dt),
    }
    dev = gen.device
    if cfg.attn_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=dev)
    return p


def _write_cache(c, new, cache_index):
    """Write ``new`` (B, Hkv, S, Dh) into the cache ``c`` (B, Hkv, Smax,
    Dh) in place at ``cache_index``: an int for every row, or an int32
    (B,) tensor with one index per row.  The start is clamped so the
    write fits, as ``dynamic_update_slice`` clamps it."""
    b, _, s, _ = new.shape
    smax = c.shape[2]
    new = new.to(c.dtype)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        start = cache_index.long().clamp(0, smax - s)
        pos = start[:, None] + torch.arange(s, device=c.device)
        rows = torch.arange(b, device=c.device)[:, None]
        c[rows, :, pos] = new.transpose(1, 2)
    else:
        start = min(max(int(cache_index), 0), smax - s)
        c[:, :, start:start + s] = new


def attn_forward(cfg: ModelConfig, p: Params, x, positions,
                 cache: Optional[Tuple] = None, cache_index=None,
                 causal: bool = True, kv_override=None):
    """x: (B, S, d).  cache: (k, v) rings (B, Hkv, Smax, Dh) when
    decoding, written in place; cache_index: an int (every row at the
    same position) or an int32 (B,) tensor (continuous batching: each
    row at its own).  kv_override: (k, v) from an encoder for
    cross-attention.  Returns (out, new_cache).  A one-token decode
    under ``dist.optimized()`` with a mesh whose "model" size divides
    Smax takes the sequence-sharded path
    (``_decode_attn_seq_sharded``)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.view(b, s, h, dh).transpose(1, 2)

    if kv_override is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
        k = k.view(b, s, hkv, dh).transpose(1, 2)
        v = v.view(b, s, hkv, dh).transpose(1, 2)
    else:
        k, v = kv_override

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    if kv_override is None:
        if cfg.m_rope:
            cos, sin = mrope_cos_sin(positions, dh, cfg.rope_theta,
                                     cfg.mrope_sections, x.dtype)
        else:
            cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    kv_len = None
    q_offset = 0
    if cache is not None and kv_override is None:
        mesh = dist.get_mesh()
        if (s == 1 and dist.optimized() and mesh is not None
                and "model" in mesh.axis_names
                and cache[0].shape[2] % mesh.local_shards("model") == 0):
            # sequence-sharded flash-decoding (the reference's §Perf
            # cell 3)
            o4, new_cache = _decode_attn_seq_sharded(q, k, v, cache,
                                                     cache_index, mesh)
            o = o4.transpose(1, 2).reshape(b, s, h * dh)
            return o @ p["wo"], new_cache
        ck, cv = cache
        _write_cache(ck, k, cache_index)
        _write_cache(cv, v, cache_index)
        k, v = ck, cv
        new_cache = (ck, cv)
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            # per-row indices: causality is the per-row kv_len mask
            # (exact for single-token decode)
            kv_len = cache_index + s
            causal = False
        else:
            kv_len = int(cache_index) + s
            q_offset = int(cache_index)
            causal = True
    elif kv_override is not None:
        causal = False

    o = _sdpa(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
              cfg=cfg)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return o @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLA attention


def init_mla(cfg: ModelConfig, gen) -> Params:
    m = cfg.mla
    dt = _dtype(cfg)
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    ones = dict(dtype=dt, device=gen.device)
    return {
        "wdq": _init(gen, (d, m.q_lora_rank), dt),
        "q_norm": torch.ones((m.q_lora_rank,), **ones),
        "wuq": _init(gen, (m.q_lora_rank, h * qk_head), dt),
        "wdkv": _init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), dt),
        "kv_norm": torch.ones((m.kv_lora_rank,), **ones),
        "wuk": _init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim), dt),
        "wuv": _init(gen, (m.kv_lora_rank, h * m.v_head_dim), dt),
        "wo": _init(gen, (h * m.v_head_dim, d), dt),
    }


# The split of a CUDA graph's capture (``split_attention``), or None.
_graph_split = None


@contextmanager
def split_attention(split):
    """Within it, an MLA layer called at a 0-d tensor index hands its
    latent decompression and attention to ``split(attend, shape,
    dtype)`` and goes on from the tensor of ``shape`` and ``dtype`` that
    ``split`` returns; ``attend(index)`` runs the two eagerly at the int
    ``index`` (``kv_len`` index + S, ``q_offset`` index) and returns the
    attention's output.  ``Model.decode_step``'s capture ends a graph
    there: each replay launches the attention from Python, between the
    graphs."""
    global _graph_split
    prev, _graph_split = _graph_split, split
    try:
        yield
    finally:
        _graph_split = prev


def mla_forward(cfg: ModelConfig, p: Params, x, positions, cache=None,
                cache_index=None):
    """MLA: caches the compressed latent, (c_kv (B, Smax, r), k_rope (B,
    Smax, dr)), with no head axis, written in place at ``cache_index``:
    an int, or a 0-d integer tensor that the host never reads (the
    write's start clamped on the device, ``kv_len`` and ``q_offset``
    handed to the kernel as device values), so a CUDA graph can replay
    the write (``Model.decode_step``).  As the reference does, every
    call decompresses k_nope and v from the whole latent cache;
    attention then runs at a query/key head dim of nope + rope and a
    value head dim of v.  Under ``split_attention`` (a graph's capture)
    the decompression and attention go to the split at a 0-d index.
    The reference's update takes one index for every row, so a per-row
    (B,) index (continuous batching) raises here too."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim

    with trace.span("mla.project"):
        q = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
        q = q.view(b, s, h, nope + rope).transpose(1, 2)
        q_nope, q_rope = q[..., :nope], q[..., nope:]

        ckv = x @ p["wdkv"]
        c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
        c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)

        cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta, x.dtype)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[:, None], cos, sin)[:, 0]   # (B, S, dr)

    new_cache = None
    kv_len = None
    q_offset = 0
    if cache is not None:
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim:
            raise ValueError("MLA: the latent cache is written at one "
                             "index for every row (continuous batching "
                             "of MLA is not supported)")
        with trace.span("mla.cache_write"):
            cc, cr = cache
            if isinstance(cache_index, torch.Tensor):
                idx = cache_index.to(cc.device)
                rows = idx.long().clamp(0, cc.shape[1] - s) \
                    + torch.arange(s, device=cc.device)
                cc.index_copy_(1, rows, c_kv.to(cc.dtype))
                cr.index_copy_(1, rows, k_rope.to(cr.dtype))
            else:
                idx = int(cache_index)
                start = min(max(idx, 0), cc.shape[1] - s)
                cc[:, start:start + s] = c_kv.to(cc.dtype)
                cr[:, start:start + s] = k_rope.to(cr.dtype)
        c_kv, k_rope = cc, cr
        new_cache = (cc, cr)
        kv_len = idx + s
        q_offset = idx

    def attend(kv_len, q_offset):
        with trace.span("mla.expand"):
            k_nope = (c_kv @ p["wuk"]).view(b, -1, h, nope).transpose(1, 2)
            v = (c_kv @ p["wuv"]).view(b, -1, h, m.v_head_dim
                                       ).transpose(1, 2)
            k = torch.cat([k_nope, k_rope[:, None].expand(b, h, -1, rope)],
                          -1)
            qq = torch.cat([q_nope, q_rope], -1)
        with trace.span("mla.attend"):
            return _sdpa(qq, k, v, causal=True, q_offset=q_offset,
                         kv_len=kv_len, cfg=cfg)

    if _graph_split is not None and isinstance(cache_index, torch.Tensor):
        o = _graph_split(lambda i: attend(i + s, i),
                         (b, h, s, m.v_head_dim), q_nope.dtype)
    else:
        o = attend(kv_len, q_offset)
    with trace.span("mla.out"):
        o = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
        return o @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# FFN / MoE


def init_mlp(cfg: ModelConfig, gen, d_ff: int) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    return {"wg": _init(gen, (d, d_ff), dt),
            "wu": _init(gen, (d, d_ff), dt),
            "wd": _init(gen, (d_ff, d), dt)}


def mlp_forward(p: Params, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def init_moe(cfg: ModelConfig, gen) -> Params:
    m = cfg.moe
    dt = _dtype(cfg)
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    p = {
        "router": _init(gen, (d, e), torch.float32, scale=0.02),
        "wg": _init(gen, (e, d, f), dt),
        "wu": _init(gen, (e, d, f), dt),
        "wd": _init(gen, (e, f, d), dt),
    }
    if m.n_shared:
        p["shared"] = init_mlp(cfg, gen, m.d_expert * m.n_shared)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens, the
    reference's formula: max(8, T k cf / E truncated, rounded up to a
    multiple of 8)."""
    m = cfg.moe
    cap = max(1, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, (cap + 7) // 8 * 8)


def moe_slots(expert_ids, n_experts: int, cap: int, valid=None):
    """(slot (N,) int32, dropped 0-d int32) of the dispatch's N = T k
    entries, in entry order (token-major): ``e * cap + rank`` where rank
    is the entry's stable arrival rank among the entries routed to the
    same expert e, and ``n_experts * cap`` for an entry whose rank
    reaches ``cap``.  That is what the reference's stable argsort and
    searchsorted give, and exactly the function of the partition-scatter
    kernel with the expert id as the hash lane.  The kernel takes a
    power-of-two E only, so another E raises on the card, here with the
    MoE's own message before the wrapper would refuse it (CPU tensors
    take the plain version at any E).  ``valid`` (shaped like
    ``expert_ids``, default all) marks the entries that take part; any
    other gets the drop slot and is not counted as dropped (the
    expert-parallel MoE's entries routed to another shard's experts)."""
    if expert_ids.is_cuda and n_experts & (n_experts - 1):
        raise ValueError(f"MoE dispatch: {n_experts} experts (the "
                         "partition-scatter kernel takes a power of two)")
    lanes = expert_ids.reshape(-1).to(torch.int64)
    valid = torch.ones(lanes.shape, dtype=torch.bool, device=lanes.device) \
        if valid is None else valid.reshape(-1).contiguous()
    return rp.scatter_slots(lanes, valid, n_parts=n_experts, bucket=cap)


def _route(cfg: ModelConfig, router, xf):
    """(probs, gates, eidx, aux) of T tokens: f32 router, softmax, top-k
    with renormalised gates, and the Switch load-balancing loss
    e * sum_e f_e * p_e."""
    m = cfg.moe
    t, k, e = xf.shape[0], m.top_k, m.n_experts
    probs = torch.softmax(xf.float() @ router, -1)
    gates, eidx = torch.topk(probs, k, dim=-1)                # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    ce = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, eidx.reshape(-1), torch.full((t * k,), 1.0 / (t * k),
                                        device=xf.device))
    return probs, gates, eidx, e * torch.sum(probs.mean(0) * ce)


def _experts(xf, gates, eidx, slot, wg, wu, wd, cap):
    """The dispatch into (E', cap, d) expert buffers by ``slot`` (E' =
    wg's expert count; slot E' cap drops), the batched expert FFNs, and
    each token's k outputs summed in x's dtype in increasing expert
    order (the order of the reference's sorted scatter-add; no atomics,
    so two calls give the same bits).  A dropped entry adds exactly 0."""
    t, d = xf.shape
    k, e = eidx.shape[1], wg.shape[0]
    slot = slot.long()
    # one row past the buffers takes every dropped entry and stays zero
    # on the way back
    tok = torch.arange(t * k, device=xf.device) // k
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(0, slot, xf[tok])
    buf = buf[:-1].view(e, cap, d)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    eo = torch.cat([torch.bmm(h, wd).reshape(e * cap, d),
                    xf.new_zeros((1, d))])
    contrib = (eo[slot].float() * gates.reshape(-1, 1)).to(xf.dtype)
    contrib = contrib.view(t, k, d)
    order = torch.argsort(eidx, dim=-1)
    contrib = contrib.gather(1, order[..., None].expand(t, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_forward(cfg: ModelConfig, p: Params, x):
    """MoE dispatch.  x: (B, S, d) -> (out, aux_loss).  With a mesh that
    has a "model" axis whose size divides E (``dist.set_mesh``), the
    expert-parallel path ``_moe_forward_shard_map``; otherwise the
    single-device MoE (the reference's ``_moe_forward_gspmd``): routing
    (``_route``), capacity-dropping dispatch into (E, cap, d) expert
    buffers with slots from ``moe_slots``, batched expert FFNs
    (``_experts``), plus the shared expert."""
    mesh = dist.get_mesh()
    if (mesh is not None and "model" in mesh.axis_names
            and cfg.moe.n_experts % mesh.shape["model"] == 0):
        return _moe_forward_shard_map(cfg, p, x, mesh)
    m = cfg.moe
    b, s, d = x.shape
    t, e = b * s, m.n_experts
    cap = moe_capacity(cfg, t)
    xf = x.reshape(t, d)
    _, gates, eidx, aux = _route(cfg, p["router"], xf)
    slot, _ = moe_slots(eidx, e, cap)
    out = _experts(xf, gates, eidx, slot, p["wg"], p["wu"], p["wd"], cap)
    if m.n_shared:
        out = out + mlp_forward(p["shared"], xf)
    return out.reshape(b, s, d), aux


def _moe_forward_shard_map(cfg: ModelConfig, p: Params, x, mesh):
    """Expert-parallel MoE over the mesh: experts sharded over "model"
    (e_loc = E / tp a shard), tokens over the DP axes (replicated over
    them when they do not divide the batch) and replicated over
    "model".

    Stage 1, per (data, model) shard (``shard_map``): route the data
    block's tokens; select the entries bound for the shard's e_loc
    experts; slots from ``moe_slots`` with ``valid`` = local and
    e_loc experts (one partition-scatter launch a shard on the card; an
    entry bound elsewhere gets slot e_loc cap, as the reference's sort
    key e_loc gives it); capacity cap from t_loc, the tokens of a DP
    block (not ``moe_capacity`` of the whole batch); the local experts'
    FFNs.  Stage 2, the collectives on the stacked partials: the
    outputs' ``psum`` over "model" and aux's ``pmean`` over the DP axes.
    Stage 3 gathers the DP blocks.  The shared expert runs outside, on
    the whole batch, as in the reference.  On the card e_loc must be a
    power of two (``moe_slots``).

    x and the expert stacks are what the process holds (``Resident``):
    on a ``LocalMesh`` the whole batch and all E experts; on a
    ``GroupMesh`` this rank's DP block and its e_loc experts (their
    block under ``P("model", None, None)``; whole stacks raise), so the
    output and the shared expert's are the rank's DP block."""
    m = cfg.moe
    tp = mesh.shape["model"]
    e = m.n_experts
    e_loc = e // tp
    k = m.top_k
    b, s, d = x.shape
    held = e_loc * mesh.local_shards("model")
    if p["wg"].shape[0] != held:
        raise ValueError(f"expert-parallel MoE: {p['wg'].shape[0]} experts "
                         f"held, this process holds {held} of {e}")
    dp_spec, _, b_loc = dist.dp_split(mesh, b)
    dp = dist.dp_axis_names(mesh) if dp_spec else ()
    t_loc = b_loc * s
    cap = max(8, (int(t_loc * k * m.capacity_factor / e) + 7) // 8 * 8)
    every = P(mesh.axis_names)

    def body(xb, router, wg, wu, wd):
        bl, sl, _ = xb.shape
        xf = xb.reshape(bl * sl, d)
        _, gates, eidx, aux = _route(cfg, router, xf)
        lid = eidx - axis_index("model") * e_loc
        local = (lid >= 0) & (lid < e_loc)
        slot, _ = moe_slots(torch.where(local, lid, 0), e_loc, cap,
                            valid=local)
        out = _experts(xf, gates, eidx, slot, wg, wu, wd, cap)
        return out.reshape(bl, sl, d)[None], aux[None]

    ex = P("model", None, None)
    out, aux = shard_map(
        body, mesh, in_specs=(P(dp_spec, None, None), P(), ex, ex, ex),
        out_specs=(every, every))(
        Resident(x), p["router"],
        *(Resident(p[n]) for n in ("wg", "wu", "wd")))
    out = mesh.psum(out, "model")
    if dp:
        aux = mesh.pmean(aux, dp)
    out = shard_map(lambda o: o[0], mesh, in_specs=(every,),
                    out_specs=P(dp_spec, None, None))(Resident(out))
    if m.n_shared:   # shared expert: plain TP outside the shard_map
        out = out + mlp_forward(p["shared"], x.reshape(b * s, d)) \
            .reshape(b, s, d)
    return out, aux[0]
