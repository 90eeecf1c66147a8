"""Transformer building blocks of the port, over parameter dicts with the
reference's keys and shapes (``src/repro/models/layers.py``).

Ported: GQA attention (optional qk-norm and biases, rotary embeddings,
M-RoPE), MLA (the compressed latent cache), the SwiGLU MLP and the
single-device MoE with its capacity-dropping dispatch.  Attention runs
through ``kernels/flash_attention/ops.mha``: the CUDA kernels for tensors
on the card (the backward kernel when an input requires a gradient), its
plain version for tensors on the CPU.  The MoE's slots come from
``kernels/radix_partition/ops.scatter_slots`` (the partition-scatter
kernel on the card).

Unlike the reference, a decode cache is written in place: ``attn_forward``
writes the new keys and values into the ``cache`` tensors it is given
and returns them.  A caller that must keep a snapshot (the KV store)
copies it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa
from ..kernels.radix_partition import ops as rp
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def unported(what: str, item: int):
    """Raise for a part of the reference the port does not have yet."""
    raise NotImplementedError(
        f"repro_torch: not ported yet: {what} (ROADMAP queue 1 item "
        f"{item})")


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


def _sdpa_chunked(q, k, v, *, causal, q_offset, kv_len=None, chunk=2048,
                  unroll=False):
    unported("chunked attention under dist.optimized() "
             "(layers._sdpa_chunked)", 22)


def _sdpa(q, k, v, *, causal, q_offset, kv_len=None, cfg=None):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  The kernel maps each
    query head to its KV head; no KV head is repeated.  ``kv_len`` and
    ``q_offset`` are ints or int32 tensors with one value per row.
    Differentiable: on the card through the backward kernel, on the CPU
    through the plain version's autograd.  The reference's chunked path
    exists only under ``dist.optimized()``, which the port does not have
    (off by default there)."""
    return fa.mha(q, k, v, kv_len, causal=causal, q_offset=q_offset)


def _decode_attn_seq_sharded(q, k_new, v_new, cache, cache_index, mesh):
    unported("sequence-sharded decode attention "
             "(layers._decode_attn_seq_sharded)", 22)


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
    cross-attention.  Returns (out, new_cache)."""
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


def mla_forward(cfg: ModelConfig, p: Params, x, positions, cache=None,
                cache_index=None):
    """MLA: caches the compressed latent, (c_kv (B, Smax, r), k_rope (B,
    Smax, dr)), with no head axis, written in place at the int
    ``cache_index``.  As the reference does, every call decompresses
    k_nope and v from the whole latent cache; attention then runs at a
    query/key head dim of nope + rope and a value head dim of v.  The
    reference's update takes one index for every row, so a per-row (B,)
    index (continuous batching) raises here too."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim

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
        cc, cr = cache
        idx = int(cache_index)
        start = min(max(idx, 0), cc.shape[1] - s)
        cc[:, start:start + s] = c_kv.to(cc.dtype)
        cr[:, start:start + s] = k_rope.to(cr.dtype)
        c_kv, k_rope = cc, cr
        new_cache = (cc, cr)
        kv_len = idx + s
        q_offset = idx

    k_nope = (c_kv @ p["wuk"]).view(b, -1, h, nope).transpose(1, 2)
    v = (c_kv @ p["wuv"]).view(b, -1, h, m.v_head_dim).transpose(1, 2)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, -1, rope)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    o = _sdpa(qq, k, v, causal=True, q_offset=q_offset, kv_len=kv_len,
              cfg=cfg)
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


def moe_slots(expert_ids, n_experts: int, cap: int):
    """(slot (N,) int32, dropped 0-d int32) of the dispatch's N = T k
    entries, in entry order (token-major): ``e * cap + rank`` where rank
    is the entry's stable arrival rank among the entries routed to the
    same expert e, and ``n_experts * cap`` for an entry whose rank
    reaches ``cap``.  That is what the reference's stable argsort and
    searchsorted give, and exactly the function of the partition-scatter
    kernel with the expert id as the hash lane.  The kernel takes a
    power-of-two E only, so another E raises on the card, here with the
    MoE's own message before the wrapper would refuse it (CPU tensors
    take the plain version at any E)."""
    if expert_ids.is_cuda and n_experts & (n_experts - 1):
        raise ValueError(f"MoE dispatch: {n_experts} experts (the "
                         "partition-scatter kernel takes a power of two)")
    lanes = expert_ids.reshape(-1).to(torch.int64)
    valid = torch.ones(lanes.shape, dtype=torch.bool, device=lanes.device)
    return rp.scatter_slots(lanes, valid, n_parts=n_experts, bucket=cap)


def moe_forward(cfg: ModelConfig, p: Params, x):
    """The single-device MoE (the reference's ``_moe_forward_gspmd``).
    x: (B, S, d) -> (out, aux_loss).  f32 router, softmax, top-k with
    renormalised gates, the Switch load-balancing loss, capacity-dropping
    dispatch into (E, cap, d) expert buffers, batched expert FFNs, and
    each token's k outputs summed in x's dtype in increasing expert
    order (the order of the reference's sorted scatter-add; no atomics,
    so two calls give the same bits), plus the shared expert.  The
    expert-parallel path (``_moe_forward_shard_map``) needs a mesh of
    cards and is not ported."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    cap = moe_capacity(cfg, t)

    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ p["router"], -1)
    gates, eidx = torch.topk(probs, k, dim=-1)                # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch): e * sum_e f_e * p_e
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, eidx.reshape(-1), torch.full((t * k,), 1.0 / (t * k),
                                        device=x.device))
    aux = e * torch.sum(probs.mean(0) * ce)

    slot, _ = moe_slots(eidx, e, cap)
    slot = slot.long()
    # one row past the buffers takes every dropped entry and stays zero
    # on the way back
    tok = torch.arange(t * k, device=x.device) // k
    buf = x.new_zeros((e * cap + 1, d)).index_copy(0, slot, xf[tok])
    buf = buf[:-1].view(e, cap, d)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    eo = torch.cat([torch.bmm(h, p["wd"]).reshape(e * cap, d),
                    x.new_zeros((1, d))])
    contrib = (eo[slot].float() * gates.reshape(-1, 1)).to(x.dtype)
    contrib = contrib.view(t, k, d)
    order = torch.argsort(eidx, dim=-1)
    contrib = contrib.gather(1, order[..., None].expand(t, k, d))
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    if m.n_shared:
        out = out + mlp_forward(p["shared"], xf)
    return out.reshape(b, s, d), aux
