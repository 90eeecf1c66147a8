"""Transformer building blocks of the port, over parameter dicts with the
reference's keys and shapes (``src/repro/models/layers.py``).

Ported: the dense GQA family (optional qk-norm and biases, rotary
embeddings) and the SwiGLU MLP.  Attention runs through
``kernels/flash_attention/ops.mha``: the CUDA kernels for tensors on the
card (the backward kernel when an input requires a gradient), its plain
version for tensors on the CPU.

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
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def unported(what: str, item: int):
    """Raise for a part of the reference the port does not have yet."""
    raise NotImplementedError(
        f"repro_torch: not ported yet: {what} (ROADMAP queue 1 item "
        f"{item})")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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
    unported("M-RoPE (layers.mrope_cos_sin)", 19)


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
    unported("MLA (layers.init_mla)", 17)


def mla_forward(cfg: ModelConfig, p: Params, x, positions, cache=None,
                cache_index=None):
    unported("MLA (layers.mla_forward)", 17)


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
    unported("MoE (layers.init_moe)", 18)


def moe_forward(cfg: ModelConfig, p: Params, x):
    unported("MoE (layers.moe_forward)", 18)
