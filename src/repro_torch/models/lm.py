"""Decoder-only LM assembly of the port: the dense family
(``src/repro/models/lm.py``).

The parameter tree is the reference's, with its leading superblock axis
on every leaf of ``blocks``, so parameters map across one to one
(``models/convert.py``).  A Python loop over superblocks takes the
place of ``lax.scan``.  Decode caches are stacked along the same axis
and written in place: ``lm_prefill`` and ``lm_decode`` return the cache
they were given.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map
from .config import ModelConfig
from .layers import (Params, _dtype, _init, attn_forward, init_attn,
                     init_mlp, mlp_forward, rmsnorm, unported)


# ---------------------------------------------------------------------------
# Superblock layout


def block_period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.attn_every:
        p = cfg.attn_every
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every_k_layers)
    if cfg.xlstm is not None:
        p = math.lcm(p, cfg.xlstm.slstm_every)
    return p


def slot_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Per superblock: list of (mixer, ffn) kinds; ffn == "none" for xLSTM."""
    period = block_period(cfg)
    out = []
    for i in range(period):
        if cfg.family == "ssm":
            x = cfg.xlstm
            mixer = "slstm" if (i % x.slstm_every == x.slstm_every - 1) \
                else "mlstm"
            out.append((mixer, "none"))
            continue
        if cfg.attn_on_layer(i):
            mixer = "mla" if cfg.mla else "attn"
        else:
            mixer = "mamba"
        ffn = "moe" if cfg.moe_on_layer(i) else "mlp"
        out.append((mixer, ffn))
    return out


def n_superblocks(cfg: ModelConfig) -> int:
    period = block_period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers in superblocks of {period}")
    return cfg.n_layers // period


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a model the port cannot run yet, at
    build time rather than inside a forward."""
    if cfg.family == "encdec" or cfg.n_encoder_layers:
        unported("the encoder-decoder family (models/encdec.py)", 21)
    if cfg.family == "ssm" or cfg.ssm is not None or cfg.attn_every:
        unported("the recurrent mixers (models/ssm.py)", 20)
    if cfg.moe is not None:
        unported("MoE (layers.init_moe, layers.moe_forward)", 18)
    if cfg.mla is not None:
        unported("MLA (layers.init_mla, layers.mla_forward)", 17)
    if cfg.m_rope or cfg.frontend != "none":
        unported("M-RoPE and the embeddings frontend", 19)


# ---------------------------------------------------------------------------
# Init


def _init_sublayer(cfg: ModelConfig, gen) -> Params:
    """One dense sublayer: attention, then the MLP."""
    dt = _dtype(cfg)
    return {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "mixer": init_attn(cfg, gen),
            "ln2": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
            "ffn": init_mlp(cfg, gen, cfg.d_ff)}


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters from the seeded generator ``gen``, on its
    device.  Shapes and keys are the reference's ``init_lm``'s; the
    numbers are torch's, not jax.random's."""
    check_ported(cfg)
    dt = _dtype(cfg)
    supers = [{f"slot{j}": _init_sublayer(cfg, gen)
               for j in range(len(slot_kinds(cfg)))}
              for _ in range(n_superblocks(cfg))]
    blocks = tree_map(lambda *xs: torch.stack(xs), *supers)
    p: Params = {
        "embed": _init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02),
        "blocks": blocks,
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


# ---------------------------------------------------------------------------
# Sublayer application


def _apply_sublayer(cfg: ModelConfig, p: Params, x, positions, cache=None,
                    cache_index=None):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, new_cache = attn_forward(cfg, p["mixer"], h, positions, cache,
                                cache_index)
    x = x + o
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_forward(p["ffn"], h2), new_cache


# ---------------------------------------------------------------------------
# Cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """Stacked (per-superblock) decode caches for each slot, zeros."""
    check_ported(cfg)
    shape = (n_superblocks(cfg), batch, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    dt = _dtype(cfg)
    return {f"slot{j}": (torch.zeros(shape, dtype=dt, device=device),
                         torch.zeros(shape, dtype=dt, device=device))
            for j in range(len(slot_kinds(cfg)))}


# ---------------------------------------------------------------------------
# Forward passes


def _embed(cfg: ModelConfig, p: Params, tokens):
    return p["embed"][tokens]


def _unembed(cfg: ModelConfig, p: Params, x):
    x = rmsnorm(x, p["ln_f"], cfg.norm_eps)
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return (x @ w).float()


def _unbind(tree) -> List:
    """The stacked leaves' rows as one tree per superblock, through ONE
    ``unbind`` per leaf: its backward stacks the rows' gradients once,
    where indexing row by row would add a full-size zero-padded
    gradient per superblock."""
    if isinstance(tree, dict):
        rows = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(rows.values())))
        return [{k: r[i] for k, r in rows.items()} for i in range(n)]
    return list(tree.unbind(0))


def _run(cfg: ModelConfig, p: Params, x, positions, cache, index):
    """The superblocks in order, for the forward, prefill and decode
    alike.  Without a cache, with gradients enabled and ``cfg.remat``,
    each superblock runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference's ``lm_forward`` wraps its scan
    body in ``jax.checkpoint``: activations are recomputed in the
    backward, so attention's forward kernel launches twice per layer in
    a training step."""
    n_slots = len(slot_kinds(cfg))
    remat = cfg.remat and cache is None and torch.is_grad_enabled()

    def superblock(x, bp, si):
        for j in range(n_slots):
            bc = None if cache is None else \
                tuple(c[si] for c in cache[f"slot{j}"])
            x, _ = _apply_sublayer(cfg, bp[f"slot{j}"], x, positions, bc,
                                   index)
        return x

    for si, bp in enumerate(_unbind(p["blocks"])):
        x = checkpoint(superblock, x, bp, si, use_reentrant=False) \
            if remat else superblock(x, bp, si)
    return x


def lm_forward(cfg: ModelConfig, p: Params, tokens, positions):
    """Training/prefill forward without cache.  Returns (logits, aux);
    aux, the MoE load-balancing loss, is 0 for the dense family."""
    x = _run(cfg, p, _embed(cfg, p, tokens), positions, None, None)
    return _unembed(cfg, p, x), torch.zeros((), device=x.device)


def lm_prefill(cfg: ModelConfig, p: Params, tokens, positions,
               cache: Dict, start=None):
    """Forward that fills the cache from position ``start`` (prefix-reuse
    serving prefills only the un-cached suffix).  Writes into ``cache``
    and returns (last-token logits, cache)."""
    x = _run(cfg, p, _embed(cfg, p, tokens), positions, cache,
             0 if start is None else int(start))
    return _unembed(cfg, p, x[:, -1:]), cache


def lm_decode(cfg: ModelConfig, p: Params, tokens, positions, cache: Dict,
              index):
    """One decode step.  tokens: (B, 1); index: an int or an int32 (B,)
    tensor.  Writes into ``cache`` and returns (logits, cache)."""
    x = _run(cfg, p, _embed(cfg, p, tokens), positions, cache, index)
    return _unembed(cfg, p, x), cache


# ---------------------------------------------------------------------------
# Loss


def lm_loss(cfg: ModelConfig, p: Params, tokens, positions, labels,
            aux_weight: float = 0.01):
    logits, aux = lm_forward(cfg, p, tokens, positions)
    logp = F.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = -ll.mean()
    return loss + aux_weight * aux, (loss, aux)
