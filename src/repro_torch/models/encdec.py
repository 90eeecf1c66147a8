"""Encoder-decoder backbone of the port (SeamlessM4T's text/speech
transformer; ``src/repro/models/encdec.py``).

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T, d).  Its self-attention is not
causal; the decoder is a causal stack with cross-attention over the
encoder's output.  Attention runs through ``layers.attn_forward`` and so
through ``kernels/flash_attention`` on the card: the encoder's
self-attention and the decoder's cross-attention are non-causal calls,
the cross ones with Sq != Skv.

The parameter tree is the reference's (``enc_blocks`` and ``dec_blocks``
stacked along a leading layer axis), so parameters map across one to one
(``models/convert.py``).  A Python loop over the layers takes the place
of ``lax.scan``; under ``cfg.remat`` each layer of a differentiated
forward runs under ``torch.utils.checkpoint``.  The decode cache is
{"self": (k, v), "cross": (k, v)}, each leaf (n_layers, B, Hkv, S, Dh).
The self-attention leaves are written in place, as in ``lm.py``.  The
prefill computes the cross K and V from the encoder's output and
returns them as the cache's ``cross`` leaves, whatever length
``init_dec_cache`` gave them, as the reference's prefill returns the
ones it computed: they are written into the given leaves when those have
the encoder's length, else new leaves take their place in the returned
cache.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (Params, _dtype, _init, attn_forward, init_attn,
                     init_mlp, mlp_forward, rmsnorm)
from .lm import _unbind, gather_seq, scatter_seq, seq_slice_len, \
    stack_rows


def init_encdec(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters from the seeded generator ``gen``, on its
    device.  Keys, shapes and dtypes are the reference's ``init_encdec``'s;
    the numbers are torch's, not jax.random's."""
    dt = _dtype(cfg)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=gen.device)

    def enc_layer():
        return {"ln1": ones(), "attn": init_attn(cfg, gen), "ln2": ones(),
                "ffn": init_mlp(cfg, gen, cfg.d_ff)}

    def dec_layer():
        return {"ln1": ones(), "self_attn": init_attn(cfg, gen),
                "ln_x": ones(), "cross_attn": init_attn(cfg, gen),
                "ln2": ones(), "ffn": init_mlp(cfg, gen, cfg.d_ff)}

    return {
        "enc_blocks": stack_rows(enc_layer, cfg.n_encoder_layers),
        "dec_blocks": stack_rows(dec_layer, cfg.n_layers),
        "embed": _init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02),
        "ln_enc": ones(),
        "ln_f": ones(),
        "lm_head": _init(gen, (cfg.d_model, cfg.vocab_size), dt),
    }


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode(cfg: ModelConfig, p: Params, enc_embeds, enc_pos):
    """(B, T, d) frame embeddings -> the encoder's output (B, T, d):
    non-causal self-attention and the MLP, layer by layer."""
    x = enc_embeds.to(_dtype(cfg))

    def body(x, bp):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        o, _ = attn_forward(cfg, bp["attn"], h, enc_pos, causal=False)
        x = x + o
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + mlp_forward(bp["ffn"], h)

    remat = _remat(cfg)
    for bp in _unbind(p["enc_blocks"]):
        x = checkpoint(body, x, bp, use_reentrant=False) if remat \
            else body(x, bp)
    return rmsnorm(x, p["ln_enc"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, bp: Params, enc_out):
    """A decoder layer's cross-attention K and V (B, Hkv, T, Dh) from the
    encoder's output."""
    b, t, _ = enc_out.shape
    h, dh = cfg.n_kv_heads, cfg.head_dim
    k = enc_out @ bp["cross_attn"]["wk"]
    v = enc_out @ bp["cross_attn"]["wv"]
    return (k.view(b, t, h, dh).transpose(1, 2),
            v.view(b, t, h, dh).transpose(1, 2))


def _dec_sublayer(cfg, bp, x, pos, self_cache, index, cross_kv):
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    o, new_self = attn_forward(cfg, bp["self_attn"], h, pos, self_cache,
                               index)
    x = x + o
    h = rmsnorm(x, bp["ln_x"], cfg.norm_eps)
    o, _ = attn_forward(cfg, bp["cross_attn"], h, pos, kv_override=cross_kv)
    x = x + o
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + mlp_forward(bp["ffn"], h), new_self


def _logits(cfg: ModelConfig, p: Params, x):
    x = rmsnorm(x, p["ln_f"], cfg.norm_eps)
    return (x @ p["lm_head"]).float()


def encdec_forward(cfg: ModelConfig, p: Params, enc_embeds, dec_tokens,
                   enc_pos, dec_pos):
    """Teacher-forcing training forward.  Returns (logits, aux = 0)."""
    enc_out = encode(cfg, p, enc_embeds, enc_pos)
    x = p["embed"][dec_tokens]

    def body(x, enc_out, bp):
        ckv = _cross_kv(cfg, bp, enc_out)
        return _dec_sublayer(cfg, bp, x, dec_pos, None, None, ckv)[0]

    remat = _remat(cfg)
    for bp in _unbind(p["dec_blocks"]):
        x = checkpoint(body, x, enc_out, bp, use_reentrant=False) if remat \
            else body(x, enc_out, bp)
    return _logits(cfg, p, x), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_dec_cache(cfg: ModelConfig, batch: int, max_len: int,
                   enc_len: int, device) -> Dict:
    """Zeroed decode caches with the reference's shapes and dtype: the
    self-attention's K and V (n_layers, B, Hkv, max_len, Dh) and the
    cross-attention's (n_layers, B, Hkv, enc_len, Dh).  Every leaf is a
    tensor of its own.  Over the ranks of ``lm.seq_sharded_mesh`` the
    self-attention's leaves are the rank's S-slice (``seq_slice_len``)
    and the cross-attention's are whole."""
    dt = _dtype(cfg)
    nl, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    s_self = seq_slice_len(cfg, max_len)

    def zeros(s):
        return torch.zeros((nl, batch, hkv, s, dh), dtype=dt, device=device)
    return {"self": (zeros(s_self), zeros(s_self)),
            "cross": (zeros(enc_len), zeros(enc_len))}


def encdec_prefill(cfg: ModelConfig, p: Params, enc_embeds, enc_pos,
                   dec_tokens, dec_pos, cache: Dict):
    """Encode, then run the decoder's prefix from position 0: its self
    K and V are written into ``cache["self"]``, and the cross K and V of
    every layer become the returned cache's ``cross`` leaves (written
    into the given ones when they have the encoder's length).  Returns
    (last-token logits, cache).  Over ranks with a sequence-sharded
    cache the self-attention runs against whole-sequence K and V and
    their S-slices are copied back, as ``lm.lm_prefill`` does."""
    held = cache
    cache = gather_seq(cfg, held, 0)
    enc_out = encode(cfg, p, enc_embeds, enc_pos)
    x = p["embed"][dec_tokens]
    b, t, _ = enc_out.shape
    ck, cv = cache["cross"]
    want = (cfg.n_layers, b, cfg.n_kv_heads, t, cfg.head_dim)
    if tuple(ck.shape) != want:
        ck, cv = (enc_out.new_empty(want) for _ in range(2))
    for li, bp in enumerate(_unbind(p["dec_blocks"])):
        k, v = _cross_kv(cfg, bp, enc_out)
        ck[li].copy_(k)
        cv[li].copy_(v)
        sc = tuple(c[li] for c in cache["self"])
        x, _ = _dec_sublayer(cfg, bp, x, dec_pos, sc, 0, (ck[li], cv[li]))
    held = scatter_seq(cfg, held, cache)
    return _logits(cfg, p, x[:, -1:]), {"self": held["self"],
                                        "cross": (ck, cv)}


def encdec_decode(cfg: ModelConfig, p: Params, dec_tokens, dec_pos,
                  cache: Dict, index):
    """One decode step against the cached self K and V (written in place
    at ``index``: an int, or an int32 (B,) tensor) and the cross K and
    V.  Returns (logits, cache)."""
    x = p["embed"][dec_tokens]
    ck, cv = cache["cross"]
    for li, bp in enumerate(_unbind(p["dec_blocks"])):
        sc = tuple(c[li] for c in cache["self"])
        x, _ = _dec_sublayer(cfg, bp, x, dec_pos, sc, index,
                             (ck[li], cv[li]))
    return _logits(cfg, p, x), cache
