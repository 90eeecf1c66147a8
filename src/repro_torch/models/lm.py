"""Decoder-only LM assembly of the port (``src/repro/models/lm.py``):
the dense family, MLA (minicpm3), MoE (qwen3-moe, llama4's dense/MoE
interleave), the embeddings frontend with M-RoPE (qwen2-vl), the xLSTM
blocks (xlstm-350m) and the hybrid superblocks of Mamba, attention and
MoE (jamba).  The encoder-decoder family is ``models/encdec.py``.

The parameter tree is the reference's, with its leading superblock axis
on every leaf of ``blocks``, so parameters map across one to one
(``models/convert.py``).  A Python loop over superblocks takes the
place of ``lax.scan``.  Decode caches are stacked along the same axis
and written in place: ``lm_prefill`` and ``lm_decode`` return the cache
they were given.  Attention writes its keys and values into the cache
itself; a recurrent mixer returns a new state, which is copied into the
cache's row of its superblock.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import trace
from ..launch.mesh import PartitionSpec as P
from ..tree import tree_map
from . import dist
from .config import ModelConfig
from .layers import (Params, _dtype, _init, attn_forward, init_attn,
                     init_mla, init_mlp, init_moe, mla_forward, mlp_forward,
                     moe_forward, rmsnorm)
from .ssm import (init_mamba, init_mlstm, init_slstm, mamba_forward,
                  mlstm_forward, slstm_forward)


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


# ---------------------------------------------------------------------------
# Init


_MIXER_INIT = {"attn": init_attn, "mla": init_mla, "mamba": init_mamba,
               "mlstm": init_mlstm, "slstm": init_slstm}
RECURRENT = ("mamba", "mlstm", "slstm")


def _init_sublayer(cfg: ModelConfig, gen, mixer: str, ffn: str) -> Params:
    """One sublayer: the mixer (attention, MLA, Mamba, mLSTM or sLSTM),
    then the MLP or the MoE; an xLSTM block (ffn "none") has no ``ln2``
    and no ``ffn``, as in the reference."""
    dt = _dtype(cfg)
    ones = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    p = {"ln1": ones, "mixer": _MIXER_INIT[mixer](cfg, gen)}
    if ffn != "none":
        p["ln2"] = ones.clone()
        p["ffn"] = init_moe(cfg, gen) if ffn == "moe" \
            else init_mlp(cfg, gen, cfg.d_ff)
    return p


def stack_rows(make, n: int) -> Params:
    """``n`` blocks from ``make()`` stacked along a new leading axis, each
    copied into its row as it is made, so the peak is the stack plus one
    block."""
    stack = None
    for i in range(n):
        block = make()
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((n,) + x.shape), block)
        tree_map(lambda row, x: row[i].copy_(x), stack, block)
    return stack


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters from the seeded generator ``gen``, on its
    device.  Shapes and keys are the reference's ``init_lm``'s; the
    numbers are torch's, not jax.random's."""
    dt = _dtype(cfg)
    kinds = slot_kinds(cfg)
    blocks = stack_rows(
        lambda: {f"slot{j}": _init_sublayer(cfg, gen, mixer, ffn)
                 for j, (mixer, ffn) in enumerate(kinds)},
        n_superblocks(cfg))
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


def _apply_sublayer(cfg: ModelConfig, p: Params, kind: Tuple[str, str], x,
                    positions, cache=None, cache_index=None):
    """Returns (x, aux, new_cache); aux is the MoE's load-balancing loss,
    None without a MoE.  A recurrent mixer takes its state from
    ``cache`` and returns the new one as ``new_cache``.  The span
    ``lm.sublayer``'s self time is the norms and the residual adds."""
    mixer, ffn = kind
    with trace.span("lm.sublayer"):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            o, new_cache = mamba_forward(cfg, p["mixer"], h, cache)
        elif mixer == "mlstm":
            o, new_cache = mlstm_forward(cfg, p["mixer"], h, cache)
        elif mixer == "slstm":
            o, new_cache = slstm_forward(cfg, p["mixer"], h, cache)
        else:
            fwd = mla_forward if mixer == "mla" else attn_forward
            o, new_cache = fwd(cfg, p["mixer"], h, positions, cache,
                               cache_index)
        x = x + o
        if ffn == "none":
            return x, None, new_cache
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        with trace.span("lm.ffn"):
            if ffn == "moe":
                o2, aux = moe_forward(cfg, p["ffn"], h2)
            else:
                o2, aux = mlp_forward(p["ffn"], h2), None
        return x + o2, aux, new_cache


# ---------------------------------------------------------------------------
# Cache


# a sequence-sharded cache leaf (ns, B, Hkv, S, Dh) on a GroupMesh: the
# rank's batch is its DP block already, its S-slice is cut over "model"
SEQ_SPEC = P(None, None, None, "model", None)


def seq_sharded_mesh():
    """The mesh whose ranks hold a sequence-sharded decode cache: a
    ``GroupMesh`` with a "model" axis set under ``dist.optimized()``,
    where a one-token decode takes ``layers._decode_attn_seq_sharded``;
    else None."""
    mesh = dist.get_mesh()
    if mesh is None or not mesh.spans_processes or not dist.optimized() \
            or "model" not in mesh.axis_names:
        return None
    return mesh


def seq_sharded_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The cache entries that a rank of ``seq_sharded_mesh`` holds as
    S-slices: GQA attention's K and V (the decoder's self-attention's in
    the encoder-decoder family).  Every other entry (MLA's latent, the
    recurrent states, the cross-attention's K and V) it holds whole."""
    if cfg.family == "encdec":
        return ("self",)
    return tuple(f"slot{j}" for j, (m, _) in enumerate(slot_kinds(cfg))
                 if m == "attn")


def seq_slice_len(cfg: ModelConfig, max_len: int) -> int:
    """The positions a rank allocates of a GQA cache of ``max_len``: its
    S-slice, ``max_len`` / tp, over the ranks of ``seq_sharded_mesh``
    (tp the "model" axis' size); else ``max_len``.  A length that tp
    does not divide raises: the sequence-sharded decode cannot serve it
    and the rank holds no whole cache to fall back on."""
    mesh = seq_sharded_mesh()
    if mesh is None or not seq_sharded_keys(cfg):
        return max_len
    tp = mesh.shape["model"]
    if max_len % tp:
        raise ValueError(f"a sequence-sharded cache over ranks: {max_len} "
                         f"positions do not split into {tp} S-slices")
    return max_len // tp


def gather_seq(cfg: ModelConfig, cache: Dict, index: int) -> Dict:
    """For a prefill from ``index`` over the ranks of ``seq_sharded_mesh``
    (or ``cache`` as it is without one): ``cache`` with each S-sliced
    entry (``seq_sharded_keys``) whole along the sequence, zeros when the
    prefill starts at 0, else its S-slices gathered over "model"; every
    other entry is the rank's own.  ``scatter_seq`` writes the slices
    back."""
    mesh = seq_sharded_mesh()
    if mesh is None:
        return cache
    tp = mesh.shape["model"]

    def whole(leaf):
        if not index:
            shape = list(leaf.shape)
            shape[3] *= tp
            return leaf.new_zeros(shape)
        return mesh.globalize(leaf, SEQ_SPEC)
    keys = seq_sharded_keys(cfg)
    return {k: tree_map(whole, v) if k in keys else v
            for k, v in cache.items()}


def scatter_seq(cfg: ModelConfig, held: Dict, cache: Dict) -> Dict:
    """``held`` (a rank's cache) after a prefill into ``gather_seq``'s
    ``cache``: each S-sliced entry's slice copied back from the whole
    one, which is then freed; the other entries were written in place.
    Without ``seq_sharded_mesh``, ``cache``."""
    mesh = seq_sharded_mesh()
    if mesh is None:
        return cache
    for k in seq_sharded_keys(cfg):
        tree_map(lambda dst, src: dst.copy_(
            mesh.block(src, SEQ_SPEC, mesh.my_coords)), held[k], cache[k])
    return held


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """Stacked (per-superblock) decode caches for each slot, with the
    reference's shapes and dtypes: K and V (ns, B, Hkv, max_len, Dh) for
    attention, the latent (ns, B, max_len, r) and its rotary key (ns, B,
    max_len, dr) for MLA, in the model's dtype; Mamba's conv state (ns,
    B, K-1, d_in) in the model's dtype and its h (ns, B, d_in, N) in
    float32; the mLSTM's (C, n, m) and the sLSTM's (c, n, m = -10, h) in
    float32.  Every leaf is a tensor of its own (none shares storage),
    since the model writes into them.

    Over the ranks of a ``GroupMesh`` under ``dist.optimized()``
    (``seq_sharded_mesh``), ``batch`` is the rank's DP block and the
    rank's cache is laid out leaf by leaf: GQA attention's K and V are
    its S-slice, (ns, batch, Hkv, max_len / tp, Dh) with tp the "model"
    axis' size (the sequence-sharded decode; ``seq_slice_len``), and
    every other leaf is whole, as the one-device model reads it (the
    reference leaves those mixers to GSPMD).  The launch layer's
    ``launch/sharded_serve.py`` brings blocks under
    ``launch/sharding.py::cache_specs`` to this layout and back."""
    ns, dt = n_superblocks(cfg), _dtype(cfg)
    s_attn = seq_slice_len(cfg, max_len)

    def zeros(*shape, dtype=dt):
        return torch.zeros((ns, batch) + shape, dtype=dtype, device=device)
    f32 = torch.float32
    cache = {}
    for j, (mixer, _ffn) in enumerate(slot_kinds(cfg)):
        if mixer == "mla":
            m = cfg.mla
            leaves = (zeros(max_len, m.kv_lora_rank),
                      zeros(max_len, m.qk_rope_head_dim))
        elif mixer == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            leaves = (zeros(s.d_conv - 1, d_in),
                      zeros(d_in, s.d_state, dtype=f32))
        elif mixer == "mlstm":
            h = cfg.n_heads
            dh = int(cfg.xlstm.proj_factor * cfg.d_model) // h
            leaves = (zeros(h, dh, dh, dtype=f32), zeros(h, dh, dtype=f32),
                      zeros(h, dtype=f32))
        elif mixer == "slstm":
            d = cfg.d_model
            leaves = (zeros(d, dtype=f32), zeros(d, dtype=f32),
                      zeros(d, dtype=f32) - 10.0, zeros(d, dtype=f32))
        else:
            shape = (cfg.n_kv_heads, s_attn, cfg.head_dim)
            leaves = (zeros(*shape), zeros(*shape))
        cache[f"slot{j}"] = leaves
    return cache


def mla_stack(cfg: ModelConfig) -> bool:
    """Whether every sublayer is MLA then an MLP (minicpm3): outside its
    attention, a one-token decode of such a stack reads no value on the
    host once its latent index is a device tensor
    (``layers.mla_forward``), so CUDA graphs can replay it between the
    attention calls (``Model.decode_step``).  GQA attention reads its
    index on the host; the MoE's dispatch and the recurrent mixers are
    not captured either."""
    return cfg.family != "encdec" and all(
        kind == ("mla", "mlp") for kind in slot_kinds(cfg))


# ---------------------------------------------------------------------------
# Forward passes


def _embed(cfg: ModelConfig, p: Params, tokens_or_embeds):
    """Token ids through the embedding table, or, with the embeddings
    frontend (qwen2-vl), precomputed (B, S, d) embeddings taken as they
    are; the table stays in the parameters, as in the reference."""
    if cfg.frontend == "embeds":
        return tokens_or_embeds.to(_dtype(cfg))
    return p["embed"][tokens_or_embeds]


def _unembed(cfg: ModelConfig, p: Params, x):
    with trace.span("lm.unembed"):
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
    alike.  Returns (x, aux): aux sums the MoE layers' load-balancing
    losses (0 without MoE).  Without a cache, with gradients enabled and
    ``cfg.remat``, each superblock runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference's ``lm_forward`` wraps its scan
    body in ``jax.checkpoint``: activations are recomputed in the
    backward, so attention's forward kernel launches twice per layer in
    a training step.  An xLSTM superblock is the exception: under
    ``cfg.remat`` its loops over time recompute in chunks
    (``ssm._scan``), which is where its activations are, and recomputing
    the superblock whole as well would run every loop's forward once
    more, and those loops' eager dispatch is the step's time."""
    kinds = slot_kinds(cfg)
    remat = cfg.remat and cache is None and torch.is_grad_enabled() \
        and cfg.family != "ssm"

    def superblock(x, aux, bp, si):
        for j, kind in enumerate(kinds):
            bc = None if cache is None else \
                tuple(c[si] for c in cache[f"slot{j}"])
            x, a, nc = _apply_sublayer(cfg, bp[f"slot{j}"], kind, x,
                                       positions, bc, index)
            if bc is not None and kind[0] in RECURRENT:
                for dst, src in zip(bc, nc):
                    dst.copy_(src)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, bp in enumerate(_unbind(p["blocks"])):
        x, aux = checkpoint(superblock, x, aux, bp, si,
                            use_reentrant=False) \
            if remat else superblock(x, aux, bp, si)
    return x, aux


def lm_forward(cfg: ModelConfig, p: Params, tokens_or_embeds, positions):
    """Training/prefill forward without cache.  Returns (logits, aux);
    aux, the MoE load-balancing loss summed over layers, is 0 without
    MoE."""
    x, aux = _run(cfg, p, _embed(cfg, p, tokens_or_embeds), positions,
                  None, None)
    return _unembed(cfg, p, x), aux


def lm_prefill(cfg: ModelConfig, p: Params, tokens_or_embeds, positions,
               cache: Dict, start=None):
    """Forward that fills the cache from position ``start`` (prefix-reuse
    serving prefills only the un-cached suffix).  Writes into ``cache``
    and returns (last-token logits, cache).

    Over ranks with a sequence-sharded cache (``seq_sharded_mesh``) the
    prefill is not sharded, as the reference's: the rank runs its DP
    block against whole-sequence K and V (``gather_seq``), copies their
    S-slices back into ``cache`` and frees the whole ones
    (``scatter_seq``)."""
    index = 0 if start is None else int(start)
    held = cache
    cache = gather_seq(cfg, held, index)
    x, _ = _run(cfg, p, _embed(cfg, p, tokens_or_embeds), positions, cache,
                index)
    return _unembed(cfg, p, x[:, -1:]), scatter_seq(cfg, held, cache)


def lm_decode(cfg: ModelConfig, p: Params, tokens_or_embeds, positions,
              cache: Dict, index):
    """One decode step.  tokens: (B, 1) (or embeds (B, 1, d)); index: an
    int, an int32 (B,) tensor, or (an MLA stack's) a 0-d tensor.  Writes
    into ``cache`` and returns (logits, cache)."""
    x, _ = _run(cfg, p, _embed(cfg, p, tokens_or_embeds), positions, cache,
                index)
    return _unembed(cfg, p, x), cache


# ---------------------------------------------------------------------------
# Loss


def lm_loss(cfg: ModelConfig, p: Params, tokens_or_embeds, positions,
            labels, aux_weight: float = 0.01):
    logits, aux = lm_forward(cfg, p, tokens_or_embeds, positions)
    return loss_from_logits(logits, aux, labels, aux_weight)


def loss_from_logits(logits, aux, labels, aux_weight: float = 0.01):
    """Mean next-token cross-entropy of float32 ``logits`` against
    ``labels``, plus ``aux_weight`` times ``aux``: (total, (loss, aux))."""
    logp = F.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = -ll.mean()
    return loss + aux_weight * aux, (loss, aux)
