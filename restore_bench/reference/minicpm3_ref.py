"""A float32 forward pass of the MiniCPM3 architecture as the config
file gives it (multi-head latent attention, SwiGLU MLP, RMSNorm,
rotate-half RoPE on the rope part of queries and keys), in plain
PyTorch with TF32 off, over whole sequences, layer by layer and in
blocks of queries, so that it fits beside nothing else on the card.

Departures from the published model, kept because the program departs
the same way: no muP scales (``scale_emb``, ``scale_depth``,
``dim_model_base``) and no LongRoPE scaling; the logits are
``rmsnorm(x) @ lm_head`` with an untied head.

``weights`` is the benchmark's parameter tree (``yardstick/
mla_weights.py``); leaves are read as they are and upcast here.
``quantize`` (the control) rounds every matrix, per output column, to
float8 e4m3 before it is used."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch


@contextlib.contextmanager
def no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """w (in, out) in float32, each output column scaled to e4m3's range
    and rounded to it."""
    scale = w.abs().amax(0, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (..., S, D) rotate-half over its last axis at positions pos."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, block):
    """Causal softmax attention, q/k (H, S, Dq), v (H, S, Dv), in
    blocks of queries."""
    h, s, dq = q.shape
    out = torch.empty((h, s, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    scale = dq ** -0.5
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        sc = torch.matmul(q[:, i0:i1], k[:, :i1].transpose(1, 2)) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        out[:, i0:i1] = torch.matmul(torch.softmax(sc, -1), v[:, :i1])
    return out


def _layer(c, w, x, pos, block):
    h_, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    kvr, eps, theta = c["kv_lora_rank"], c["rms_norm_eps"], c["rope_theta"]
    s = x.shape[0]
    h = _rms(x, w["ln1"], eps)
    q = _rms(h @ w["wdq"], w["q_norm"], eps) @ w["wuq"]
    q = q.view(s, h_, nope + rope).transpose(0, 1)            # (H, S, 96)
    ckv = h @ w["wdkv"]
    c_kv = _rms(ckv[:, :kvr], w["kv_norm"], eps)
    k_rope = _rope(ckv[:, kvr:], pos, theta)                  # (S, 32)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, theta)], -1)
    k_nope = (c_kv @ w["wuk"]).view(s, h_, nope).transpose(0, 1)
    v = (c_kv @ w["wuv"]).view(s, h_, vd).transpose(0, 1)
    k = torch.cat([k_nope, k_rope[None].expand(h_, s, rope)], -1)
    o = _attention(q, k, v, block).transpose(0, 1).reshape(s, h_ * vd)
    x = x + o @ w["wo"]
    h2 = _rms(x, w["ln2"], eps)
    g = torch.nn.functional.silu(h2 @ w["wg"]) * (h2 @ w["wu"])
    return x + g @ w["wd"]


MATRICES = ("wdq", "wuq", "wdkv", "wuk", "wuv", "wo", "wg", "wu", "wd")


@torch.no_grad()
def logits(c: Dict, weights: Dict, seqs: List[torch.Tensor],
           rows: List[torch.Tensor], quantize: bool = False,
           block: int = 512) -> List[torch.Tensor]:
    """Float32 logits of each token sequence at the given row indices
    (the positions whose next token is judged); all sequences go
    through each layer before the next, whose weights are upcast
    once."""
    blocks = weights["blocks"]["slot0"]
    mix, ffn = blocks["mixer"], blocks["ffn"]
    cast = fp8_round if quantize else (lambda t: t)
    with no_tf32():
        emb = weights["embed"]
        xs = [emb[t].to(torch.float32) for t in seqs]
        if quantize:
            xs = [fp8_round(emb[t].to(torch.float32).t()).t() for t in seqs]
        pos = [torch.arange(t.shape[0], device=t.device) for t in seqs]
        for li in range(c["num_hidden_layers"]):
            w = {k: cast(mix[k][li].to(torch.float32)) for k in
                 ("wdq", "wuq", "wdkv", "wuk", "wuv", "wo")}
            w.update({k: cast(ffn[k][li].to(torch.float32))
                      for k in ("wg", "wu", "wd")})
            w["ln1"] = blocks["ln1"][li].to(torch.float32)
            w["ln2"] = blocks["ln2"][li].to(torch.float32)
            w["q_norm"] = mix["q_norm"][li].to(torch.float32)
            w["kv_norm"] = mix["kv_norm"][li].to(torch.float32)
            xs = [_layer(c, w, x, p, block) for x, p in zip(xs, pos)]
            del w
        head = cast(weights["lm_head"].to(torch.float32))
        lnf = weights["ln_f"].to(torch.float32)
        return [_rms(x[r], lnf, c["rms_norm_eps"]) @ head
                for x, r in zip(xs, rows)]
