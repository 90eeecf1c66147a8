"""Plain PyTorch version of flash attention (the CPU path and the card's
oracle for ``csrc/flash_attention.cu`` and ``csrc/flash_attention_sm90.cu``,
and, through autograd, ``mha_bwd_ref`` for ``csrc/flash_attention_bwd.cu``).
``mha_lse_ref`` gives the row statistics the bf16 forward saves, and
``mha_bwd_lse_ref`` writes out the bf16 backward's arithmetic from them.

The reference's ``ref.py`` (one ``kv_len``, a static ``q_offset``) with
what the serving path adds: ``kv_len`` and ``q_offset`` may hold one
value per batch row, and KV heads are shared by ``Hq / Hkv`` query
heads (GQA).  ``mha_split_ref`` writes out the bf16 kernel's split-KV
arithmetic for the tests.
"""
import math

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)


def per_row(x, b: int, default: int, device) -> torch.Tensor:
    """None / int / int tensor of shape (), (1,) or (B,) -> (B,) int32 on
    ``device`` (a Python int becomes a fill, never a host copy)."""
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        x = x.to(device=device, dtype=torch.int32).reshape(-1)
        if x.numel() == 1:
            return x.expand(b).contiguous()
        if x.numel() != b:
            raise ValueError(f"attention: {x.numel()} values for {b} rows")
        return x.contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _scores(q, k, kv_len, causal, q_offset):
    """(scores, mask), (B, Hq, Sq, Skv): q.k / sqrt(D) in f32 with the
    masked entries -1e30, and which entries are visible."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
    dev = q.device
    kvl = per_row(kv_len, b, skv, dev).view(b, 1, 1, 1)
    qo = per_row(q_offset, b, skv - sq, dev).view(b, 1, 1, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    k_pos = torch.arange(skv, device=dev).view(1, 1, 1, skv)
    mask = k_pos < kvl
    if causal:
        q_pos = torch.arange(sq, device=dev).view(1, 1, sq, 1) + qo
        mask = mask & (k_pos <= q_pos)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def mha_ref(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) (MLA:
    Dv < D), Hq % Hkv == 0.  kv_len defaults to Skv, q_offset to
    Skv - Sq."""
    s, _ = _scores(q, k, kv_len, causal, q_offset)
    return _softmax_v(s, q, v)


def _softmax_v(s, q, v):
    hq, hkv = q.shape[1], v.shape[1]
    if hq != hkv:
        v = v.repeat_interleave(hq // hkv, dim=1)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def mha_with_lse_ref(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """(``mha_ref``, ``mha_lse_ref``) of the same inputs from one
    computation of the scores: ``ops.mha_lse``'s plain version."""
    s, mask = _scores(q, k, kv_len, causal, q_offset)
    return _softmax_v(s, q, v), _lse(s, mask)


def mha_bwd_ref(q, k, v, dout, kv_len=None, *, causal=True,
                q_offset=None):
    """(dQ, dK, dV) of ``mha_ref`` for the upstream gradient ``dout``, by
    autograd: the plain version of ``csrc/flash_attention_bwd.cu``.  A
    masked score has no gradient (the ``where``), and a row that sees no
    key, whose softmax is uniform, adds ``dout / Skv`` to every key's
    dV."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = mha_ref(qq, kk, vv, kv_len, causal=causal, q_offset=q_offset)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def mha_lse_ref(q, k, kv_len=None, *, causal=True, q_offset=None):
    """Each row's statistic, (B, Hq, Sq) float32: ln of the sum of
    exp(q.k / sqrt(D)) over the row's visible keys (the natural-log
    domain), +inf for a row that sees no key.  The bf16 forward kernel
    saves it for the backward."""
    s, mask = _scores(q, k, kv_len, causal, q_offset)
    return _lse(s, mask)


def _lse(s, mask):
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, math.inf))


def mha_bwd_lse_ref(q, k, v, out, dout, lse, kv_len=None, *, causal=True,
                    q_offset=None):
    """(dQ, dK, dV) the way the bf16 backward kernel computes them, from
    the forward's output and row statistics ``lse`` (``mha_lse_ref``):
    P = exp(s - lse) with masked entries 0; a row that sees no key
    (lse = +inf) has P = 1/Skv on every key and dS = 0; delta =
    rowsum(dout * out); dS = P (dout V^T - delta); P and dS are rounded
    to q's dtype before they meet dout, K and Q (the tensor cores' bf16
    operands; nothing in f32); dV = P^T dout and dK = dS^T Q / sqrt(D)
    summed over each KV head's query heads, dQ = dS K / sqrt(D), with D
    the query/key head dim (dV keeps v's value head dim, MLA's 64 under
    96).  The tests use it, the main path does not."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    s, mask = _scores(q, k, kv_len, causal, q_offset)
    lse = lse.float()[..., None]
    blind = torch.isinf(lse)
    p = torch.where(mask, torch.exp(s - torch.where(blind, 0.0, lse)), 0.0)
    p = torch.where(blind, torch.full_like(p, 1.0 / max(skv, 1)), p)
    do = dout.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    delta = (do * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = torch.where(blind, 0.0, p * (dp - delta))
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    scale = 1.0 / d ** 0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = dk.view(b, hkv, g, skv, d).sum(2)
    dv = dv.view(b, hkv, g, skv, v.shape[3]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_split_ref(q, k, v, kv_len=None, *, causal=True, q_offset=None,
                  split_keys=128, tile_keys=64):
    """The split-KV arithmetic of ``csrc/flash_attention_sm90.cu`` in
    plain PyTorch (f32; the tests use it, the main path does not).  Each
    fixed split of ``split_keys`` keys runs its own online softmax over
    ``tile_keys``-key tiles in order, from (m, l, acc) = (-1e30, 0, 0),
    in the log2 domain with masked probabilities exactly 0; ``l`` sums
    the f32 probabilities and ``acc`` the products of the probabilities
    rounded to q's dtype with V.  The splits then merge in increasing key
    order.  A row that sees no key ends with L = 0 and returns the mean
    of V over all Skv keys, as ``mha_ref`` (scores all -1e30, a uniform
    softmax) and the reference's formula do."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    qf = q.float()
    kvl = per_row(kv_len, b, skv, dev).view(b, 1, 1, 1)
    q_pos = torch.arange(sq, device=dev).view(1, 1, sq, 1) + \
        per_row(q_offset, b, skv - sq, dev).view(b, 1, 1, 1)
    scale = LOG2E / d ** 0.5
    neg = torch.tensor(NEG_INF, device=dev)

    def fresh():
        return (torch.full((b, hq, sq, 1), NEG_INF, device=dev),
                torch.zeros((b, hq, sq, 1), device=dev),
                torch.zeros((b, hq, sq, v.shape[3]), device=dev))

    M, L, ACC = fresh()
    for s0 in range(0, skv, split_keys):
        m, l, acc = fresh()
        for t0 in range(s0, min(s0 + split_keys, skv), tile_keys):
            t1 = min(t0 + tile_keys, skv)
            k_pos = torch.arange(t0, t1, device=dev).view(1, 1, 1, -1)
            vis = k_pos < kvl
            if causal:
                vis = vis & (k_pos <= q_pos)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, t0:t1]) * scale
            s = torch.where(vis, s, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(vis, torch.exp2(s - m_new), 0.0)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype).float(), vf[:, :, t0:t1])
            m = m_new
        mn = torch.maximum(M, m)
        wa, wb = torch.exp2(M - mn), torch.exp2(m - mn)
        L, ACC, M = L * wa + l * wb, ACC * wa + acc * wb, mn
    out = torch.where(L == 0, vf.mean(2, keepdim=True),
                      ACC / L.clamp_min(1e-30))
    return out.to(q.dtype)
