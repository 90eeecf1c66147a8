"""Plain PyTorch version of flash attention (the CPU path and the card's
oracle for ``csrc/flash_attention.cu``).

The reference's ``ref.py`` (one ``kv_len``, a static ``q_offset``) with
what the serving path adds: ``kv_len`` and ``q_offset`` may hold one
value per batch row, and KV heads are shared by ``Hq / Hkv`` query
heads (GQA).
"""
import torch

NEG_INF = -1e30


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


def mha_ref(q, k, v, kv_len=None, *, causal=True, q_offset=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0.
    kv_len defaults to Skv, q_offset to Skv - Sq."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    dev = q.device
    kvl = per_row(kv_len, b, skv, dev).view(b, 1, 1, 1)
    qo = per_row(q_offset, b, skv - sq, dev).view(b, 1, 1, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    k_pos = torch.arange(skv, device=dev).view(1, 1, 1, skv)
    mask = k_pos < kvl
    if causal:
        q_pos = torch.arange(sq, device=dev).view(1, 1, sq, 1) + qo
        mask = mask & (k_pos <= q_pos)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
