"""Operations and bytes of one call of each measured kernel, from its
shapes (frozen from ``chip_smoke.py``'s phase 1 and the attention bound
of PERF.md).  Each input byte is counted read once and each output byte
written once; work that depends on the data counts what these inputs
need.  Returns the least seconds the H100 could take for the call."""
from __future__ import annotations

import numpy as np

from .peaks import BF16_FLOPS, FP32_FLOPS, bound_s


def join_probe_s(n: int, r: int) -> float:
    """n probe lanes into a sorted build side of r keys: a 4-byte hash
    in and a 4-byte position out a lane, 4 bytes a key; a binary search
    of bit_length(r) rounds a lane."""
    rounds = max(1, int(r).bit_length())
    return bound_s(8 * n + 4 * r, n * rounds, FP32_FLOPS)


def segment_sum_s(n: int, d: int, s: int) -> float:
    """n rows of d float32 lanes and an int32 id summed into s
    segments."""
    return bound_s(4 * n + 4 * n * d + 4 * s * d, n * d, FP32_FLOPS)


def visible_pairs(sq: int, kv_len: int, q_offset: int, causal: bool) -> int:
    """(query, key) pairs a head computes: query i at position
    q_offset + i sees keys below min(kv_len, q_offset + i + 1)."""
    if not causal:
        return int(sq) * int(kv_len)
    seen = np.minimum(np.arange(sq, dtype=np.int64) + q_offset + 1, kv_len)
    return int(np.clip(seen, 0, None).sum())


def attention_s(b: int, hq: int, hkv: int, sq: int, d: int, dv: int,
                kv_len: int, q_offset: int, causal: bool,
                elem_bytes: int = 2) -> float:
    """One forward: q, o and the visible keys and values once in their
    dtype; 2 (d + dv) operations a visible pair and head (bf16 peak)."""
    vis = min(int(kv_len), int(q_offset) + int(sq)) if causal \
        else int(kv_len)
    vis = max(vis, 0)
    nbytes = elem_bytes * (b * hq * sq * (d + dv) + b * hkv * vis * (d + dv))
    nops = 2 * b * hq * visible_pairs(sq, kv_len, q_offset, causal) * (d + dv)
    return bound_s(nbytes, nops, BF16_FLOPS)


def attention_flops(b: int, hq: int, sq: int, d: int, dv: int, kv_len: int,
                    q_offset: int, causal: bool) -> int:
    return 2 * b * hq * visible_pairs(sq, kv_len, q_offset, causal) * (d + dv)
