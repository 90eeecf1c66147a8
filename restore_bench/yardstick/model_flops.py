"""Model FLOPs of a dense MLA decoder (frozen formula for ``serve_mfu``):
2 operations a weight of every matrix product a token passes through,
the output head once a call (the port's prefill returns the last
position's logits only), and attention's 2 (d_qk + d_v) a visible
(query, key) pair and head from the recorded calls."""
from __future__ import annotations

from typing import Dict


def layer_matmul_params(c: Dict) -> int:
    d, h, ff = c["hidden_size"], c["num_attention_heads"], \
        c["intermediate_size"]
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    return (d * qr + qr * h * (nope + rope) + d * (kvr + rope)
            + kvr * h * nope + kvr * h * vd + h * vd * d + 3 * d * ff)


def token_flops(c: Dict) -> int:
    """Matrix-product FLOPs of one token through every layer."""
    return 2 * c["num_hidden_layers"] * layer_matmul_params(c)


def head_flops(c: Dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]
