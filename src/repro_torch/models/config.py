"""Model configuration system covering all assigned architecture families:
dense GQA transformers (w/ qk-norm, biases), MLA, MoE, encoder-decoder,
xLSTM, M-RoPE VLM backbones, and Mamba/attention hybrids.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 style, MiniCPM3 dims)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0            # expert FFN hidden size
    n_shared: int = 0            # shared (always-on) experts
    every_k_layers: int = 1      # MoE on layers where (i % k == k-1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 => ceil(d_model / 16)
    chunk: int = 256             # chunked-scan length (0 => full sequence)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # 1 sLSTM per 8 blocks (xLSTM[7:1])
    proj_factor: float = 2.0     # mLSTM pre-up-projection factor
    chunk_size: int = 256        # chunkwise-parallel training form


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention options
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 1_000_000.0
    mla: Optional[MLAConfig] = None
    m_rope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # hybrid (Jamba): one attention layer per `attn_every`, rest Mamba
    attn_every: int = 0          # 0 => pure attention stack
    ssm: Optional[SSMConfig] = None
    # xLSTM
    xlstm: Optional[XLSTMConfig] = None
    # encoder-decoder
    n_encoder_layers: int = 0    # >0 => enc-dec; n_layers is decoder depth
    # frontend stubs: "none" (token ids), "embeds" (precomputed embeddings)
    frontend: str = "none"
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # distribution hints
    scan_layers: bool = True     # lax.scan over (homogeneous groups of) layers
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec incl.)

    def moe_on_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        k = self.moe.every_k_layers
        return i % k == k - 1

    def attn_on_layer(self, i: int) -> bool:
        if self.attn_every <= 0:
            return True
        return i % self.attn_every == self.attn_every - 1

    def active_params(self) -> int:
        """6*N*D model-FLOPs numerator: active (per-token) parameter count."""
        return _count_params(self, active_only=True)

    def total_params(self) -> int:
        return _count_params(self, active_only=False)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        n = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk_head
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        n += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                             + m.v_head_dim)
        n += cfg.n_heads * m.v_head_dim * d
        return n
    return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff     # SwiGLU: gate, up, down


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    n = cfg.d_model * 2 * d_inner            # in_proj
    n += d_inner * s.d_conv                  # conv
    n += d_inner * (dt_rank + 2 * s.d_state)  # x_proj
    n += dt_rank * d_inner + d_inner         # dt_proj
    n += d_inner * s.d_state + d_inner       # A_log, D
    n += d_inner * cfg.d_model               # out_proj
    return n


def _xlstm_params(cfg: ModelConfig) -> int:
    x = cfg.xlstm or XLSTMConfig()
    d = cfg.d_model
    d_in = int(x.proj_factor * d)
    m = 2 * d * d_in + 3 * d_in * d_in // cfg.n_heads + d_in * d  # rough
    s = 4 * d * d + 4 * d * d // cfg.n_heads + 3 * d * d          # sLSTM+FFN
    n_s = cfg.n_layers // (x.slstm_every or cfg.n_layers)
    return m * (cfg.n_layers - n_s) + s * n_s


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        return n + _xlstm_params(cfg)

    def layer_params(i: int, active: bool) -> int:
        p = 0
        if cfg.attn_on_layer(i):
            p += _attn_params(cfg)
        else:
            p += _ssm_params(cfg)
        if cfg.moe_on_layer(i):
            m = cfg.moe
            e = (m.top_k + m.n_shared) if active else (m.n_experts
                                                       + m.n_shared)
            p += e * _ffn_params(cfg, m.d_expert) + d * m.n_experts
        else:
            p += _ffn_params(cfg, cfg.d_ff)
        p += 2 * d                      # norms
        return p

    total_layers = cfg.n_layers + cfg.n_encoder_layers
    for i in range(cfg.n_layers):
        n += layer_params(i, active_only)
    for i in range(cfg.n_encoder_layers):
        n += layer_params(i, active_only) + (_attn_params(cfg) + d
                                             if False else 0)
    if cfg.n_encoder_layers:
        # decoder cross-attention
        n += cfg.n_layers * _attn_params(cfg)
    return n
