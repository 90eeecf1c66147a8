"""jamba-1.5-large-398b [hybrid] 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2 every other layer, Mamba+attention 1:7
interleave (one attention layer per 8).  [arXiv:2403.19887; hf]"""
from ..models.config import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    attn_every=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576,
                  every_k_layers=2, capacity_factor=1.25),
    rope_theta=10_000.0,
)

SMOKE = CONFIG.with_(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
    attn_every=4,
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, every_k_layers=2,
                  capacity_factor=4.0),  # dropless smoke
)
