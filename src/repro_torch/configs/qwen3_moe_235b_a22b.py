"""qwen3-moe-235b-a22b [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8, qk_norm  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                  every_k_layers=1, capacity_factor=1.25),
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, dtype="float32", remat=False,
    # capacity_factor >= n_experts makes the smoke config dropless, so
    # prefill+decode is bit-consistent with the full forward
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, every_k_layers=1,
                  capacity_factor=8.0),
)
