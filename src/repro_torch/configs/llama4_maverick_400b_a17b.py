"""llama4-maverick-400b-a17b [moe] 48L d_model=5120 40H (GQA kv=8)
vocab=202048, MoE 128 experts top-1 + 1 shared expert, MoE every other
layer (dense interleave d_ff = 2 x expert d_ff = 16384); the multimodal
early-fusion frontend is out of scope for the LM shapes (text backbone
per the assignment).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, n_shared=1,
                  every_k_layers=2, capacity_factor=1.25),
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256, dtype="float32", remat=False,
    moe=MoEConfig(n_experts=8, top_k=1, d_expert=32, n_shared=1,
                  every_k_layers=2, capacity_factor=8.0),  # dropless smoke
)
