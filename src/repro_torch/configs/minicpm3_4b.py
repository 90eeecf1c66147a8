"""minicpm3-4b [dense] 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, DeepSeek-V2-style compressed KV)
[hf:openbmb/MiniCPM3-4B; hf]"""
from ..models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10_000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
)
