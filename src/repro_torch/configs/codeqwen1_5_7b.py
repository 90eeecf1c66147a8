"""codeqwen1.5-7b [dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5 arch (QKV biases)  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    attn_bias=True, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
