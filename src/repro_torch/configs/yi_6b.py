"""yi-6b [dense] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA  [arXiv:2403.04652; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
