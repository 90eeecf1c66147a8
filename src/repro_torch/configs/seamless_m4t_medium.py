"""seamless-m4t-medium [audio] 12L encoder + 12L decoder, d_model=1024
16H d_ff=4096 vocab=256206 — enc-dec; speech frontend is a STUB
(input_specs() provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    rope_theta=10_000.0, frontend="embeds",
)

SMOKE = CONFIG.with_(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
