"""qwen2-vl-72b [vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE (3-axis rotary), dynamic resolution; the vision
frontend is a STUB (input_specs() provides precomputed, merged patch/text
embeddings plus 3-axis position ids).  [arXiv:2409.12191; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    m_rope=True, mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, frontend="embeds",
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
    mrope_sections=(2, 3, 3),
)
