"""xlstm-350m [ssm] 24 blocks d_model=1024 4H vocab=50304 — sLSTM + mLSTM
blocks (xLSTM[7:1]: one sLSTM per 8 blocks), d_ff=0 (mLSTM blocks are
pre-up-projection and carry their own FFN-equivalent projections).
[arXiv:2405.04517; unverified]"""
from ..models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk_size=256),
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab_size=256, dtype="float32", remat=False,
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0, chunk_size=32),
)
