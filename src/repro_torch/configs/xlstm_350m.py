"""xlstm-350m [ssm] -- sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (blocks carry their own projections)
vocab=50304. Pattern mLSTM:sLSTM = 7:1 (xLSTM[7:1]); mLSTM uses the
chunkwise-parallel linear-time form, giving O(1)-in-seq decode state ->
runs long_500k.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        pattern=("mlstm",) * 7 + ("slstm",),
        mlstm_proj_factor=2.0,
        mlstm_chunk=256,
        norm="layernorm",
        tie_embeddings=True,
    ),
)
