"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window=2048,
d_rnn=2560 (lru_width), GeGLU MLP, RMSNorm, tied + scaled embeddings.
Sub-quadratic (local attn windows + O(1) RNN state) -> runs long_500k.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        pattern=("rglru", "rglru", "local"),
        window=2048,
        d_rnn=2560,
        conv_width=4,
        mlp_act="gelu_glu",
        norm="rmsnorm",
        rope_theta=10000.0,
        tie_embeddings=True,
        emb_scale=True,
    ),
)
