"""starcoder2-15b [dense] -- GQA + RoPE code model [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, LayerNorm,
biased projections, plain-GELU MLP, rope_theta=1e5.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        pattern=("attn",),
        mlp_act="gelu",
        norm="layernorm",
        attn_bias=True,
        rope_theta=100000.0,
        tie_embeddings=False,
    ),
    fsdp=True,
)
