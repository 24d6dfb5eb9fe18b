"""phi3.5-moe-42b-a6.6b [moe] -- 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=6400 vocab=32064,
MoE 16e top-2, SwiGLU experts, RMSNorm. 16 experts shard 1:1 over the
16-way model axis (expert parallelism).
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        pattern=("attn",),
        mlp_act="silu_glu",
        norm="rmsnorm",
        n_experts=16,
        top_k=2,
        rope_theta=10000.0,
        tie_embeddings=False,
    ),
    fsdp=True,
    shard_experts=True,
)
