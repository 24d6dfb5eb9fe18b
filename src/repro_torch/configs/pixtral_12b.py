"""pixtral-12b [vlm] -- pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072.
The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, 1024, d_model] prepended to the token
sequence (1D RoPE over the concatenated sequence -- a documented
simplification of pixtral's 2D rope).
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=("attn",),
        mlp_act="silu_glu",
        norm="rmsnorm",
        rope_theta=1000000.0,
        num_img_tokens=1024,
        tie_embeddings=False,
    ),
    fsdp=True,
)
