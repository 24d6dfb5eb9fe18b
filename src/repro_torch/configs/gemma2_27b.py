"""gemma2-27b [dense] -- local/global alternating attention + logit
softcaps [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) head_dim=128 d_ff=36864 vocab=256000,
window=4096 on local layers, attn softcap 50, final logit softcap 30,
pre+post RMSNorm, GeGLU, q_scale=(4608/32)^-0.5, tied+scaled embeddings.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        pattern=("local", "attn"),
        window=4096,
        mlp_act="gelu_glu",
        norm="rmsnorm",
        post_norm=True,
        attn_softcap=50.0,
        logit_softcap=30.0,
        q_scale=(4608 / 32) ** -0.5,
        rope_theta=10000.0,
        tie_embeddings=True,
        emb_scale=True,
    ),
    fsdp=True,
)
