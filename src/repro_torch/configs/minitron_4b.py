"""minitron-4b [dense] -- pruned nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) head_dim=128 d_ff=9216 vocab=256000,
squared-ReLU MLP (nemotron family), RMSNorm, untied.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        pattern=("attn",),
        mlp_act="relu2",
        norm="rmsnorm",
        rope_theta=10000.0,
        tie_embeddings=False,
    ),
    fsdp=True,
)
