"""grok-1-314b [moe] -- 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=32768 vocab=131072,
MoE 8e top-2, attention logit cap 30 (tanh), tied embeddings.
E=8 < 16-way model axis -> experts replicate, "ff" shards inside each
expert (TP); params+optimizer shard over data AND pod (ZeRO-3 analogue)
so 314B fits 512 x 16 GB HBM.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        pattern=("attn",),
        mlp_act="gelu_glu",
        norm="rmsnorm",
        n_experts=8,
        top_k=2,
        attn_softcap=30.0,
        logit_softcap=30.0,
        rope_theta=10000.0,
        tie_embeddings=True,
        emb_scale=True,
    ),
    fsdp=True,
    fsdp_over_pod=True,
    shard_experts=False,
)
