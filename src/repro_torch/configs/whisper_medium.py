"""whisper-medium [audio] -- encoder-decoder, conv frontend STUB
[arXiv:2212.04356; unverified].

24 decoder layers (+24 encoder), d_model=1024 16H (kv=16) head_dim=64
d_ff=4096 vocab=51865, LayerNorm + biases, GELU MLP, learned positions.
The conv/mel frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings [B, 1500, d_model]. Decoder
learned-position table is extended to the assigned decode shapes
(32768 >> whisper's native 448) so decode_32k is well-defined.
"""
from .base import ModelConfig
from .registry import ArchSpec

ARCH = ArchSpec(
    config=ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        pattern=("xattn",),
        mlp_act="gelu",
        norm="layernorm",
        attn_bias=True,
        pos_kind="learned",
        max_position=32768,
        encoder_layers=24,
        enc_seq=1500,
        tie_embeddings=True,
    ),
)
