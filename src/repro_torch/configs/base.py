"""Architecture + shape configuration schema (a copy of
repro.configs.base: pure Python).

Every assigned architecture is an instance of `ModelConfig`; the four
assigned input shapes are `ShapeConfig`s. Configs are frozen/hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # Per-layer block kinds, cycled: attn | local | rglru | mlstm | slstm.
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                # local attention window
    rope_theta: float = 10000.0
    pos_kind: str = "rope"         # rope | learned
    max_position: int = 0          # learned positions table size
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp_act: str = "silu_glu"      # silu_glu | gelu_glu | gelu
    post_norm: bool = False        # gemma2-style extra post-norms
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    attn_bias: bool = False
    q_scale: Optional[float] = None  # gemma2 query_pre_attn_scalar^-0.5
    tie_embeddings: bool = False
    emb_scale: bool = False        # multiply embeddings by sqrt(d_model)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # recurrent / ssm
    d_rnn: int = 0
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    mlstm_chunk: int = 256
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    enc_seq: int = 0               # stub frontend: precomputed frames
    # vlm (pixtral): stub frontend provides patch embeddings
    num_img_tokens: int = 0
    # runtime
    scan_layers: bool = False
    remat: bool = True
    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    @property
    def stack_period(self) -> Tuple[str, ...]:
        """Kinds of one stacked period; stack count = L // len(period).
        Layers beyond count*period form the unrolled `tail` (e.g.
        recurrentgemma's 26 = 8 x (rglru, rglru, local) + (rglru, rglru))."""
        return self.pattern

    @property
    def stack_count(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        return self.layer_kinds()[self.stack_count * len(self.pattern):]

    @property
    def supports_long_context(self) -> bool:
        """True iff no layer needs a full-sequence KV cache (sub-quadratic)."""
        return all(k != "attn" for k in self.layer_kinds()) \
            and self.encoder_layers == 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += v * d
        if self.pos_kind == "learned":
            n += self.max_position * d
        attn = d * self.num_heads * self.head_dim \
            + 2 * d * self.num_kv_heads * self.head_dim \
            + self.num_heads * self.head_dim * d
        glu = 3 if self.mlp_act.endswith("_glu") else 2
        mlp = glu * d * f
        moe_ = self.n_experts * glu * d * f + d * self.n_experts
        d_rnn = self.d_rnn or d
        rglru = 2 * d * d_rnn + 2 * d_rnn * d_rnn + d_rnn * d \
            + self.conv_width * d_rnn
        di = int(d * self.mlstm_proj_factor)
        mlstm = 2 * d * di + 3 * di * di // max(1, self.num_heads) * \
            self.num_heads + di * d   # approx: q,k,v are di x hd x H = di*di
        mlstm = 2 * d * di + 3 * di * (di // max(1, self.num_heads)) * \
            self.num_heads + di * d
        hd = d // max(1, self.num_heads)
        slstm = 4 * (d * d + self.num_heads * hd * hd) \
            + 3 * d * int(d * 4 / 3)
        for kind in self.layer_kinds():
            if kind in ("attn", "local"):
                n += attn + (moe_ if self.n_experts else mlp)
            elif kind == "rglru":
                n += rglru + mlp
            elif kind == "mlstm":
                n += mlstm
            elif kind == "slstm":
                n += slstm
        if self.encoder_layers:
            n += self.encoder_layers * (attn + mlp) + self.enc_seq * d
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        glu = 3 if self.mlp_act.endswith("_glu") else 2
        dense_share = self.param_count() - \
            self.num_layers * (self.n_experts * glu * d * f)
        return int(dense_share + self.num_layers * self.top_k * glu * d * f)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rules from the assignment (recorded in EXPERIMENTS.md)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full attention layers: O(S) KV cache at 500k infeasible"
    return True, ""
