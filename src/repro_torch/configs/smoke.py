"""Reduced configs of the same family for CPU smoke tests.

Every reduction keeps the structural character of the arch (pattern,
GQA grouping, MoE routing, enc-dec, modality stubs) while shrinking
width/depth/vocab so one forward/train step runs on a single CPU device.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, ShapeConfig


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    period = len(cfg.pattern)
    # keep >= one full pattern period, at most two
    layers = period if cfg.num_layers % period == 0 else cfg.num_layers
    layers = min(layers, 2 * period) if cfg.num_layers % period == 0 \
        else min(cfg.num_layers, 4)
    heads = min(4, cfg.num_heads)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        window=8 if cfg.window else 0,
        d_rnn=128 if cfg.d_rnn else 0,
        n_experts=min(4, cfg.n_experts) if cfg.n_experts else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        num_img_tokens=8 if cfg.num_img_tokens else 0,
        max_position=128 if cfg.pos_kind == "learned" else 0,
        mlstm_chunk=8,
        remat=False,
    )


SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 2)
SMOKE_DECODE = ShapeConfig("smoke_decode", "decode", 32, 2)
