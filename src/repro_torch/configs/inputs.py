"""input_specs(): shape-and-dtype stand-ins for every model input (port
of repro.configs.inputs).

A stand-in is a tensor on the "meta" device: a shape and a dtype, no
memory. Modality frontends are stubs, as in the reference: [vlm] gets
precomputed patch embeddings, [audio] precomputed frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .base import ModelConfig, ShapeConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Inputs of a full-sequence forward (train / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.num_img_tokens:
        out["tokens"] = _spec((b, s - cfg.num_img_tokens), torch.int32)
        out["img"] = _spec((b, cfg.num_img_tokens, cfg.d_model),
                           torch.bfloat16)
    else:
        out["tokens"] = _spec((b, s), torch.int32)
    if cfg.encoder_layers:
        out["frames"] = _spec((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Inputs of one decode step: token + position + a seq_len-sized
    cache (init_cache on "meta")."""
    from ..models import decode as decode_lib
    b, s = shape.global_batch, shape.seq_len
    return {"token": _spec((b, 1), torch.int32),
            "pos": _spec((), torch.int32),
            "cache": decode_lib.init_cache(cfg, b, s, device="meta")}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return batch_specs(cfg, shape)


def materialize(specs: Dict[str, Any], seed: int = 0,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Small real tensors on `device` (None means the card) in place of the
    stand-ins, by the reference's rules: int32 of rank 1-2 uniform in
    [0, 64), other int32 and scalars zero, floats normal x 0.1. The
    numbers come from a torch.Generator seeded with `seed`, one draw a
    leaf in the reference's tree order: they are not the reference's `jax.random` values
    (parity tests build their inputs with numpy)."""
    from ..core.types import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def mk(s: torch.Tensor) -> torch.Tensor:
        if s.dtype == torch.int32 and 1 <= s.dim() <= 2:
            return torch.randint(0, 64, s.shape, generator=gen, device=dev,
                                 dtype=torch.int32)
        if s.dtype == torch.int32 or s.dim() == 0:
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        return (torch.randn(s.shape, generator=gen, device=dev)
                * 0.1).to(s.dtype)

    def walk(t):
        if isinstance(t, dict):      # sorted keys: jax.tree's leaf order
            return {k: walk(t[k]) for k in sorted(t)}
        return mk(t)
    return walk(specs)
