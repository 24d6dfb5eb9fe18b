"""Serving path: KV cache init, prefill, single-token decode (port of
repro.models.decode) for the attention kinds attn and local.

The cache keeps the reference's stacked layout: cache["p<j>"] holds, for
period position j, {"k", "v": [stack_count, B, W, n_kv, hd], "pos":
[stack_count, B, W] int32}, and cache["t<j>"] the unstacked tail layers.
Each layer reads and writes its slice of the stack (a view), so
`decode_step` updates the cache in place and returns it. The cache
defaults to bfloat16 whatever the parameter dtype, as in the reference.

Recurrent and cross-attention caches wait for ROADMAP Queue A 16a-ii.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import attention as attn_lib
from .layers import apply_norm, apply_rope, einsum, mlp
from .transformer import (_check_kind, apply_layer, check_supported,
                          embed_inputs, forward, logits_from_hidden)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    _check_kind(kind)
    slots = min(cfg.window, s_max) if kind == "local" else s_max
    return attn_lib.init_kv_cache(
        batch, attn_lib.KVCacheSpec(slots, cfg.num_kv_heads, cfg.head_dim),
        dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Empty caches for every layer (pos = -1 marks an empty slot);
    `device` None means the card."""
    check_supported(cfg)
    dev = resolve_device(device)
    cache: Dict[str, Any] = {}
    for j, kind in enumerate(cfg.stack_period):
        one = _layer_cache(cfg, kind, batch, s_max, dtype, dev)
        cache[f"p{j}"] = {
            k: v[None].repeat((cfg.stack_count,) + (1,) * v.dim())
            for k, v in one.items()}
    for j, kind in enumerate(cfg.tail_kinds):
        cache[f"t{j}"] = _layer_cache(cfg, kind, batch, s_max, dtype, dev)
    return cache


def _layer_slices(cfg: ModelConfig, cache):
    """(layer index, kind, that layer's cache dict of views), in order."""
    period = len(cfg.stack_period)
    for r in range(cfg.stack_count):
        for j, kind in enumerate(cfg.stack_period):
            yield r * period + j, kind, \
                {k: v[r] for k, v in cache[f"p{j}"].items()}
    for j, kind in enumerate(cfg.tail_kinds):
        yield cfg.stack_count * period + j, kind, cache[f"t{j}"]


def decode_layer(cfg: ModelConfig, kind: str, p, x, cache, pos: int):
    """x: [B,1,D] -> (x, cache), the layer's ring slot written in place."""
    _check_kind(kind)
    h = apply_norm(cfg.norm, p.norm1, x)
    core, cache = attn_lib.attention_decode(
        p.attn, h, cache, pos, theta=cfg.rope_theta,
        window=cfg.window if kind == "local" else None,
        attn_softcap=cfg.attn_softcap, use_rope=cfg.pos_kind == "rope",
        q_scale=cfg.q_scale)
    if cfg.post_norm:
        core = apply_norm(cfg.norm, p.norm1_post, core)
    x = x + core
    if p.norm2 is not None:
        h2 = apply_norm(cfg.norm, p.norm2, x)
        ff = mlp(p.mlp, h2, cfg.mlp_act)
        if cfg.post_norm:
            ff = apply_norm(cfg.norm, p.norm2_post, ff)
        x = x + ff
    return x, cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, token, pos,
                scan: Optional[bool] = None):
    """One decode step. token: [B,1] int, pos: one position for the batch.

    -> (logits [B,V], hidden [B,D] (the RAG query vector), cache). The
    cache is updated in place. `scan` is accepted and ignored (unrolled)."""
    pos = int(pos)
    x = params.embed.table[token.long()]
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.pos_kind == "learned":
        x = x + params.pos_emb.table[pos][None, None].to(x.dtype)
    for i, kind, layer_cache in _layer_slices(cfg, cache):
        x, _ = decode_layer(cfg, kind, params.layers[i], x, layer_cache, pos)
    x = apply_norm(cfg.norm, params.final_norm, x)
    logits = logits_from_hidden(cfg, params, x)
    return logits[:, 0, :], x[:, 0, :], cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, s_max: int,
            scan: Optional[bool] = None):
    """Run the full prompt: -> (last-position logits, hidden, primed
    cache). The prompt must be <= s_max."""
    logits, _, hidden, _ = forward(cfg, params, batch, scan=scan,
                                   remat=False)
    cache = fill_cache_from_forward(cfg, params, batch, s_max)
    return logits[:, -1, :], hidden[:, -1, :], cache


@torch.no_grad()
def fill_cache_from_forward(cfg: ModelConfig, params, batch, s_max: int):
    """Project K/V for every attention layer from the parallel forward's
    inputs and scatter them into ring caches (of the activation dtype, as
    in the reference)."""
    x, positions, enc_out, _ = embed_inputs(cfg, params, batch)
    cache = init_cache(cfg, x.shape[0], s_max, dtype=x.dtype,
                       device=x.device)
    for i, kind, layer_cache in _layer_slices(cfg, cache):
        p = params.layers[i]
        _fill_one(cfg, kind, p, layer_cache, x, positions, enc_out)
        x, _ = apply_layer(cfg, kind, p, x, positions, enc_out)
    return cache


def _write_ring(kv_cache, k, v, pos_vec, b: int, s: int):
    """Write the last min(s, W) positions' K/V into their ring slots, in
    place."""
    w = kv_cache["k"].shape[1]
    keep = min(s, w)
    slots = (pos_vec[-keep:] % w).long()
    kv_cache["k"][:, slots] = k[:, -keep:].to(kv_cache["k"].dtype)
    kv_cache["v"][:, slots] = v[:, -keep:].to(kv_cache["v"].dtype)
    kv_cache["pos"][:, slots] = pos_vec[None, -keep:].to(
        kv_cache["pos"].dtype).expand(b, keep)
    return kv_cache


def _fill_one(cfg: ModelConfig, kind: str, p, layer_cache, x, positions,
              enc_out):
    """Fill one layer's decode cache from the parallel-forward inputs."""
    _check_kind(kind)
    b, s, _ = x.shape
    h = apply_norm(cfg.norm, p.norm1, x)
    k = einsum("bsd,dhk->bshk", h, p.attn.wk)
    v = einsum("bsd,dhk->bshk", h, p.attn.wv)
    if p.attn.bk is not None:
        k, v = k + p.attn.bk, v + p.attn.bv
    if cfg.pos_kind == "rope":
        k = apply_rope(k, positions, cfg.rope_theta)
    return _write_ring(layer_cache, k, v, positions[0], b, s)
