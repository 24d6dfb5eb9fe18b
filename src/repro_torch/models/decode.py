"""Serving path: cache init, prefill, single-token decode (port of
repro.models.decode) for every layer kind.

The cache keeps the reference's stacked layout: cache["p<j>"] holds, for
period position j, its entries with a leading stack_count axis, and
cache["t<j>"] the unstacked tail layers. Per layer kind:
  attn   -> ring KV cache {"k", "v": [B, W, n_kv, hd], "pos": [B, W]},
            W = s_max
  local  -> the same, W = min(window, s_max)
  xattn  -> the ring + the encoder's K/V {"xk", "xv": [B, enc_seq, n_kv,
            hd]}, written by prefill and only read by decode
  rglru  -> {"h": [B, d_rnn], "conv": [B, conv_width - 1, d_rnn]}
  mlstm  -> {"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}
  slstm  -> {"c", "n", "m": [B, D], "h": [B, H, hd]} (the reference's
            tuple (c, n, h, m))
Ring and encoder entries take the cache dtype (bfloat16 by default,
whatever the parameters'), recurrent state is float32, as in the
reference. Each layer reads and writes its slice of the stack (a view),
so `decode_step` updates the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import recurrent as rec_lib
from . import xlstm as xlstm_lib
from .layers import apply_norm, apply_rope, cache_device, einsum
from .transformer import (apply_layer, embed_inputs, feed_forward, forward,
                          logits_from_hidden)

# the ring entries of an attention layer's cache
RING_KEYS = ("k", "v", "pos")


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    if kind in ("attn", "local", "xattn"):
        slots = min(cfg.window, s_max) if kind == "local" else s_max
        c = attn_lib.init_kv_cache(
            batch, attn_lib.KVCacheSpec(slots, cfg.num_kv_heads,
                                        cfg.head_dim),
            dtype=dtype, device=device)
        if kind == "xattn":
            shape = (batch, cfg.enc_seq, cfg.num_kv_heads, cfg.head_dim)
            c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
            c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
        return c
    if kind == "rglru":
        return rec_lib.init_rglru_state(batch, cfg.d_rnn or cfg.d_model,
                                        cfg.conv_width, device=device)
    if kind == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg.d_model, cfg.num_heads,
                                          cfg.mlstm_proj_factor,
                                          device=device)
    if kind == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg.d_model, cfg.num_heads,
                                          device=device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Empty caches for every layer (pos = -1 marks an empty ring slot,
    recurrent state is zero); `device` None means the card, "meta"
    gives shapes and dtypes only."""
    dev = cache_device(device)
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


def _write_state(cache, state):
    for key, t in state.items():
        cache[key].copy_(t)


def decode_layer(cfg: ModelConfig, kind: str, p, x, cache, pos: int):
    """x: [B,1,D] -> (x, cache), the layer's ring slot or recurrent state
    written in place."""
    h = apply_norm(cfg.norm, p.norm1, x)
    if kind in ("attn", "local", "xattn"):
        core, _ = attn_lib.attention_decode(
            p.attn, h, {k: cache[k] for k in RING_KEYS}, pos,
            theta=cfg.rope_theta,
            window=cfg.window if kind == "local" else None,
            attn_softcap=cfg.attn_softcap, use_rope=cfg.pos_kind == "rope",
            q_scale=cfg.q_scale)
    else:
        if kind == "rglru":
            core, state = rec_lib.rglru_decode(p.rnn, h, cache)
        elif kind == "mlstm":
            core, state = xlstm_lib.mlstm_decode(p.cell, h, cache)
        else:
            core, state = xlstm_lib.slstm_decode(p.cell, h, cache,
                                                 cfg.num_heads)
        _write_state(cache, state)
    if cfg.post_norm:
        core = apply_norm(cfg.norm, p.norm1_post, core)
    x = x + core
    if kind == "xattn":
        hx = apply_norm(cfg.norm, p.normx, x)
        x = x + attn_lib.cross_attention_decode(
            p.cross, hx, attn_lib.init_cross_cache((cache["xk"],
                                                    cache["xv"])))
    return feed_forward(cfg, p, x)[0], cache


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
    """Every layer's decode cache from the parallel forward's inputs: K/V
    projected and scattered into ring caches (of the activation dtype, as
    in the reference), the encoder's K/V for cross-attention, recurrent
    final states from their parallel forms."""
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
    """Fill one layer's decode cache, in place, from the parallel-forward
    inputs."""
    b, s, _ = x.shape
    h = apply_norm(cfg.norm, p.norm1, x)
    if kind == "rglru":
        _write_state(layer_cache, rec_lib.rglru_final_state(p.rnn, h))
    elif kind == "mlstm":
        _write_state(layer_cache, xlstm_lib.mlstm_final_state(p.cell, h))
    elif kind == "slstm":
        _write_state(layer_cache, xlstm_lib.slstm_final_state(
            p.cell, h, cfg.num_heads))
    else:
        k = einsum("bsd,dhk->bshk", h, p.attn.wk)
        v = einsum("bsd,dhk->bshk", h, p.attn.wv)
        if p.attn.bk is not None:
            k, v = k + p.attn.bk, v + p.attn.bv
        if cfg.pos_kind == "rope":
            k = apply_rope(k, positions, cfg.rope_theta)
        _write_ring(layer_cache, k, v, positions[0], b, s)
        if kind == "xattn":
            xk, xv = attn_lib.precompute_cross_kv(p.cross, enc_out)
            layer_cache["xk"].copy_(xk)
            layer_cache["xv"].copy_(xv)
    return layer_cache
