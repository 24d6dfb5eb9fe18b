"""Attention: GQA + RoPE + local windows + softcap + ring KV cache (port
of repro.models.attention).

Plain PyTorch that mirrors the reference's formulas, including where it
rounds: scores are float32 (the products of the inputs summed in
float32), probabilities are cast to v's dtype before the product with v,
and the full-sequence path chunks queries (`ATTN_CHUNK`) and, for long
keys, runs the online softmax over `KV_CHUNK` keys. No fused library
attention: parity with the reference needs the same rounding points.

Decode caches are ring buffers: a cache of W slots holds the last W
(rotated) keys/values plus their absolute positions (-1 = empty); full
attention uses W = s_max, local attention W = window. The port writes the
ring slot in place (the reference returns an updated copy).

Cross-attention (whisper's decoder): `attention(..., kv_x=)` over the
encoder's output with no mask and no rotation; decode reads the encoder's
K/V precomputed once per prompt (`precompute_cross_kv`) from the layer's
cache (`xk`, `xv`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .layers import (InitCtx, Params, cache_device, einsum, einsum_f32,
                     rope_tables, rotate, softcap)
from .sharding import (attn_exact_mode, constrain_scores, sp_active,
                       splittable)

NEG_INF = -2.0e38

# Query-chunk size of the full-sequence path, and the KV-chunk size of its
# online softmax (the reference's constants).
ATTN_CHUNK = 512
KV_CHUNK = 2048


class Attention(Params):
    def __init__(self, ctx: InitCtx, dim: int, n_q: int, n_kv: int,
                 head_dim: int, bias: bool = False):
        super().__init__()
        self.wq = ctx.param((dim, n_q, head_dim),
                            ("embed", "heads", "head_dim"))
        self.wk = ctx.param((dim, n_kv, head_dim),
                            ("embed", "kv_heads", "head_dim"))
        self.wv = ctx.param((dim, n_kv, head_dim),
                            ("embed", "kv_heads", "head_dim"))
        self.wo = ctx.param((n_q, head_dim, dim),
                            ("heads", "head_dim", "embed"))
        if bias:
            self.bq = ctx.param((n_q, head_dim), ("heads", "head_dim"),
                                zeros=True)
            self.bk = ctx.param((n_kv, head_dim), ("kv_heads", "head_dim"),
                                zeros=True)
            self.bv = ctx.param((n_kv, head_dim), ("kv_heads", "head_dim"),
                                zeros=True)
            self.bo = ctx.param((dim,), ("embed",), zeros=True)
        else:
            self.bq = self.bk = self.bv = self.bo = None


def init_attention(ctx: InitCtx, dim: int, n_q: int, n_kv: int,
                   head_dim: int, bias: bool = False) -> Attention:
    return Attention(ctx, dim, n_q, n_kv, head_dim, bias=bias)


def _qkv(p, x):
    q = einsum("bsd,dhk->bshk", x, p.wq)
    k = einsum("bsd,dhk->bshk", x, p.wk)
    v = einsum("bsd,dhk->bshk", x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _expand_kv(x, hq: int):
    """[B,T,Hkv,hd] -> [B,T,Hq,hd] (GQA group broadcast)."""
    hkv = x.shape[2]
    if hkv == hq:
        return x
    return torch.repeat_interleave(x, hq // hkv, dim=2)


def _gqa_scores(q, k, scale, cap):
    """q: [B,S,Hq,hd], k: [B,T,Hkv,hd] -> [B,Hq,S,T] float32 scores,
    grouped (no materialised K expansion)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = splittable(q, 2, hkv).reshape(b, s, hkv, g, hd)
    scores = einsum_f32("bskgh,btkh->bkgst", qg, k) * scale
    scores = splittable(softcap(scores, cap), 2, 1).reshape(
        b, hq, s, k.shape[1])
    return constrain_scores(scores, kv_heads=hkv)


def _out_proj(p, ctx):
    out = einsum("bshk,hkd->bsd", ctx, p.wo)
    if p.bo is not None:
        out = out + p.bo
    return out


def _gqa_out(p, scores, v):
    """softmaxed scores [B,Hq,S,T], v [B,T,Hkv,hd] -> [B,S,D]."""
    b, hq, s, t = scores.shape
    hkv = v.shape[2]
    g = hq // hkv
    sg = splittable(scores, 1, hkv).reshape(b, hkv, g, s, t)
    ctx = einsum("bkgst,btkh->bskgh", sg.to(v.dtype), v)
    return _out_proj(p, splittable(ctx, 3, 1).reshape(b, s, hq,
                                                      v.shape[-1]))


def _attn_block(p, q, k, v, qpos, kpos, *, scale, cap, causal, window,
                is_cross=False):
    """One q-chunk: q [B,Sc,Hq,hd] vs full k/v [B,T,Hkv,hd] -> [B,Sc,D].
    T > KV_CHUNK (and a multiple of it) takes the online softmax over KV
    chunks (the flash-attention recurrence, exact up to rounding).
    Cross-attention (`is_cross`) masks nothing."""
    t = k.shape[1]
    hq = q.shape[2]
    kx = _expand_kv(k, hq)
    vx = _expand_kv(v, hq)

    def block_scores(k_blk, kp_blk):
        s = einsum_f32("bshk,bthk->bhst", q, k_blk) * scale
        s = softcap(s, cap)
        if is_cross:
            return s
        qp = qpos[:, None, :, None]
        kp = kp_blk[:, None, None, :]
        ok = torch.ones((1, 1) + s.shape[-2:], dtype=torch.bool,
                        device=s.device)
        if causal:
            ok = ok & (kp <= qp)
        if window:
            ok = ok & (qp - kp < window)
        return torch.where(ok, s, torch.full((), NEG_INF, device=s.device))

    if t <= KV_CHUNK or t % KV_CHUNK or attn_exact_mode():
        # one block: short keys, and the dry-run's cost probes
        probs = torch.softmax(constrain_scores(block_scores(kx, kpos)),
                              dim=-1)
        ctx = einsum("bhst,bthk->bshk", probs.to(vx.dtype), vx)
        return _out_proj(p, ctx)

    b, sc = q.shape[0], q.shape[1]
    hd_v = vx.shape[-1]
    m = torch.full((b, hq, sc), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sc, hq, hd_v), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, t, KV_CHUNK):
        v_blk = vx[:, c0:c0 + KV_CHUNK]
        s = block_scores(kx[:, c0:c0 + KV_CHUNK], kpos[:, c0:c0 + KV_CHUNK])
        m_new = torch.maximum(m, torch.clamp(s.amax(dim=-1), min=-1e30))
        r = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * r + pexp.sum(dim=-1)
        blk = einsum("bhst,bthk->bshk", pexp.to(v_blk.dtype),
                           v_blk).float()
        acc = acc * r.transpose(1, 2)[..., None] + blk
        m = m_new
    ctx = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return _out_proj(p, ctx.to(vx.dtype))


def attention(p, x, positions, *, theta: float = 1e4, causal: bool = True,
              window: Optional[int] = None, attn_softcap: float = 0.0,
              use_rope: bool = True, kv_x: Optional[torch.Tensor] = None,
              q_scale: Optional[float] = None,
              chunk: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (prefill). x: [B,S,D]; with `kv_x`
    [B,T,D] (the encoder's output) cross-attention: q from x, k/v from
    kv_x, unrotated and unmasked."""
    if kv_x is None:
        q, k, v = _qkv(p, x)
        kv_pos = positions
    else:
        q = einsum("bsd,dhk->bshk", x, p.wq)
        k, v = precompute_cross_kv(p, kv_x)
        if p.bq is not None:
            q = q + p.bq
        kv_pos = torch.arange(kv_x.shape[1], dtype=torch.int32,
                              device=x.device)[None].expand(kv_x.shape[:2])
    if use_rope and kv_x is None:
        cos, sin = rope_tables(positions, q.shape[-1], theta)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    hd = q.shape[-1]
    scale = q_scale if q_scale is not None else hd ** -0.5
    b, s = q.shape[:2]
    chunk = chunk or ATTN_CHUNK
    kw = dict(scale=scale, cap=attn_softcap, causal=causal, window=window,
              is_cross=kv_x is not None)
    if s <= chunk or s % chunk or sp_active(s):
        # whisper's 1,500 frames take this unchunked branch; under
        # sequence parallelism the scores' S dim is already sharded
        return _attn_block(p, q, k, v, positions, kv_pos, **kw)
    out = torch.zeros((b, s, p.wo.shape[-1]), dtype=x.dtype, device=x.device)
    for c0 in range(0, s, chunk):
        piece = _attn_block(p, q[:, c0:c0 + chunk], k, v,
                            positions[:, c0:c0 + chunk], kv_pos, **kw)
        out[:, c0:c0 + chunk] = piece.to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Decode with ring-buffer KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCacheSpec:
    slots: int          # W: S_max for full attention, window for local
    n_kv: int
    head_dim: int


def init_kv_cache(batch: int, spec: KVCacheSpec, dtype=torch.bfloat16,
                  device=None) -> dict:
    """An empty ring cache on `device` (None means the card; "meta"
    allocates nothing)."""
    device = cache_device(device)
    shape = (batch, spec.slots, spec.n_kv, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # -1 = empty slot
        "pos": torch.full((batch, spec.slots), -1, dtype=torch.int32,
                          device=device),
    }


def attention_decode(p, x, cache, pos: int, *, theta: float = 1e4,
                     window: Optional[int] = None, attn_softcap: float = 0.0,
                     use_rope: bool = True, q_scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: [B,1,D]; pos: one position shared by the batch.

    Writes ring slot pos % W of `cache` in place and returns (out, cache).
    Keys are stored rotated at their absolute position; RoPE's relative
    property makes q.k correct without re-rotation at read time."""
    pos = int(pos)
    b = x.shape[0]
    w = cache["k"].shape[1]
    q, k, v = _qkv(p, x)
    if use_rope:
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_tables(posb, q.shape[-1], theta)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    slot = pos % w
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[:, slot] = pos

    hd = q.shape[-1]
    scale = q_scale if q_scale is not None else hd ** -0.5
    scores = _gqa_scores(q, ck, scale, attn_softcap)       # [B,Hq,1,W]
    kp = cpos[:, None, None, :]
    ok = (kp >= 0) & (kp <= pos)
    if window:
        ok = ok & (pos - kp < window)
    scores = torch.where(ok, scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(p, probs, cv), cache


def init_cross_cache(enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Whisper's decoder: the precomputed encoder K/V act as a static
    cache."""
    return {"k": enc_kv[0], "v": enc_kv[1]}


def cross_attention_decode(p, x, cross_cache, q_scale=None):
    """x [B,1,D] attends to every encoder position of cross_cache's k/v
    [B,T,Hkv,hd] (no mask, no rotation)."""
    q = einsum("bsd,dhk->bshk", x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    k, v = cross_cache["k"], cross_cache["v"]
    scale = q_scale if q_scale is not None else q.shape[-1] ** -0.5
    probs = torch.softmax(_gqa_scores(q, k, scale, 0.0), dim=-1)
    return _gqa_out(p, probs, v)


def precompute_cross_kv(p, enc_out):
    """The encoder output's K/V [B,T,Hkv,hd] for a cross-attention layer."""
    k = einsum("bsd,dhk->bshk", enc_out, p.wk)
    v = einsum("bsd,dhk->bshk", enc_out, p.wv)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return k, v
