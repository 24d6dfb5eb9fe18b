"""Model assembly for the attention-only dense family (port of
repro.models.transformer).

Layer kinds here: attn | local (sliding window), each with a dense MLP and
gemma2's optional post-norms. `Transformer` holds one `Layer` per model
layer in an `nn.ModuleList`, in layer order: layer r * len(pattern) + j is
the reference's `params["stack"]["p<j>"]` at index r, and the layers after
stack_count * len(pattern) are its `params["tail"]["t<j>"]`.

Not here yet (ROADMAP Queue A 16a-ii): the kinds rglru, mlstm, slstm and
xattn, mixture-of-experts MLPs and the whisper encoder. Building or
running a config that needs one raises NotImplementedError by name.
`loss_fn` waits for the training half (16b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import attention as attn_lib
from .layers import (InitCtx, Table, apply_norm, init_embed, init_mlp,
                     init_norm, init_unembed, mlp, promote, softcap,
                     unembed_logits)

SUPPORTED_KINDS = ("attn", "local")
_LATER = "ROADMAP Queue A 16a-ii"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming what this slice does not carry."""
    for kind in cfg.layer_kinds():
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"layer kind {kind!r} of {cfg.name} is not ported yet "
                f"({_LATER})")
    if cfg.n_experts:
        raise NotImplementedError(
            f"MoE MLP (n_experts={cfg.n_experts}) of {cfg.name} is not "
            f"ported yet ({_LATER})")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"encoder (encoder_layers={cfg.encoder_layers}) of {cfg.name} "
            f"is not ported yet ({_LATER})")


def _check_kind(kind: str) -> None:
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet ({_LATER})")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer: norm1 -> attention (-> norm1_post) -> residual,
    norm2 -> MLP (-> norm2_post) -> residual."""

    def __init__(self, ctx: InitCtx, cfg: ModelConfig, kind: str):
        super().__init__()
        _check_kind(kind)
        if cfg.n_experts:
            check_supported(cfg)
        d = cfg.d_model
        self.kind = kind
        self.norm1 = init_norm(ctx, cfg.norm, d)
        self.attn = attn_lib.init_attention(
            ctx, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            bias=cfg.attn_bias)
        if cfg.d_ff > 0:
            self.norm2 = init_norm(ctx, cfg.norm, d)
            self.mlp = init_mlp(ctx, d, cfg.d_ff, cfg.mlp_act,
                                bias=cfg.attn_bias)
        else:
            self.norm2 = self.mlp = None
        if cfg.post_norm:
            self.norm1_post = init_norm(ctx, cfg.norm, d)
            self.norm2_post = init_norm(ctx, cfg.norm, d) \
                if cfg.d_ff > 0 else None
        else:
            self.norm1_post = self.norm2_post = None


def init_layer(ctx: InitCtx, cfg: ModelConfig, kind: str) -> Layer:
    return Layer(ctx, cfg, kind)


class Transformer(nn.Module):
    """Parameters of one model, with the reference's leaf names: embed,
    final_norm, unembed (untied), pos_emb (learned positions), layers."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = init_embed(ctx, cfg.vocab_size, cfg.d_model)
        self.final_norm = init_norm(ctx, cfg.norm, cfg.d_model)
        self.unembed = None if cfg.tie_embeddings \
            else init_unembed(ctx, cfg.vocab_size, cfg.d_model)
        self.pos_emb = None
        if cfg.pos_kind == "learned":
            self.pos_emb = Table(ctx, cfg.max_position, cfg.d_model,
                                 scale=0.02)
        self.layers = nn.ModuleList(
            init_layer(ctx, cfg, kind) for kind in cfg.layer_kinds())


def init_model(cfg: ModelConfig,
               key: Union[None, int, torch.Generator] = None,
               abstract: bool = False, device=None) -> Transformer:
    """-> the model's parameters, drawn from `key` (a torch.Generator on
    `device`, or a seed; None means seed 0) one tensor at a time on
    `device` (None means the card). abstract=True places them on the
    "meta" device: shapes and dtypes, no memory."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if abstract:
        return Transformer(cfg, InitCtx(None, dtype, abstract=True))
    dev = resolve_device(device)
    if not isinstance(key, torch.Generator):
        key = torch.Generator(device=dev).manual_seed(int(key or 0))
    with torch.no_grad():
        return Transformer(cfg, InitCtx(key, dtype, dev))


# ---------------------------------------------------------------------------
# Full-sequence layer application (prefill)
# ---------------------------------------------------------------------------

def apply_layer(cfg: ModelConfig, kind: str, p, x, positions,
                enc_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, aux). x: [B, S, D]."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg.norm, p.norm1, x)
    core = attn_lib.attention(
        p.attn, h, positions, theta=cfg.rope_theta, causal=True,
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
    return x, aux


def _run_stack(cfg: ModelConfig, params, x, positions, enc_out=None,
               scan: Optional[bool] = None, remat: Optional[bool] = None):
    """Every layer in order, unrolled. `scan` and `remat` are the
    reference's compile and training switches; eager inference has no
    counterpart, so they are accepted and ignored."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        x, a = apply_layer(cfg, layer.kind, layer, x, positions, enc_out)
        aux = aux + a
    return x, aux


def embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """-> (x [B,S,D], positions [B,S], enc_out (None), text_offset)."""
    x = params.embed.table[batch["tokens"].long()]
    if cfg.emb_scale:
        # the sqrt(d) constant is rounded to the activation dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    offset = 0
    if cfg.num_img_tokens and "img" in batch:
        img = batch["img"].to(x.dtype)
        x = torch.cat([img, x], dim=1)
        offset = img.shape[1]
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(x.shape[0], s)
    if cfg.pos_kind == "learned":
        x = x + params.pos_emb.table[None, :s].to(x.dtype)
    return x, positions, None, offset


def logits_from_hidden(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = unembed_logits(params.embed, h)
    else:
        logits = torch.matmul(*promote(h, params.unembed.w))
    return softcap(logits, cfg.logit_softcap)


@torch.no_grad()
def forward(cfg: ModelConfig, params, batch, scan: Optional[bool] = None,
            remat: Optional[bool] = None, last_logits_only: bool = False):
    """Full-sequence forward -> (logits, aux, hidden [B,S,D], offset).

    last_logits_only=True computes the unembedding for the final position
    only."""
    x, positions, enc_out, offset = embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x, positions, enc_out, scan=scan,
                        remat=remat)
    x = apply_norm(cfg.norm, params.final_norm, x)
    h = x[:, -1:, :] if last_logits_only else x
    return logits_from_hidden(cfg, params, h), aux, x, offset
