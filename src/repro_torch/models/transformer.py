"""Model assembly: one composable stack covering all ten registered
architectures (port of repro.models.transformer).

Layer kinds (cfg.pattern): attn | local | rglru | mlstm | slstm | xattn
(xattn = a decoder layer with cross-attention to whisper's encoder).
attn, local, xattn and rglru layers carry a dense MLP or, with
n_experts, a mixture of experts; gemma2's post-norms are optional.
`Transformer` holds one `Layer` per model layer in an `nn.ModuleList`, in
layer order: layer r * len(pattern) + j is the reference's
`params["stack"]["p<j>"]` at index r, and the layers after
stack_count * len(pattern) are its `params["tail"]["t<j>"]`. Whisper's
encoder layers are `enc_layers` (the reference's `enc_stack/p0`).

`forward` records autograd where the caller lets it (serving callers run
under `torch.no_grad()`); `loss_fn` is the reference's next-token
cross-entropy over the text region, for training.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from . import recurrent as rec_lib
from . import sharding as shard_lib
from . import xlstm as xlstm_lib
from .layers import (InitCtx, Table, apply_norm, init_embed, init_mlp,
                     init_norm, init_unembed, matmul, mlp, softcap,
                     unembed_logits)

KINDS = ("attn", "local", "xattn", "rglru", "mlstm", "slstm")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One layer: norm1 -> its core (attention, RG-LRU or an xLSTM cell;
    -> norm1_post) -> residual; xattn: normx -> cross-attention ->
    residual; then norm2 -> MLP or MoE (-> norm2_post) -> residual.
    Absent parts are None."""

    def __init__(self, ctx: InitCtx, cfg: ModelConfig, kind: str):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        d = cfg.d_model
        self.kind = kind
        self.norm1 = init_norm(ctx, cfg.norm, d)
        self.attn = self.normx = self.cross = self.rnn = self.cell = None
        if kind in ("attn", "local", "xattn"):
            self.attn = attn_lib.init_attention(
                ctx, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                bias=cfg.attn_bias)
            if kind == "xattn":
                self.normx = init_norm(ctx, cfg.norm, d)
                self.cross = attn_lib.init_attention(
                    ctx, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    bias=cfg.attn_bias)
        elif kind == "rglru":
            self.rnn = rec_lib.init_rglru_block(ctx, d, cfg.d_rnn or d,
                                                cfg.conv_width)
        elif kind == "mlstm":
            self.cell = xlstm_lib.init_mlstm_block(ctx, d, cfg.num_heads,
                                                   cfg.mlstm_proj_factor)
        else:
            self.cell = xlstm_lib.init_slstm_block(ctx, d, cfg.num_heads)
        self.norm2 = self.mlp = self.moe = None
        if kind in ("attn", "local", "xattn", "rglru") and cfg.d_ff > 0:
            self.norm2 = init_norm(ctx, cfg.norm, d)
            if cfg.n_experts:
                self.moe = moe_lib.init_moe(ctx, d, cfg.d_ff, cfg.n_experts,
                                            cfg.mlp_act)
            else:
                self.mlp = init_mlp(ctx, d, cfg.d_ff, cfg.mlp_act,
                                    bias=cfg.attn_bias)
        self.norm1_post = self.norm2_post = None
        if cfg.post_norm:
            self.norm1_post = init_norm(ctx, cfg.norm, d)
            if self.norm2 is not None:
                self.norm2_post = init_norm(ctx, cfg.norm, d)


def init_layer(ctx: InitCtx, cfg: ModelConfig, kind: str) -> Layer:
    return Layer(ctx, cfg, kind)


class Transformer(nn.Module):
    """Parameters of one model, with the reference's leaf names: embed,
    final_norm, unembed (untied), pos_emb (learned positions), enc_layers
    / enc_norm / enc_pos (an encoder), layers."""

    def __init__(self, cfg: ModelConfig, ctx: InitCtx):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embed(ctx, cfg.vocab_size, cfg.d_model)
        self.final_norm = init_norm(ctx, cfg.norm, cfg.d_model)
        self.unembed = None if cfg.tie_embeddings \
            else init_unembed(ctx, cfg.vocab_size, cfg.d_model)
        self.pos_emb = None
        if cfg.pos_kind == "learned":
            self.pos_emb = Table(ctx, cfg.max_position, cfg.d_model,
                                 scale=0.02)
        self.enc_layers = self.enc_norm = self.enc_pos = None
        if cfg.encoder_layers:
            enc_cfg = dataclasses.replace(cfg, n_experts=0)
            self.enc_layers = nn.ModuleList(
                init_layer(ctx, enc_cfg, "attn")
                for _ in range(cfg.encoder_layers))
            self.enc_norm = init_norm(ctx, cfg.norm, cfg.d_model)
            self.enc_pos = Table(ctx, cfg.enc_seq, cfg.d_model, scale=0.02)
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

def feed_forward(cfg: ModelConfig, p, x):
    """The layer's second half: x + (norm2 -> MLP or MoE -> norm2_post)
    -> (x, aux); (x, 0) where the layer has none."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if p.norm2 is None:
        return x, aux
    h2 = apply_norm(cfg.norm, p.norm2, x)
    if p.moe is not None:
        ff, aux = moe_lib.moe(p.moe, h2, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              act=cfg.mlp_act)
    else:
        ff = mlp(p.mlp, h2, cfg.mlp_act)
    if cfg.post_norm:
        ff = apply_norm(cfg.norm, p.norm2_post, ff)
    return x + ff, aux


def apply_layer(cfg: ModelConfig, kind: str, p, x, positions,
                enc_out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (x, aux). x: [B, S, D]."""
    h = apply_norm(cfg.norm, p.norm1, x)
    if kind in ("attn", "local", "xattn"):
        core = attn_lib.attention(
            p.attn, h, positions, theta=cfg.rope_theta, causal=True,
            window=cfg.window if kind == "local" else None,
            attn_softcap=cfg.attn_softcap, use_rope=cfg.pos_kind == "rope",
            q_scale=cfg.q_scale)
    elif kind == "rglru":
        core = rec_lib.rglru_block(p.rnn, h)
    elif kind == "mlstm":
        core = xlstm_lib.mlstm_block_chunked(
            p.cell, h, min(cfg.mlstm_chunk, h.shape[1]))
    else:
        core = xlstm_lib.slstm_block(p.cell, h, cfg.num_heads)
    if cfg.post_norm:
        core = apply_norm(cfg.norm, p.norm1_post, core)
    x = x + core
    if kind == "xattn":
        hx = apply_norm(cfg.norm, p.normx, x)
        x = x + attn_lib.attention(p.cross, hx, positions, kv_x=enc_out,
                                   use_rope=False, causal=False)
    return feed_forward(cfg, p, x)


def _run_stack(cfg: ModelConfig, params, x, positions, enc_out=None,
               scan: Optional[bool] = None, remat: Optional[bool] = None):
    """Every layer in order, unrolled: `scan` is the reference's compile
    switch and is accepted and ignored. With `remat` (default cfg.remat)
    and autograd recording, each period of `stack_period` layers and the
    tail run under `torch.utils.checkpoint`, which keeps only their input
    and recomputes the rest in the backward pass: the reference's
    `jax.checkpoint`. REPRO_REMAT_POLICY picks the periods' policy, as in
    the reference: "nothing" (the default, `nothing_saveable`) or "dots"
    (`dots_with_no_batch_dims_saveable`: the products without a batch
    dimension keep their outputs, `remat_policy`); the tail is always
    `nothing_saveable`. The residual stream is pinned at each period's
    entry and exit and at the tail's entry (sharding hooks: identities
    off a mesh)."""
    remat = (cfg.remat if remat is None else remat) \
        and torch.is_grad_enabled()
    period = len(cfg.stack_period)
    n_stack = cfg.stack_count * period
    layers = list(params.layers)
    groups = [layers[i:i + period] for i in range(0, n_stack, period)]
    if len(layers) > n_stack:
        groups.append(layers[n_stack:])

    # remat's recompute may run on autograd's device thread: it takes the
    # forward's sharding context along
    sharding_ctx = shard_lib.current()

    def run(group, x, aux, is_tail):
        with shard_lib.restored(sharding_ctx):
            x = shard_lib.constrain_residual(x)
            for layer in group:
                x, a = apply_layer(cfg, layer.kind, layer, x, positions,
                                   enc_out)
                aux = aux + a
            if not is_tail:
                x = shard_lib.constrain_residual(x)
        return x, aux

    dots = os.environ.get("REPRO_REMAT_POLICY", "nothing") == "dots"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, group in enumerate(groups):
        is_tail = i * period >= n_stack
        if remat:
            # no layer draws random numbers, so no RNG state to replay
            kw = {}
            if dots and not is_tail:
                kw["context_fn"] = remat_policy
            x, aux = checkpoint(run, group, x, aux, is_tail,
                                use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = run(group, x, aux, is_tail)
    return x, aux


def _saves_dots(ctx, op, *args, **kwargs):
    """The `dots` policy: keep the output of a product without a batch
    dimension (a projection), recompute everything else. `torch.einsum`
    lowers a projection to `bmm` too (a batch of 1 after its reshapes),
    so the op's name alone cannot tell a projection from the attention's
    batched products: a `bmm` counts as unbatched when its batch dim is
    1."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        save = True
    elif op is aten.bmm.default:
        save = args[0].shape[0] == 1
    else:
        save = False
    return CheckpointPolicy.MUST_SAVE if save \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy():
    """The (forward, recompute) contexts of the `dots` policy, for
    `checkpoint(context_fn=)`."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_saves_dots)


def _encode(cfg: ModelConfig, params, frames):
    """Whisper's encoder over the stub frontend's frame embeddings
    [B, T, D]: learned positions, non-causal unrotated self-attention and
    a dense MLP per layer, then enc_norm."""
    x = frames.to(params.embed.table.dtype) \
        + params.enc_pos.table[None, :frames.shape[1]].to(frames.dtype)
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=x.device)[None].expand(frames.shape[:2])
    for layer in params.enc_layers:
        h = apply_norm(cfg.norm, layer.norm1, x)
        x = x + attn_lib.attention(layer.attn, h, pos, causal=False,
                                   use_rope=False)
        h2 = apply_norm(cfg.norm, layer.norm2, x)
        x = x + mlp(layer.mlp, h2, cfg.mlp_act)
    return apply_norm(cfg.norm, params.enc_norm, x)


def embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """-> (x [B,S,D], positions [B,S], enc_out (the encoder's output, or
    None), text_offset)."""
    tok = shard_lib.constrain_tokens(batch["tokens"])
    x = shard_lib.constrain_residual(shard_lib.embedding(params.embed.table,
                                                         tok))
    if cfg.emb_scale:
        # the sqrt(d) constant is rounded to the activation dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    offset = 0
    if cfg.num_img_tokens and "img" in batch:
        img = batch["img"].to(x.dtype)
        x = torch.cat([img, x], dim=1)
        offset = img.shape[1]
    enc_out = _encode(cfg, params, batch["frames"]) \
        if cfg.encoder_layers else None
    s = x.shape[1]
    positions = shard_lib.like_rows(
        torch.arange(s, dtype=torch.int32, device=x.device)[None]
        .expand(x.shape[0], s), x)
    if cfg.pos_kind == "learned":
        x = x + params.pos_emb.table[None, :s].to(x.dtype)
    return x, positions, enc_out, offset


def logits_from_hidden(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = unembed_logits(params.embed, h)
    else:
        logits = matmul(h, params.unembed.w)
    return softcap(logits, cfg.logit_softcap)


def forward(cfg: ModelConfig, params, batch, scan: Optional[bool] = None,
            remat: Optional[bool] = None, last_logits_only: bool = False):
    """Full-sequence forward -> (logits, aux, hidden [B,S,D], offset).

    last_logits_only=True computes the unembedding for the final position
    only. Autograd records unless the caller turns it off."""
    x, positions, enc_out, offset = embed_inputs(cfg, params, batch)
    x = shard_lib.constrain_residual(x)
    x, aux = _run_stack(cfg, params, x, positions, enc_out, scan=scan,
                        remat=remat)
    x = shard_lib.constrain_residual(x)
    x = apply_norm(cfg.norm, params.final_norm, x)
    h = x[:, -1:, :] if last_logits_only else x
    return logits_from_hidden(cfg, params, h), aux, x, offset


def loss_fn(cfg: ModelConfig, params, batch, scan: Optional[bool] = None,
            remat: Optional[bool] = None):
    """Next-token cross-entropy over the text region -> (total, metrics):
    total = loss + 0.01 * aux (the MoE load-balance term), metrics
    {loss, aux, ppl = exp(min(loss, 20))}, 0-d float32 tensors.

    The logits at sequence position offset + j (after pixtral's image
    tokens) predict token j + 1; positions without a target are masked,
    not sliced, as in the reference. Log-softmax in float32."""
    logits, aux, _, offset = forward(cfg, params, batch, scan, remat)
    tok = batch["tokens"].long()
    s_total, s_text = logits.shape[1], tok.shape[1]
    tidx = torch.arange(s_total, device=logits.device) - offset + 1
    ok = (tidx >= 1) & (tidx <= s_text - 1)
    tgt = tok[:, torch.clamp(tidx, 0, s_text - 1)]              # [B, S]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -shard_lib.gather_last(logp, tgt)
    loss = torch.sum(nll * ok[None, :]) / (ok.sum() * tok.shape[0])
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl": torch.exp(torch.clamp(loss, max=20.0))}
