"""Token-choice top-k Mixture-of-Experts (port of repro.models.moe;
phi3.5-moe: 16e top-2, grok-1: 8e top-2).

Sort-based capacity dispatch, batched over the rows [B, G] (the
reference vmaps one row at a time):
  * routing runs in float32: logits = x . router, softmax, top-k with the
    lowest expert index first among equal probabilities (`lax.top_k`'s
    rule, taken from a stable descending sort: `torch.topk` on the card
    promises no order among ties), gates renormalised;
  * each (token, choice) pair is ordered by expert with a stable sort,
    counted (bincount), and given slot idx_in_expert < cap of its expert;
    pairs past an expert's capacity drop (keep = False);
  * experts run as batched products over [B, G, E, C, D] (plain einsums,
    as in the reference: no Pallas kernel here);
  * combine sums a token's top_k contributions in choice order, through
    the inverse of the dispatch permutation: no scatter-add, so a token's
    output has the same bits in every run and in any batch;
  * the backward pass is as ordered: the dispatch gathers pairs through
    a permutation, so no two gradient rows meet in an atomic add (a
    dropped pair's slot receives only exact zeros).

Routing groups: under sequence parallelism the S axis is sharded over
`model`, so tokens are grouped per SP shard (`sharding.moe_group_count`;
one group off a mesh), which sets each group's capacity. On a mesh the
expert weights are gathered over FSDP at use (`gather_fsdp`), the
dispatch tensors pinned to their group, then expert, placement
(`constrain_moe`), and the sort dispatch and the combine run replicated
(`sharding.replicated`: DTensor has no rule for the sort).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import InitCtx, Params, einsum, gelu
from .sharding import (constrain_moe, gather_fsdp, moe_group_count,
                       replicated)


# the expert weights' logical axes (gather_fsdp reads them at use)
EXPERT_AXES = {"wi": ("experts", "embed", "ff"),
               "wg": ("experts", "embed", "ff"),
               "wo": ("experts", "ff", "embed")}


class MoE(Params):
    """`router` [D, E] float32, `wi` / `wg` [E, D, F], `wo` [E, F, D]."""

    def __init__(self, ctx: InitCtx, dim: int, d_ff: int, n_experts: int,
                 act: str = "silu_glu"):
        super().__init__()
        self.router = ctx.param((dim, n_experts), ("embed", "experts"),
                                dtype=torch.float32)
        self.wi = ctx.param((n_experts, dim, d_ff), EXPERT_AXES["wi"])
        self.wo = ctx.param((n_experts, d_ff, dim), EXPERT_AXES["wo"])
        self.wg = ctx.param((n_experts, dim, d_ff), EXPERT_AXES["wg"]) \
            if act.endswith("_glu") else None


def init_moe(ctx: InitCtx, dim: int, d_ff: int, n_experts: int,
             act: str = "silu_glu") -> MoE:
    return MoE(ctx, dim, d_ff, n_experts, act)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """x [N, S, D] -> (probs [N, S, E], gate values [N, S, k] renormalised,
    expert indices [N, S, k]) in float32; ties go to the lower index."""
    logits = torch.matmul(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    return probs, vals / vals.sum(-1, keepdim=True), idx


def _dispatch(xt, router, top_k: int, cap: int):
    """xt [N, S, D] (N independent rows) -> (xe [N, E*C, D], slot, keep,
    gates, order, aux [N]); slot / keep / gates [N, S*k] are in the
    expert-sorted order `order` of the flattened (token, choice) pairs."""
    n, s, d = xt.shape
    e = router.shape[1]
    probs, gate_vals, gate_idx = route(xt, router, top_k)

    # Switch-style load-balance loss of each row
    me = probs.mean(dim=1)
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=1)
    aux = e * (me * ce).sum(-1)

    flat_e = gate_idx.reshape(n, s * top_k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = torch.gather(flat_e, 1, order)
    counts = F.one_hot(flat_e, e).sum(1)                   # bincount, [N, E]
    offsets = torch.cumsum(counts, -1) - counts            # exclusive
    idx_in_e = torch.arange(s * top_k, device=xt.device) \
        - torch.gather(offsets, 1, se)
    keep = idx_in_e < cap
    slot = torch.clamp(se * cap + idx_in_e, 0, e * cap - 1)
    gates = torch.gather(gate_vals.reshape(n, -1), 1, order) * keep

    # each pair's token row in the sorted order: the token-major pairs
    # (a token's top_k copies) gathered through the permutation `order`,
    # which names every pair once, so the backward pass adds no two rows
    # in a float race (a gather by token would scatter-add each token's
    # copies by atomics); the copies meet in the expand's backward, a sum
    # over the choices
    pairs = xt[:, :, None, :].expand(n, s, top_k, d).reshape(n, s * top_k, d)
    xg = torch.where(keep[..., None], torch.gather(
        pairs, 1, order[..., None].expand(n, s * top_k, d)),
        torch.zeros((), dtype=xt.dtype, device=xt.device))
    # kept pairs own distinct slots; a dropped pair may share one, but it
    # adds an exact zero there, so the order of the adds cannot show
    base = (torch.arange(n, device=xt.device) * (e * cap))[:, None]
    xe = torch.zeros((n * e * cap, d), dtype=xt.dtype, device=xt.device)
    xe.index_add_(0, (base + slot).reshape(-1), xg.reshape(-1, d))
    return (xe.reshape(n, e * cap, d), slot, keep, gates.float(), order,
            aux)


def _combine(ye, slot, keep, gates, order, s: int, top_k: int):
    """ye [N, E*C, D] -> y [N, S, D]: each token's top_k contributions,
    summed in choice order (the reference's scatter-add of the same
    terms onto zeros)."""
    n, _, d = ye.shape
    contrib = torch.gather(ye, 1, slot[..., None].expand(-1, -1, d)) \
        * (gates * keep)[..., None].to(ye.dtype)
    inv = torch.argsort(order, dim=-1)       # pair t*k + j -> its position
    contrib = torch.gather(contrib, 1, inv[..., None].expand(-1, -1, d)) \
        .reshape(n, s, top_k, d)
    y = contrib[:, :, 0]
    for j in range(1, top_k):
        y = y + contrib[:, :, j]
    return y


def moe(p, x, *, top_k: int = 2, capacity_factor: float = 1.25,
        act: str = "silu_glu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux_loss scalar)."""
    w = {n: gather_fsdp(getattr(p, n), axes) for n, axes in
         EXPERT_AXES.items() if getattr(p, n) is not None}
    b, s, d = x.shape
    e = p.router.shape[1]
    g = moe_group_count(s)
    s_loc = s // g
    cap = int(max(1, round(s_loc * top_k / e * capacity_factor)))

    xe, slot, keep, gates, order, aux = replicated(
        "moe dispatch", lambda x, r: _dispatch(
            x.reshape(b * g, s_loc, d), r, top_k, cap), x, p.router)
    xe = constrain_moe(xe.reshape(b, g, e, cap, d), "group")   # local pin
    xe = constrain_moe(xe, "expert")                           # a2a in
    h = einsum("bgecd,edf->bgecf", xe, w["wi"])
    if "wg" in w:
        hg = einsum("bgecd,edf->bgecf", xe, w["wg"])
        h = (F.silu(hg) * h) if act == "silu_glu" \
            else (gelu(hg) * h)
    else:
        h = gelu(h)
    ye = einsum("bgecf,efd->bgecd", h, w["wo"])
    ye = constrain_moe(ye, "expert")
    ye = constrain_moe(ye, "group")                            # a2a out
    y = replicated(
        "moe combine", lambda ye, *r: _combine(
            ye.reshape(b * g, e * cap, d), *r, s_loc, top_k),
        ye, slot, keep, gates, order)
    return y.reshape(b, s, d), aux.mean()
