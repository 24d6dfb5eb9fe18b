"""AdamW + gradient clipping in plain tensor ops (port of
repro.train.optim; not `torch.optim.AdamW`, whose arithmetic differs).

The reference's arithmetic, leaf by leaf: float32 moments; the global
gradient norm's clip scale applied before the moments; bias corrections
from the incremented count; weight decay added to the update of matrices
only; the update formed in float32 and cast back to the parameter's
dtype; a warmup-cosine learning rate. Each product and sum is a separate
op in the reference's order, so a parameter's new value is the
reference's up to the libraries' rounding of pow / cos / sqrt.

The state holds the moments by parameter name; `update` writes the
parameters and the moments in place (the counterpart of the reference's
donated buffers) and returns them. "Matrices" are the reference's leaves
of rank >= 2: its layers are stacked, so a stacked layer's 1-d leaf (a
norm scale, a bias) has rank 2 there and is decayed; the port, which
holds one tensor a layer, decays it too (`decays`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from .. import convert
from ..models import sharding as shard_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # float32, one per parameter name
    nu: Dict[str, torch.Tensor]     # float32, one per parameter name
    count: torch.Tensor             # int32, 0-d, on the parameters' device


def init(params, abstract: bool = False) -> OptState:
    """Zero moments beside each parameter of `params` (a model or a
    {name: tensor} dict), on its device; abstract=True on the "meta"
    device (a restore template: shapes only)."""
    named = convert.named_tensors(params)

    def zeros(p):
        if abstract:
            return torch.zeros(p.shape, dtype=torch.float32, device="meta")
        # a DTensor parameter's moments take its placements
        return torch.zeros_like(p, dtype=torch.float32)
    dev = "meta" if abstract else next(iter(named.values())).device
    return OptState(mu={n: zeros(p) for n, p in named.items()},
                    nu={n: zeros(p) for n, p in named.items()},
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to cfg.lr, then a cosine down to lr * min_lr_ratio
    at total_steps; `step` an integer tensor (or int) -> float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (`tree` a
    dict or a sequence of tensors)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def decays(name: str, p: torch.Tensor, cfg=None) -> bool:
    """Whether the reference decays this parameter: its leaf has rank
    >= 2, one more than the port's tensor where the layer is stacked
    there (`cfg` None: a plain dict of leaves, rank as it is)."""
    stacked = cfg is not None and convert.reference_key(name, cfg)[1] \
        is not None
    return p.dim() + int(stacked) >= 2


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params
           ) -> Tuple[object, OptState, dict]:
    """One AdamW step. `grads` {name: tensor} (a missing or None gradient
    counts as zeros), `params` the model or a {name: tensor} dict. Writes
    the parameters and the moments in place -> (params, the state with
    the incremented count, {grad_norm, lr})."""
    named = convert.named_tensors(params)
    model_cfg = getattr(params, "cfg", None)
    gnorm = global_norm([g for g in grads.values() if g is not None])
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    for name, p in named.items():
        g = grads.get(name)
        m, v = state.mu[name], state.nu[name]
        g = (torch.zeros_like(m) if g is None
             else shard_lib.like(g, m).float()) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        del g
        den = (v / b2c).sqrt_().add_(cfg.eps)
        upd = (m / b1c).div_(den)
        del den
        if decays(name, p, model_cfg):
            upd.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - upd.mul_(lr))
    return params, OptState(state.mu, state.nu, count), \
        {"grad_norm": gnorm, "lr": lr}
