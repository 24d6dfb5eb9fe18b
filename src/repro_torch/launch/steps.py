"""Step builders and abstract state on a mesh (port of repro.launch.steps).

One place defines, per (arch x shape x mesh):
  * the step function   (train_step / prefill_step / serve_step)
  * abstract inputs     ("meta" tensors: shapes and dtypes, no memory)
  * in-shardings        (logical rules -> DTensor placements)

There is no compile: `lower` places the arguments as DTensors under their
placements and binds the step to them. The result runs the step inside
`activation_sharding(mesh, rules)` on real tensors (a sharded train step
on a process group), or on "meta" tensors of a fake-backend world, where
the dry-run (launch.dryrun) traces one step for its cost model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from ..configs.inputs import batch_specs, decode_specs
from ..configs.registry import ArchSpec
from ..models import decode as decode_lib
from ..models import sharding as shard_lib
from ..models import transformer
from ..train import optim, trainer


@dataclasses.dataclass
class Lowerable:
    """A step, its (abstract) arguments and their placements."""
    fn: Any
    args: Tuple
    in_shardings: Tuple
    donate_argnums: Tuple[int, ...] = ()
    name: str = ""
    rules: Any = None


def rules_for(arch: ArchSpec, mesh) -> Dict[str, Any]:
    multi_pod = "pod" in shard_lib.mesh_axes(mesh)
    return shard_lib.make_rules(
        fsdp=arch.fsdp, multi_pod=multi_pod,
        shard_experts=arch.shard_experts,
        fsdp_over_pod=arch.fsdp_over_pod,
        sp=arch.sp)


def abstract_params(cfg: ModelConfig):
    """The model on "meta"; its parameters carry their logical axes
    (the reference returns (params, specs))."""
    return transformer.init_model(cfg, abstract=True)


def abstract_opt_state(params) -> optim.OptState:
    return optim.init(params, abstract=True)


def _opt_shardings(p_shard) -> optim.OptState:
    return optim.OptState(mu=p_shard, nu=p_shard, count=())


def _whole(metrics: dict) -> dict:
    """The step's 0-d metrics as plain tensors (the full value on every
    rank), read inside the step's context."""
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in metrics.items()}


def train_lowerable(arch: ArchSpec, shape: ShapeConfig, mesh,
                    scan: bool = False, remat: bool = True,
                    opt_cfg: Optional[optim.AdamWConfig] = None,
                    microbatches: Optional[int] = None) -> Lowerable:
    cfg = arch.config
    rules = rules_for(arch, mesh)
    params = abstract_params(cfg)
    p_shard = shard_lib.param_shardings(params, rules, mesh)
    batch = batch_specs(cfg, shape)
    b_shard = shard_lib.batch_shardings(batch, rules, mesh)
    ocfg = opt_cfg or optim.AdamWConfig()
    mb = arch.microbatches if microbatches is None else microbatches
    one = trainer.make_train_step(
        cfg, trainer.TrainerConfig(opt=ocfg), scan=scan, remat=remat)

    def train_step(params, opt_state, batch):
        if mb == 1:
            params, opt_state, metrics = one(params, opt_state, batch)
            return params, opt_state, _whole(metrics)
        # the reference's unrolled gradient accumulation: a Python loop
        # over batch slices, gradients summed in their own dtype
        n = shape.global_batch // mb
        grads, metrics = None, None
        for i in range(mb):
            b_i = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
            g, metrics = trainer.grads_of(cfg, params, b_i, scan, remat)
            grads = g if grads is None else \
                {k: grads[k] + g[k] for k in grads}
        grads = {k: g / mb for k, g in grads.items()}
        params, opt_state, om = optim.update(ocfg, grads, opt_state, params)
        return params, opt_state, _whole({**metrics, **om})

    return Lowerable(
        fn=train_step,
        args=(params, abstract_opt_state(params), batch),
        in_shardings=(p_shard, _opt_shardings(p_shard), b_shard),
        donate_argnums=(0, 1),
        name=f"train:{cfg.name}:{shape.name}",
        rules=rules)


def prefill_lowerable(arch: ArchSpec, shape: ShapeConfig, mesh,
                      scan: bool = False) -> Lowerable:
    cfg = arch.config
    rules = rules_for(arch, mesh)
    params = abstract_params(cfg)
    batch = batch_specs(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, hidden, _ = transformer.forward(
            cfg, params, batch, scan=scan, remat=False,
            last_logits_only=True)
        return logits[:, 0, :], hidden[:, -1, :]

    return Lowerable(
        fn=prefill_step,
        args=(params, batch),
        in_shardings=(shard_lib.param_shardings(params, rules, mesh),
                      shard_lib.batch_shardings(batch, rules, mesh)),
        name=f"prefill:{cfg.name}:{shape.name}",
        rules=rules)


def decode_lowerable(arch: ArchSpec, shape: ShapeConfig, mesh,
                     scan: bool = False) -> Lowerable:
    """One decode step at position seq_len - 1 (the port's decode takes
    the position as an int; the cache holds seq_len slots)."""
    cfg = arch.config
    rules = dict(rules_for(arch, mesh), gather_fsdp=False)
    params = abstract_params(cfg)
    dspec = decode_specs(cfg, shape)
    dp = rules["batch"]
    dp_size = shard_lib._axes_size(mesh, dp)
    b = shape.global_batch
    t_spec = (dp if len(dp) > 1 else dp[0]) if b % dp_size == 0 and \
        b >= dp_size else None

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        logits, hidden, new_cache = decode_lib.decode_step(
            cfg, params, cache, token, pos, scan=scan)
        return logits, hidden, new_cache

    return Lowerable(
        fn=serve_step,
        args=(params, dspec["cache"], dspec["token"], shape.seq_len - 1),
        in_shardings=(
            shard_lib.param_shardings(params, rules, mesh),
            shard_lib.cache_shardings(dspec["cache"], rules, mesh, cfg),
            shard_lib.placements((t_spec, None), mesh), None),
        donate_argnums=(1,),
        name=f"decode:{cfg.name}:{shape.name}",
        rules=rules)


def build(arch: ArchSpec, shape: ShapeConfig, mesh,
          scan: bool = False, exact_attn: bool = False) -> Lowerable:
    if shape.kind == "train":
        lw = train_lowerable(arch, shape, mesh, scan=scan)
    elif shape.kind == "prefill":
        lw = prefill_lowerable(arch, shape, mesh, scan=scan)
    else:
        lw = decode_lowerable(arch, shape, mesh, scan=scan)
    if exact_attn:
        lw.rules = dict(lw.rules, attn_exact=True)
    return lw


# ---------------------------------------------------------------------------
# Placing arguments and binding the step
# ---------------------------------------------------------------------------

def _distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Each rank keeps its own shard of the full value it holds (every
    rank holds the same value: no scatter from a source rank). A DTensor
    is taken as placed already."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        return t
    return distribute_tensor(t.detach(), mesh, placements,
                             src_data_rank=None)


def place_params(model: nn.Module, shardings: Dict[str, tuple], mesh):
    """Replace each parameter of `model` by a DTensor parameter under its
    placements, in place (the full value is freed as it goes)."""
    for name, p in list(model.named_parameters()):
        if hasattr(p, "device_mesh"):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(
            _distribute(p, mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return model


def place(arg, sharding, mesh):
    """`arg` (a model, an OptState, a dict of tensors or a tensor) as
    DTensors under `sharding` (its in-shardings entry) on `mesh`."""
    if sharding is None:
        return arg
    if isinstance(arg, nn.Module):
        return place_params(arg, sharding, mesh)
    if isinstance(arg, optim.OptState):
        return optim.OptState(
            mu={n: _distribute(t, mesh, sharding.mu[n])
                for n, t in arg.mu.items()},
            nu={n: _distribute(t, mesh, sharding.nu[n])
                for n, t in arg.nu.items()},
            count=arg.count)
    if isinstance(arg, dict):
        return {k: place(v, sharding[k], mesh) for k, v in arg.items()}
    if isinstance(arg, torch.Tensor):
        return _distribute(arg, mesh, sharding)
    return arg


@dataclasses.dataclass
class Lowered:
    """A step bound to its placed arguments: calling it runs the step once
    inside activation_sharding(mesh, rules)."""
    fn: Any
    args: Tuple
    mesh: Any
    rules: Any
    name: str = ""

    def __call__(self, *args):
        with shard_lib.activation_sharding(self.mesh, self.rules):
            return self.fn(*(args or self.args))


def lower(lw: Lowerable, mesh, args: Optional[Tuple] = None) -> Lowered:
    """Place `args` (default lw.args, the abstract ones) as DTensors under
    lw.in_shardings on `mesh` -- a model's parameters are replaced in
    place -- and bind the step to them."""
    args = lw.args if args is None else args
    placed = tuple(place(a, s, mesh)
                   for a, s in zip(args, lw.in_shardings))
    return Lowered(lw.fn, placed, mesh, lw.rules, lw.name)
