"""Logical-axis -> mesh-axis sharding rules on DTensor (port of
repro.models.sharding, MaxText-style).

Parameters carry logical axis names ("embed", "ff", "heads", "experts",
...; `layers.InitCtx.param` records them, `logical_axes` reads them); a
rule set maps them onto the mesh axes ("data", "model" and the
multi-pod "pod" axis). Divisibility is checked per leaf: an axis whose
dim doesn't divide by the mapped mesh size falls back to replication
(e.g. kv_heads=8 on a 16-way model axis), keeping every arch placeable on
every mesh without per-arch special cases.

Parallelism coverage:
  DP    batch over ("pod","data")
  FSDP  "embed" (and friends) over "data" -- ZeRO-style param+opt sharding
  TP    "ff"/"heads"/"vocab" over "model"
  EP    "experts" over "model" (phi3.5: 16e on 16-way axis)
  SP    the residual stream's sequence over "model"; decode KV-cache
        *sequence* over "model" when heads don't divide

A mesh here is a `DeviceMesh` with `mesh_dim_names`, or the same names
and sizes as a {name: size} dict in mesh order: every rule function takes
either, so placements are computed (and tested) without a process group.
A spec is the reference's PartitionSpec as a tuple, one entry per tensor
dim (None, an axis name, or a tuple of names in mesh order); `placements`
turns it into DTensor placements (`Shard(dim)` on each mesh dim that
shards a tensor dim, `Replicate()` elsewhere).

The activation hooks (`constrain_*`, `gather_fsdp`) act inside
`activation_sharding(mesh, rules)` on DTensors only, redistributing to
the reference's placement; everywhere else they return their input, so a
single-device run is unchanged bit for bit. `sp_active`, `attn_exact_mode`
and `moe_group_count` change the arithmetic inside the context, as in the
reference. Products of DTensors run shard-locally (`einsum`), with the
placements chosen here rather than by DTensor's einsum decomposition.
`replicated` is the one place where a step leaves DTensor's sharding
rules for an op: it gathers the inputs, runs the op on every rank, and
counts the call by site.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

log = logging.getLogger(__name__)


def make_rules(*, fsdp: bool = False, multi_pod: bool = False,
               shard_experts: bool = True,
               fsdp_over_pod: bool = False,
               sp: bool = True) -> Dict[str, Axis]:
    dp: Axis = ("pod", "data") if multi_pod else ("data",)
    fsdp_ax: Axis = None
    if fsdp:
        fsdp_ax = ("pod", "data") if (fsdp_over_pod and multi_pod) \
            else ("data",)
    return {
        "batch": dp,
        "vocab": "model",
        "embed": fsdp_ax,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "experts": "model" if shard_experts else None,
        "rnn": "model",
        "rnn_out": None,
        "layers": None,
        # sequence parallelism: residual-stream S dim over `model`
        "act_seq": "model" if sp else None,
        None: None,
    }


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh)[name]


def _axes_size(mesh, ax: Axis) -> int:
    return math.prod(_axis_size(mesh, a)
                     for a in (ax if isinstance(ax, tuple) else (ax,)))


def logical_to_pspec(axes: Tuple[Optional[str], ...],
                     shape: Tuple[int, ...],
                     rules: Dict[str, Axis], mesh) -> Spec:
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        phys = rules.get(ax)
        if phys is None:
            out.append(None)
            continue
        cand = phys if isinstance(phys, tuple) else (phys,)
        cand = tuple(p for p in cand if p not in used)
        size = math.prod(_axis_size(mesh, p) for p in cand) if cand else 1
        if cand and dim % size == 0:
            out.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            out.append(None)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim. Axes named together
    on one tensor dim must come in mesh order (DTensor shards a dim over
    several mesh dims major to minor, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_axes(params) -> Dict[str, Tuple[Optional[str], ...]]:
    """{port parameter name: logical axes} of a model (on any device,
    "meta" included). A stacked reference leaf's spec is ("layers",) +
    the axes of each of its layers here (convert.reference_key names the
    leaf)."""
    out = {}
    for prefix, mod in params.named_modules():
        for name, axes in getattr(mod, "param_axes", {}).items():
            if getattr(mod, name, None) is not None:
                out[f"{prefix}.{name}" if prefix else name] = axes
    return out


def param_pspecs(params, rules: Dict[str, Axis], mesh) -> Dict[str, Spec]:
    """{port parameter name: spec} of a model."""
    axes = logical_axes(params)
    named = dict(params.named_parameters())
    if set(axes) != set(named):
        raise ValueError(f"parameters without logical axes: "
                         f"{sorted(set(named) ^ set(axes))}")
    return {n: logical_to_pspec(axes[n], tuple(p.shape), rules, mesh)
            for n, p in named.items()}


def param_shardings(params, rules: Dict[str, Axis], mesh) -> Dict[str, tuple]:
    """{port parameter name: DTensor placements} of a model."""
    return {n: placements(s, mesh)
            for n, s in param_pspecs(params, rules, mesh).items()}


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def batch_pspec(shape: Tuple[int, ...], rules, mesh) -> Spec:
    dp = rules["batch"]
    dp_size = _axes_size(mesh, dp)
    if not shape:
        return ()
    b = dp if shape[0] % dp_size == 0 and shape[0] >= dp_size else None
    return (b,) + (None,) * (len(shape) - 1)


def batch_shardings(batch_tree, rules, mesh):
    """The batch dim over the data axes where it divides; a dict of
    placements shaped like `batch_tree`."""
    return _tree_map(lambda _, leaf: placements(
        batch_pspec(tuple(leaf.shape), rules, mesh), mesh), batch_tree)


def cache_pspec(path, shape: Tuple[int, ...], rules, mesh, cfg) -> Spec:
    """One cache leaf's spec from its path ("p<j>" stacked with a leading
    stack dim, or "t<j>"; the last key names the leaf) and shape; every
    axis assignment is divisibility-checked (batch=1 cells like long_500k
    fall back to replication)."""
    dp = rules["batch"]
    model = "model"
    msize = _axis_size(mesh, model)
    dp_size = _axes_size(mesh, dp)

    def div(dim, ax, size):
        return ax if dim % size == 0 and dim >= size else None

    name, top = path[-1], path[0]
    stacked = top.startswith("p")
    shp = shape[1:] if stacked else shape
    prefix = (None,) if stacked else ()

    b = shp[0]
    bspec = div(b, dp, dp_size)
    if name in ("k", "v", "xk", "xv"):
        _, w, kv, hd = shp
        if kv % msize == 0:
            rest = (None, model, None)
        elif w % msize == 0:
            rest = (model, None, None)
        else:
            rest = (None, None, None)
        return (*prefix, bspec, *rest)
    if name == "pos":
        _, w = shp
        kvh = cfg.num_kv_heads
        if kvh % msize != 0 and w % msize == 0:
            return (*prefix, bspec, model)
        return (*prefix, bspec)
    # recurrent states: shard the widest trailing dim if divisible
    rest = []
    used_model = False
    for d in shp[1:]:
        ax = div(d, model, msize)
        if not used_model and ax is not None:
            rest.append(ax)
            used_model = True
        else:
            rest.append(None)
    return (*prefix, bspec, *rest)


def cache_shardings(cache_tree, rules, mesh, cfg):
    """Leaf-shape-driven cache placements (the SP item of the module
    docstring), a dict shaped like `cache_tree`."""
    return _tree_map(lambda path, leaf: placements(
        cache_pspec(path, tuple(leaf.shape), rules, mesh, cfg), mesh),
        cache_tree)


def constrain(x, rules, mesh, *axes):
    """Redistribute the DTensor x to its logical axes' placement."""
    return _pin(x, logical_to_pspec(axes, tuple(x.shape), rules, mesh))


# ---------------------------------------------------------------------------
# Activation-sharding context
# ---------------------------------------------------------------------------
# The [B, H, S, T] attention score tensor dominates training memory: its
# placement is pinned explicitly (heads over `model` when divisible, else
# the q-seq axis), as are the residual stream, the MoE dispatch tensors and
# the FSDP weights at their point of use.

_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Axis]):
    """Turn the hooks on for `mesh` (a DeviceMesh, or a {name: size} dict
    for code that only reads sizes) and `rules`. Plain tensors that meet
    DTensors inside count as replicated (DTensor's implicit replication:
    masks, positions and constants the model builds as it runs). On a
    CUDA mesh over gloo, all-gathers cross through host memory
    (`host_staged_all_gather`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = current()
    _CTX.val = (mesh, rules)
    stage = host_staged_all_gather() if _cuda_on_gloo(mesh) \
        else contextlib.nullcontext()
    try:
        with implicit_replication(), stage:
            yield
    finally:
        _CTX.val = prev


def _cuda_on_gloo(mesh) -> bool:
    import torch.distributed as dist
    if isinstance(mesh, dict) or mesh.device_type != "cuda":
        return False
    return dist.get_backend(mesh.get_group(0)) == dist.Backend.GLOO


@contextlib.contextmanager
def host_staged_all_gather():
    """Route every functional all-gather of a CUDA tensor through host
    memory (core.topk._through_host: counted by topk.host_staging(), its
    first use logged). gloo crashes on an all-gather of CUDA tensors; its
    all-reduce, reduce-scatter and all-to-all take them (each copies
    through the host itself). Several ranks that share one card cannot
    use NCCL, so this is how a sharded step runs there."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from ..core import topk

    class _Staged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # let DTensor desugar its op first: its collectives then
                # dispatch on local tensors, with this mode active
                return NotImplemented
            kwargs = kwargs or {}
            if func is torch.ops._c10d_functional.all_gather_into_tensor \
                    .default and args[0].is_cuda:
                wait = torch.ops._c10d_functional.wait_tensor.default
                return topk._through_host(
                    lambda host: [wait(func(host[0], *args[1:], **kwargs))],
                    [args[0]])[0]
            return func(*args, **kwargs)
    with _Staged():
        yield


def current():
    """This thread's (mesh, rules), or None: for code that runs again on
    another thread (remat's recompute runs on autograd's device thread)."""
    return getattr(_CTX, "val", None)


@contextlib.contextmanager
def restored(val):
    """Make `val` (a `current()` result) this thread's context for a
    while."""
    prev = current()
    _CTX.val = val
    try:
        yield
    finally:
        _CTX.val = prev


def _pin(x, spec: Spec):
    """Redistribute the DTensor x to `spec`; any other value passes."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _kept_dims(src, dst) -> Dict[int, int]:
    """{dim of shape `src`: its dim in `dst`} for the dims a reshape keeps
    whole (each alone in its group, at the same size)."""
    kept, i, j = {}, 0, 0
    while i < len(src) and j < len(dst):
        i0, j0, a, b = i, j, src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a, i = a * src[i], i + 1
            else:
                b, j = b * dst[j], j + 1
        if i - i0 == 1 and j - j0 == 1:
            kept[i0] = j0
    return kept


def _grad_placements(pl) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() else p for p in pl)


class _ShardReshape(torch.autograd.Function):
    """A reshape of each rank's own shard (the sharded dims kept whole):
    its backward reshapes each shard of the gradient back, so DTensor is
    never asked to view a gradient that is sharded otherwise."""

    @staticmethod
    def forward(ctx, x, out_local, shape, out_pl):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.pl, ctx.out_pl = x.device_mesh, x.placements, out_pl
        ctx.shape, ctx.local_shape = x.shape, x.to_local().shape
        return DTensor.from_local(x.to_local().reshape(out_local),
                                  x.device_mesh, out_pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        local = grad.redistribute(ctx.mesh, _grad_placements(ctx.out_pl)) \
            .to_local().reshape(ctx.local_shape)
        return (DTensor.from_local(local, ctx.mesh,
                                   _grad_placements(ctx.pl),
                                   run_check=False, shape=ctx.shape,
                                   stride=_contiguous(ctx.shape)),
                None, None, None)


def reshape(x, shape):
    """x.reshape(shape). On a DTensor, a mesh dim that shards a dim the
    reshape splits or merges is gathered first, then each rank reshapes
    its own shard (`_ShardReshape`), so neither the reshape nor its
    backward asks DTensor to split an uneven shard (or to view a
    non-contiguous one)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = list(shape)
    if -1 in shape:
        rest = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = x.numel() // rest
    kept = _kept_dims(tuple(x.shape), shape)
    pl = tuple(p if not p.is_shard() or p.dim in kept else Replicate()
               for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    out_local = list(shape)
    for i, j in kept.items():
        out_local[j] = x.to_local().shape[i]
    out_pl = tuple(Shard(kept[p.dim]) if p.is_shard() else p for p in pl)
    return _ShardReshape.apply(x, out_local, shape, out_pl)


def splittable(x, dim: int, n: int):
    """x, with dim `dim` ready to split into n leading groups (n = 1: to
    merge into the dim before it): a DTensor whose shards of that dim do
    not divide n is made whole on those mesh dims first (DTensor cannot
    reshape an uneven shard). Any other x passes."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dims = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    shards = math.prod(x.device_mesh.shape[i] for i in dims)
    if not dims or n % shards == 0:
        return x
    pl = [Replicate() if i in dims else p
          for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


def like(x, ref):
    """x redistributed to the DTensor `ref`'s placements (a gradient onto
    its moment's); any other x passes."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or tuple(x.placements) == \
            tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def embedding(table, tokens):
    """table[tokens]. On a DTensor table, a vocab-parallel lookup: the
    table keeps its vocab shards (its embed dim made whole), the tokens
    are made whole on the mesh dims that shard the vocab, each rank looks
    up the tokens in its vocab range (zero rows elsewhere) and the result
    is a partial sum over those mesh dims -- one exact nonzero term per
    token. Neither the lookup nor its backward holds the whole table or
    a replicated [B, S, D] (DTensor's own index rule does both)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    tpl = tuple(p if p.is_shard(0) else Replicate() for p in table.placements)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    (Replicate(),) * mesh.ndim,
                                    run_check=False)
    kpl = tuple(Replicate() if tp.is_shard(0) or kp.is_partial() else kp
                for tp, kp in zip(tpl, tokens.placements))
    # each rank adds the rows of its own tokens into the table's gradient:
    # a partial sum over the mesh dims that shard the tokens
    tgrad = tuple(tp if tp.is_shard(0) else
                  Partial() if kp.is_shard() else Replicate()
                  for tp, kp in zip(tpl, kpl))
    local_t = table.redistribute(mesh, tpl).to_local(grad_placements=tgrad)
    tok = tokens.redistribute(mesh, kpl).to_local().long()
    _, (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, tpl)
    mine = (tok >= lo) & (tok < lo + local_t.shape[0])
    rows = local_t[torch.where(mine, tok - lo, torch.zeros_like(tok))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    out_pl = tuple(Partial() if tp.is_shard(0) else kp
                   for tp, kp in zip(tpl, kpl))
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(rows, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def like_rows(t, ref):
    """A plain tensor `t` laid out as the DTensor `ref` on the leading
    dims they share (each rank keeps its slice; nothing moves): positions
    beside the residual stream. Off a mesh, `t` itself."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import distribute_tensor
    pl = tuple(p if p.is_shard() and p.dim < t.ndim else Replicate()
               for p in ref.placements)
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def gather_last(x, index):
    """torch.gather(x, -1, index[..., None])[..., 0]. On a DTensor x the
    gather runs on each rank's shard, with x's last dim made whole and
    `index` redistributed to x's placements, so neither the gather nor its
    backward (a scatter into zeros) ever holds x's full value."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(x.ndim - 1)
               else p for p in x.placements)
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
    out = torch.gather(x.redistribute(mesh, pl).to_local(), -1,
                       index.redistribute(mesh, pl).to_local()[..., None])
    return DTensor.from_local(out[..., 0], mesh, pl, run_check=False,
                              shape=index.shape,
                              stride=_contiguous(index.shape))


def attn_exact_mode() -> bool:
    """True when the cost probes want the exact single-block attention
    (see attention._attn_block)."""
    ctx = current()
    if ctx is None:
        return False
    _, rules = ctx
    return bool(rules.get("attn_exact", False))


def loop_once() -> bool:
    """True when the dry-run's cost trace wants a sequential time loop's
    body run once (the sLSTM's; its cost over the whole sequence is added
    analytically, as the reference adds it for XLA's while-loop bodies)."""
    ctx = current()
    return ctx is not None and bool(ctx[1].get("loop_once", False))


def sp_active(seq_len: Optional[int] = None) -> bool:
    """True when sequence-parallel residuals are in effect (and divisible)."""
    ctx = current()
    if ctx is None:
        return False
    mesh, rules = ctx
    if rules.get("act_seq") is None:
        return False
    if seq_len is not None and seq_len % _axis_size(mesh, "model"):
        return False
    return True


def constrain_residual(x):
    """Residual stream [B, S, D]: shard S over model under SP rules."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    mesh, rules = ctx
    ax = rules.get("act_seq")
    if ax is None or x.shape[1] % _axis_size(mesh, "model") or \
            x.shape[1] < _axis_size(mesh, "model"):
        return x
    return _pin(x, (rules["batch"], ax, None))


def constrain_feature(x):
    """RNN-state activations [B, S, R]: shard the feature dim over model
    (the scan over S is elementwise in R, so it stays local)."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    mesh, rules = ctx
    if x.shape[2] % _axis_size(mesh, "model"):
        return x
    return _pin(x, (rules["batch"], None, "model"))


def moe_group_count(seq_len: int) -> int:
    """Routing groups for MoE dispatch: one group per SP shard of the
    sequence (1 when SP is off / indivisible, and off a mesh)."""
    ctx = current()
    if ctx is None:
        return 1
    mesh, rules = ctx
    m = _axis_size(mesh, "model")
    if rules.get("act_seq") is None or seq_len % m or seq_len < m:
        return 1
    return m


def constrain_moe(x, phase: str):
    """MoE dispatch/combine tensors [B, G, E, C, D].

    phase="group":  pin G to the model axis -- routing stays local to the
                    SP shard that owns those tokens;
    phase="expert": pin E to the model axis (expert parallelism) -- the
                    group->expert reshard is the MoE all-to-all.
    Archs whose E doesn't divide the axis (grok-1: E=8 on 16) skip the
    expert pin."""
    ctx = current()
    if ctx is None or x.ndim != 5:
        return x
    mesh, rules = ctx
    dp = rules["batch"]
    m = _axis_size(mesh, "model")
    b, g, e, c, d = x.shape
    if phase == "group":
        if g % m == 0 and g >= m:
            return _pin(x, (dp, "model", None, None, None))
        return x
    if rules.get("experts") is None or e % m:
        return x
    return _pin(x, (dp, None, "model", None, None))


def gather_fsdp(w, axes: Tuple[Optional[str], ...]):
    """ZeRO semantics at point-of-use: all-gather the FSDP ('embed'->data)
    shard of a weight, keeping its TP/EP axes."""
    ctx = current()
    if ctx is None:
        return w
    mesh, rules = ctx
    if rules.get("embed") is None or not rules.get("gather_fsdp", True):
        # decode: activations are tiny, so partial sums beat gathering
        # expert weights every layer
        return w
    rules2 = dict(rules)
    rules2["embed"] = None
    return _pin(w, logical_to_pspec(axes, tuple(w.shape), rules2, mesh))


def constrain_tokens(tokens):
    """Token batch [B, S]: pin S over model under SP *before* the
    embedding gather."""
    ctx = current()
    if ctx is None or tokens.ndim != 2:
        return tokens
    mesh, rules = ctx
    dp = rules["batch"]
    dp_size = _axes_size(mesh, dp)
    b = dp if tokens.shape[0] % dp_size == 0 and \
        tokens.shape[0] >= dp_size else None
    s_ax = rules.get("act_seq")
    m = _axis_size(mesh, "model")
    if s_ax is not None and tokens.shape[1] % m == 0 and tokens.shape[1] >= m:
        return _pin(tokens, (b, s_ax))
    return _pin(tokens, (b, None))


def constrain_seq_replicated(x):
    """Pin [B, S, D] batch-sharded with S *replicated*: blocks whose time
    recurrence must scan the full sequence locally (sLSTM)."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    _, rules = ctx
    return _pin(x, (rules["batch"], None, None))


def constrain_scores(scores, kv_heads: Optional[int] = None):
    """scores: [B, H, S, T] -- pick the best available model-axis dim.

    Decode (S == 1) follows the KV-cache layout: when kv_heads don't
    divide the axis the cache is *sequence*-sharded, so scores are
    T-sharded."""
    ctx = current()
    if ctx is None:
        return scores
    mesh, rules = ctx
    dp = rules["batch"]
    msize = _axis_size(mesh, "model")
    b, h, s, t = scores.shape
    if s > 1 and rules.get("act_seq") is not None and s % msize == 0:
        return _pin(scores, (dp, None, "model", None))
    cache_seq_sharded = (s == 1 and kv_heads is not None
                         and kv_heads % msize != 0 and t % msize == 0
                         and t >= msize)
    if cache_seq_sharded:
        spec = (dp, None, None, "model")
    elif h % msize == 0:
        spec = (dp, "model", None, None)
    elif s % msize == 0 and s > 1:          # SP over query positions
        spec = (dp, None, "model", None)
    elif t % msize == 0 and t >= msize:     # SP over key positions
        spec = (dp, None, None, "model")
    else:
        spec = (dp, None, None, None)
    if b % _axes_size(mesh, dp) or b < _axes_size(mesh, dp):
        spec = (None,) + spec[1:]
    return _pin(scores, spec)


# ---------------------------------------------------------------------------
# Products of DTensors, computed shard-locally
# ---------------------------------------------------------------------------

def _expand_ellipsis(eq: str, ops) -> Tuple[list, str]:
    ins, out = eq.replace(" ", "").split("->")
    terms = ins.split(",")
    if "..." not in eq:
        return terms, out
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max(t.ndim - (len(term) - 3) for t, term in zip(ops, terms)
            if "..." in term)
    lead = "".join(free[:n])
    terms = [term.replace("...", lead[n - (t.ndim - (len(term) - 3)):])
             for t, term in zip(ops, terms)]
    return terms, out.replace("...", lead)


def einsum(eq: str, *ops):
    """torch.einsum of DTensors (plain operands count as replicated),
    computed on each rank's local shards. Per mesh dim: operands that
    shard the same letter keep it; a replicated operand holding that
    letter takes its matching shard (a local slice); where operands shard
    different letters, all but the largest are gathered on that mesh dim;
    partial inputs are reduced first. The result is sharded on that
    letter, or a partial sum where the letter is contracted. No view of a
    sharded dim is ever needed (DTensor's own einsum merges and splits
    dims, and cannot split a dim whose shards are uneven, e.g. 8 KV heads
    on a 16-way axis)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(t.device_mesh for t in ops if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim
    ops = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, rep, run_check=False) for t in ops]
    terms, out = _expand_ellipsis(eq, ops)
    pls = [[Replicate() if p.is_partial() else p for p in t.placements]
           for t in ops]
    out_pl = []
    grads = [[Replicate()] * mesh.ndim for _ in ops]
    for i in range(mesh.ndim):
        letters = {j: terms[j][p.dim] for j, p in
                   enumerate(pl[i] for pl in pls) if isinstance(p, Shard)}
        if len(set(letters.values())) > 1:
            keep = max(letters, key=lambda j: ops[j].numel())
            for j in letters:
                if j != keep:
                    pls[j][i] = Replicate()
            letters = {keep: letters[keep]}
        if not letters:
            out_pl.append(Replicate())
            continue
        c = next(iter(letters.values()))
        for j, term in enumerate(terms):
            # an operand without the sharded letter has a local gradient
            # that sums this rank's slice of it only: a partial sum
            pls[j][i] = Shard(term.index(c)) if c in term else Replicate()
            grads[j][i] = Shard(term.index(c)) if c in term else Partial()
        out_pl.append(Shard(out.index(c)) if c in out else Partial())
    local = [t.redistribute(mesh, pl).to_local(grad_placements=g)
             for t, pl, g in zip(ops, pls, grads)]
    res = torch.einsum(",".join(terms) + "->" + out, *local)
    sizes = {c: n for t, term in zip(ops, terms)
             for c, n in zip(term, t.shape)}
    shape = torch.Size(sizes[c] for c in out)
    return DTensor.from_local(res, mesh, out_pl, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# The explicit replicate-around-an-op fallback
# ---------------------------------------------------------------------------

_REPLICATED: collections.Counter = collections.Counter()


def replicated(site: str, fn, *args):
    """fn(*args) with every DTensor argument gathered to its full value on
    every rank, for an op that DTensor has no sharding rule for (the MoE
    sort dispatch, the associative scan, ...). Tensor results come back
    as replicated DTensors, so autograd runs through the gathers. Off a
    mesh (no DTensor argument) it is fn(*args). Each call on DTensors is
    counted under `site` (`replicated_calls`) and the first is logged."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not _REPLICATED[site]:
        log.warning("sharding.replicated: %s runs replicated on every rank",
                    site)
    _REPLICATED[site] += 1
    out = fn(*[a.redistribute(mesh, rep).to_local()
               if isinstance(a, DTensor) else a for a in args])

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        return t
    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def replicated_calls() -> Dict[str, int]:
    return dict(_REPLICATED)


def reset_replicated_calls() -> None:
    _REPLICATED.clear()
