"""Carry a JAX-built index, or JAX model weights, into the port.

`index_from_arrays` turns the leaves of a `repro.core.types.IVFIndex`,
handed over as numpy arrays (`np.asarray` of each leaf, on the JAX side),
into this package's `IVFIndex` on `device`. The port never imports the
JAX package; the caller does the export:

    arrays = {"centroids": np.asarray(idx.centroids), ...,
              "delta.vectors": np.asarray(idx.delta.vectors), ...,
              "qstats.lo": np.asarray(idx.qstats.lo), ...}
    config = dataclasses.asdict(idx.config)
    tidx = index_from_arrays(arrays, config, "cuda")

Keys: centroids, csizes, vectors, ids, attrs, valid, counts,
delta.{vectors, ids, attrs, valid, count, codes}, codes, qstats.lo,
qstats.scale, code_norms, drift, base_mean_size. Quantizer and delta-code
keys may be absent (float32-only index).

`params_from_arrays` does the same for the parameters of
`repro.models.init_model`, flattened to numpy arrays keyed by tree path
("embed/table", "stack/p0/attn/wq" with its leading stack_count axis,
"tail/t0/norm1/scale", "stack/p0/moe/router", "stack/p0/rnn/conv_w",
"stack/p7/cell/r_z", "stack/p0/cross/wk", "enc_stack/p0/mlp/wi/w" with
its leading encoder_layers axis, "enc_pos/table", ...; bfloat16 leaves
may stay `ml_dtypes` bfloat16 or be widened to float32; torch tensors are
taken as they are), and returns the port's Transformer.
`arrays_from_params` is its inverse: the port's model as numpy arrays
under the same tree paths, each period's layers stacked again on the
leading axis. `arrays_from_opt_state` / `opt_state_from_arrays` do the
same for an AdamW state (`train.optim.OptState`): "mu/<path>",
"nu/<path>" and "count". `tensors_from_params` is the torch form that
`storage.checkpoint` writes (bfloat16 kept).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .core.types import DeltaStore, IVFConfig, IVFIndex, QuantStats


def index_from_arrays(arrays: Dict[str, np.ndarray], config: dict,
                      device) -> IVFIndex:
    dev = torch.device(device)

    def t(key, dtype=None):
        a = arrays.get(key)
        if a is None:
            return None
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fields = set(IVFConfig.__dataclass_fields__)
    cfg = IVFConfig(**{k: v for k, v in config.items() if k in fields})
    delta = DeltaStore(
        vectors=t("delta.vectors", np.float32),
        ids=t("delta.ids", np.int32),
        attrs=t("delta.attrs", np.float32),
        valid=t("delta.valid", np.bool_),
        count=int(np.asarray(arrays["delta.count"])),
        codes=t("delta.codes", np.int8))
    qstats = None
    if arrays.get("qstats.lo") is not None:
        qstats = QuantStats(lo=t("qstats.lo", np.float32),
                            scale=t("qstats.scale", np.float32))
    return IVFIndex(
        centroids=t("centroids", np.float32),
        csizes=t("csizes", np.float32),
        vectors=t("vectors", np.float32),
        ids=t("ids", np.int32),
        attrs=t("attrs", np.float32),
        valid=t("valid", np.bool_),
        counts=t("counts", np.int32),
        delta=delta,
        base_mean_size=float(np.asarray(arrays["base_mean_size"])),
        codes=t("codes", np.int8),
        qstats=qstats,
        code_norms=t("code_norms", np.float32),
        drift=t("drift", np.float32),
        config=cfg)


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":      # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_arrays(arrays: Dict[str, np.ndarray], cfg, device):
    """JAX init_model params (flattened by tree path) -> the port's
    Transformer on `device`, each leaf copied into the parameter of the
    same name and shape (cast to the parameter's dtype). Every key must be
    used and every parameter filled."""
    from .models import transformer
    model = transformer.init_model(cfg, abstract=True).to_empty(
        device=torch.device(device))
    sources = {}
    for key, a in arrays.items():
        for name, leaf in port_names(key, a, cfg):
            sources[name] = (key, leaf)
    names = dict(model.named_parameters())
    missing = sorted(set(names) - set(sources))
    extra = sorted(set(sources) - set(names))
    if missing or extra:
        raise ValueError(f"params_from_arrays: parameters without an array "
                         f"{missing}, arrays without a parameter "
                         f"{[sources[n][0] for n in extra]}")
    with torch.no_grad():
        for name, p in names.items():
            key, a = sources[name]
            t = _tensor(a)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)}, the port "
                                 f"expects {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model


def port_names(key: str, a, cfg):
    """(port parameter name, leaf) pairs of one JAX tree-path key: a
    stacked leaf gives one per repeat ("stack/p<j>/..." -> "layers.<r *
    period + j>...", "enc_stack/p0/..." -> "enc_layers.<r>..."), a tail
    leaf "tail/t<j>/..." its layer after the stack, any other the same
    path with dots."""
    parts = key.split("/")
    rest = ".".join(parts[2:])
    period = len(cfg.stack_period)
    if parts[0] == "stack":
        j = int(parts[1][1:])
        return [(f"layers.{r * period + j}.{rest}", a[r])
                for r in range(np.shape(a)[0])]
    if parts[0] == "enc_stack":
        return [(f"enc_layers.{r}.{rest}", a[r])
                for r in range(np.shape(a)[0])]
    if parts[0] == "tail":
        i = cfg.stack_count * period + int(parts[1][1:])
        return [(f"layers.{i}.{rest}", a)]
    return [(".".join(parts), a)]


def reference_key(name: str, cfg) -> Tuple[str, Optional[int]]:
    """The inverse of `port_names` for one port parameter: (its JAX
    tree-path key, its index on that leaf's leading stack axis, or None
    where the leaf is not stacked)."""
    parts = name.split(".")
    rest = "/".join(parts[2:])
    if parts[0] == "layers":
        i, period = int(parts[1]), len(cfg.stack_period)
        n_stack = cfg.stack_count * period
        if i < n_stack:
            return f"stack/p{i % period}/{rest}", i // period
        return f"tail/t{i - n_stack}/{rest}", None
    if parts[0] == "enc_layers":
        return f"enc_stack/p0/{rest}", int(parts[1])
    return "/".join(parts), None


def named_tensors(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def reference_leaves(params, cfg=None):
    """{JAX key: [(stack index or None, port tensor), ...]} of a model or
    a {port name: tensor} dict (an OptState's mu / nu, which need `cfg`),
    each stacked leaf's parts in stack order."""
    cfg = cfg if cfg is not None else params.cfg
    groups: Dict[str, list] = {}
    for name, t in named_tensors(params).items():
        key, r = reference_key(name, cfg)
        groups.setdefault(key, []).append((r, t))
    for parts in groups.values():
        parts.sort(key=lambda rt: -1 if rt[0] is None else rt[0])
    return groups


def host_leaf(parts) -> torch.Tensor:
    """One reference leaf on the host from its parts: a stacked leaf's
    layers stacked on the leading axis, dtypes kept."""
    host = [t.detach().cpu() for _, t in parts]
    return host[0] if parts[0][0] is None else torch.stack(host)


def tensors_from_params(params, cfg=None) -> Dict[str, torch.Tensor]:
    """{JAX key: a CPU tensor} of a model (or a {name: tensor} dict with
    `cfg`), as `storage.checkpoint` writes them."""
    return {key: host_leaf(parts)
            for key, parts in reference_leaves(params, cfg).items()}


def _array(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen it to float32 (exact)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def arrays_from_params(params, cfg=None) -> Dict[str, np.ndarray]:
    """The port's model (or a {name: tensor} dict with `cfg`) as numpy
    arrays under the JAX tree paths, the inverse of params_from_arrays;
    bfloat16 leaves come back widened to float32."""
    return {k: _array(t) for k, t in tensors_from_params(params, cfg).items()}


def arrays_from_opt_state(state, cfg) -> Dict[str, np.ndarray]:
    """An OptState as numpy arrays: "mu/<JAX key>", "nu/<JAX key>" and
    "count" (int32, 0-d)."""
    out = {}
    for field in ("mu", "nu"):
        for k, a in arrays_from_params(getattr(state, field), cfg).items():
            out[f"{field}/{k}"] = a
    out["count"] = np.asarray(state.count.cpu().numpy(), np.int32)
    return out


def _split(arrays: Dict[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """{JAX key: array} -> {port name: tensor (a view of a stacked leaf's
    part)}."""
    return {name: part for key, a in arrays.items()
            for name, part in port_names(key, _tensor(a), cfg)}


def opt_state_from_arrays(arrays: Dict[str, np.ndarray], cfg, device):
    """arrays_from_opt_state's inverse: the OptState on `device`, its
    moments float32 and keyed by port parameter name."""
    from .train.optim import OptState
    dev = torch.device(device)
    fields = {}
    for field in ("mu", "nu"):
        sub = {k[len(field) + 1:]: a for k, a in arrays.items()
               if k.startswith(field + "/")}
        fields[field] = {n: t.to(dev, torch.float32, copy=True)
                         for n, t in _split(sub, cfg).items()}
    count = torch.as_tensor(np.asarray(arrays["count"]), dtype=torch.int32)
    return OptState(mu=fields["mu"], nu=fields["nu"],
                    count=count.reshape(()).to(dev))
