"""Checkpoint / restore of training state (port of
repro.storage.checkpoint), in the reference's on-disk format.

The protocol is the reference's: write every leaf to `step_N.tmp`, fsync
the manifest, rename to `step_N` (a crashed save never corrupts the
previous checkpoint; `latest_step` sees complete manifests only). The
manifest holds the step, each leaf's file, shape and dtype, and `extra`;
bfloat16 is stored as its uint16 bits.

Leaf keys are the reference's tree paths, so a checkpoint written by
either package restores in the other: a model's parameters under
"<prefix>/embed/table", "<prefix>/stack/p<j>/..." (each period position's
layers stacked on a leading axis, as the reference holds them: the save
stacks them on the host and the restore splits them), an AdamW state's
under "<prefix>/.mu/...", "<prefix>/.nu/..." and "<prefix>/.count" (a
NamedTuple field is spelled ".field", as the reference's path keys
print), dict keys in sorted order, sequence items by index. An OptState
holds its moments by port parameter name and is stacked by the config
of the model in the same tree.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..core.types import resolve_device
from ..models.transformer import Transformer
from ..train.optim import OptState


def _find_cfg(tree):
    """The config of the first model in the tree (None without one)."""
    if isinstance(tree, Transformer):
        return tree.cfg
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, OptState):
        for node in tree:
            cfg = _find_cfg(node)
            if cfg is not None:
                return cfg
    return None


def _leaves(tree, prefix: str, cfg):
    """(JAX key, [(stack index or None, tensor), ...]) for each leaf of the
    reference's flattening of `tree`."""
    if isinstance(tree, Transformer):
        for key, parts in convert.reference_leaves(tree).items():
            yield prefix + key, parts
    elif isinstance(tree, OptState):
        if cfg is None:
            raise ValueError("an OptState is saved and restored beside its "
                             "model, whose config names its leaves")
        for field in ("mu", "nu"):
            for key, parts in convert.reference_leaves(
                    getattr(tree, field), cfg).items():
                yield f"{prefix}.{field}/{key}", parts
        yield prefix + ".count", [(None, tree.count)]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/", cfg)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}.{f}/", cfg)
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            yield from _leaves(node, f"{prefix}{i}/", cfg)
    else:
        yield prefix[:-1], [(None, torch.as_tensor(tree))]


def _leaf_paths(tree) -> Dict[str, list]:
    return dict(_leaves(tree, "", _find_cfg(tree)))


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    tmp = f"{ckpt_dir}/step_{step}.tmp"
    final = f"{ckpt_dir}/step_{step}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, parts in _leaf_paths(tree).items():
        t = convert.host_leaf(parts).contiguous()
        dtype = str(t.dtype).split(".")[-1]
        if t.dtype == torch.bfloat16:   # numpy has no bf16: its bits
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, info: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, info["file"]))
    if info["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _template_device(tree):
    """The device of the template's first tensor that is not "meta"."""
    def devices(node):
        if isinstance(node, torch.nn.Module):
            yield from (p.device for p in node.parameters())
        elif isinstance(node, OptState):
            yield node.count.device
        elif isinstance(node, dict):
            for v in node.values():
                yield from devices(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from devices(v)
        elif isinstance(node, torch.Tensor):
            yield node.device
    return next((d for d in devices(tree) if d.type != "meta"), None)


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int, dict]:
    """Restore into the structure of `template` -> (tree, step, extra).
    A model in the template comes back as a new model of its config, an
    OptState as a new state, other leaves as tensors; all on `device`
    (None: the template's device, or the card where the template holds
    only "meta" tensors). Every leaf is checked against the template's
    shape before anything is placed on the device."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = _find_cfg(template)
    dev = resolve_device(device if device is not None
                         else _template_device(template))

    host: Dict[str, torch.Tensor] = {}
    for key, parts in _leaf_paths(template).items():
        info = manifest["leaves"].get(key)
        if info is None:
            raise ValueError(f"checkpoint missing leaf {key}")
        want = tuple(parts[0][1].shape) if parts[0][0] is None \
            else (len(parts),) + tuple(parts[0][1].shape)
        t = _load(path, info)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: {tuple(t.shape)} vs {want}")
        host[key] = t

    def build(tree, prefix):
        if isinstance(tree, Transformer):
            keys = convert.reference_leaves(tree)
            return convert.params_from_arrays(
                {k: host[prefix + k] for k in keys}, tree.cfg, dev)
        if isinstance(tree, OptState):
            arrays = {"count": host[prefix + ".count"]}
            for field in ("mu", "nu"):
                for k in convert.reference_leaves(getattr(tree, field), cfg):
                    arrays[f"{field}/{k}"] = host[f"{prefix}.{field}/{k}"]
            return convert.opt_state_from_arrays(arrays, cfg, dev)
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(build(getattr(tree, f), f"{prefix}.{f}/")
                                for f in tree._fields))
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(node, f"{prefix}{i}/")
                              for i, node in enumerate(tree))
        return host[prefix[:-1]].to(dev)

    return build(template, ""), manifest["step"], manifest.get("extra", {})
