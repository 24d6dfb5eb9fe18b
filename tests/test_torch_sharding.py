"""The port's sharding rules (repro_torch.models.sharding) against the JAX
package's, on the CPU.

The reference needs a real jax Mesh, so it runs once, in a subprocess
with 512 forced host devices (never in this process), and writes every
PartitionSpec it gives:

  * each parameter leaf of every arch's full config, on the meshes
    (1, 8), (2, 4), (16, 16) as (data, model) and (2, 16, 16) as
    (pod, data, model), under that arch's rules (`steps.rules_for`);
  * each batch leaf (`batch_specs`) and each cache leaf (`decode_specs`)
    of every SHAPES entry, on the same meshes;
  * `moe_group_count` inside `activation_sharding` on a grid of
    (sequence length, mesh, rules).

The port computes the same from the mesh's axis sizes alone (a
{name: size} dict, no process group) and must give the same spec for
every leaf, and the DTensor placements that spec means. A stacked
reference leaf ("stack/p<j>/...") carries a leading "layers" axis, which
the rules map to None; each of the port's per-layer leaves carries the
rest. `make_rules` must equal the reference's dict for every flag
combination. Off a mesh the hooks are identities: forward and gradients
are bit for bit with and without the context.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.models import sharding as jsharding
from repro_torch import convert
from repro_torch.configs import SHAPES, arch_names, get_arch
from repro_torch.configs.inputs import batch_specs, decode_specs
from repro_torch.configs.smoke import smoke_config
from repro_torch.launch import steps
from repro_torch.models import init_model, sharding, transformer

MESHES = {"1x8": {"data": 1, "model": 8},
          "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import jax
from repro.configs import SHAPES, arch_names, get_arch
from repro.configs.inputs import batch_specs, decode_specs
from repro.launch import steps
from repro.models import sharding, transformer

MESHES = {"1x8": ((1, 8), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


def is_axes(x):
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


out = {}
for mname, (shape, axes) in MESHES.items():
    n = 1
    for d in shape:
        n *= d
    mesh = jax.sharding.Mesh(
        __import__("numpy").array(jax.devices()[:n]).reshape(shape), axes)
    res = {"params": {}, "batch": {}, "cache": {}, "groups": {}}
    for a in arch_names():
        arch = get_arch(a)
        cfg = arch.config
        rules = steps.rules_for(arch, mesh)
        params, specs = transformer.init_model(cfg, abstract=True)
        flat_s = jax.tree.leaves(specs, is_leaf=is_axes)
        flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
        res["params"][a] = {
            key(p): spec(sharding.logical_to_pspec(ax, leaf.shape, rules,
                                                   mesh))
            for ax, (p, leaf) in zip(flat_s, flat_p)}
        for sname, shp in SHAPES.items():
            b = sharding.batch_shardings(batch_specs(cfg, shp), rules, mesh)
            res["batch"][f"{a}|{sname}"] = {
                key(p): spec(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(b)[0]}
            cache = decode_specs(cfg, shp)["cache"]
            c = sharding.cache_shardings(cache, rules, mesh, cfg)
            res["cache"][f"{a}|{sname}"] = {
                key(p): spec(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(c)[0]}
    for flags in ((True, True), (True, False), (False, True)):
        rules = sharding.make_rules(fsdp=True, multi_pod="pod" in axes,
                                    sp=flags[0], shard_experts=flags[1])
        for seq in (1, 4, 8, 30, 32, 4096):
            with sharding.activation_sharding(mesh, rules):
                res["groups"][f"{flags[0]}|{flags[1]}|{seq}"] = \
                    sharding.moe_group_count(seq)
    out[mname] = res
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE DONE")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharding")
    script = work / "reference.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script),
                           str(work / "ref.json")],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0 and "REFERENCE DONE" in proc.stdout, \
        proc.stderr[-4000:]
    return json.loads((work / "ref.json").read_text())


def _spec(s):
    """A spec as JSON holds it: tuples as lists, 1-tuples unwrapped (the
    reference's batch rule writes the data axes as a tuple)."""
    out = []
    for e in s:
        if isinstance(e, (tuple, list)):
            e = list(e) if len(e) > 1 else e[0]
        out.append(e)
    return out


def _placements(spec, mesh):
    """The DTensor placements a PartitionSpec means, mesh dim by mesh
    dim: Shard(d) where tensor dim d names that mesh axis."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh:
        dims = [d for d, e in enumerate(spec) if e is not None and
                name in (e if isinstance(e, list) else [e])]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = transformer.init_model(get_arch(arch).config,
                                               abstract=True)
    return _MODELS[arch]


def test_make_rules_equals_reference_for_every_flag_combination():
    names = ("fsdp", "multi_pod", "shard_experts", "fsdp_over_pod", "sp")
    for flags in itertools.product((False, True), repeat=len(names)):
        kw = dict(zip(names, flags))
        assert sharding.make_rules(**kw) == jsharding.make_rules(**kw), kw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(arch_names()))
def test_param_placements_equal_reference(reference, arch, mesh):
    ref = reference[mesh]["params"][arch]
    spec_ax = MESHES[mesh]
    model = _model(arch)
    cfg = model.cfg
    rules = steps.rules_for(get_arch(arch), spec_ax)
    specs = sharding.param_pspecs(model, rules, spec_ax)
    places = sharding.param_shardings(model, rules, spec_ax)
    axes = sharding.logical_axes(model)
    assert set(specs) == set(dict(model.named_parameters()))
    seen = set()
    for name, spec in specs.items():
        key, r = convert.reference_key(name, cfg)
        want = ref[key][1:] if r is not None else ref[key]
        if r is not None:
            assert ref[key][0] is None      # "layers" -> replicated
        assert _spec(spec) == _spec(want), (name, spec, want, axes[name])
        assert places[name] == _placements(_spec(want), spec_ax), name
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(arch_names()))
def test_batch_and_cache_placements_equal_reference(reference, arch, mesh):
    spec_ax = MESHES[mesh]
    spec_arch = get_arch(arch)
    cfg = spec_arch.config
    rules = steps.rules_for(spec_arch, spec_ax)
    for sname, shp in SHAPES.items():
        batch = batch_specs(cfg, shp)
        ref_b = reference[mesh]["batch"][f"{arch}|{sname}"]
        got_b = sharding.batch_shardings(batch, rules, spec_ax)
        assert set(ref_b) == set(batch)
        for k, leaf in batch.items():
            want = _spec(ref_b[k])
            assert _spec(sharding.batch_pspec(tuple(leaf.shape), rules,
                                              spec_ax)) == want, (k, sname)
            assert got_b[k] == _placements(want, spec_ax), (k, sname)
        cache = decode_specs(cfg, shp)["cache"]
        ref_c = reference[mesh]["cache"][f"{arch}|{sname}"]
        got_c = sharding.cache_shardings(cache, rules, spec_ax, cfg)
        n = 0
        for top, leaves in cache.items():
            for name, leaf in leaves.items():
                if name in "cnhm" and len(leaves) == 4:      # sLSTM tuple
                    rkey = f"{top}/{'cnhm'.index(name)}"
                else:
                    rkey = f"{top}/{name}"
                want = _spec(ref_c[rkey])
                got = sharding.cache_pspec((top, name), tuple(leaf.shape),
                                           rules, spec_ax, cfg)
                assert _spec(got) == want, (rkey, sname)
                assert got_c[top][name] == _placements(want, spec_ax)
                n += 1
        assert n == len(ref_c)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_group_count_equals_reference(reference, mesh):
    spec_ax = MESHES[mesh]
    for key, want in reference[mesh]["groups"].items():
        sp, experts, seq = key.split("|")
        rules = sharding.make_rules(fsdp=True, multi_pod="pod" in spec_ax,
                                    sp=sp == "True",
                                    shard_experts=experts == "True")
        assert sharding.moe_group_count(int(seq)) == 1      # off a mesh
        with sharding.activation_sharding(spec_ax, rules):
            assert sharding.moe_group_count(int(seq)) == want, key


def test_logical_axes_cover_every_parameter_and_survive_copies():
    """The axes live with their modules: a deep copy and a model moved
    from "meta" keep them."""
    import copy
    cfg = smoke_config(get_arch("phi3.5-moe").config)
    meta = init_model(cfg, abstract=True)
    real = meta.to_empty(device="cpu")
    for m in (meta, real, copy.deepcopy(real)):
        axes = sharding.logical_axes(m)
        assert set(axes) == set(dict(m.named_parameters()))
        assert axes["layers.0.moe.wi"] == ("experts", "embed", "ff")
        assert axes["embed.table"] == ("vocab", "embed")
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), MESHES["2x16x16"])


def _grads(cfg, model, batch):
    total, metrics = transformer.loss_fn(cfg, model, batch, remat=True)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(total, list(model.parameters()))
    return total, dict(zip(names, gs))


@pytest.mark.parametrize("arch", ["phi3.5-moe", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_hooks_off_a_mesh_change_nothing(arch):
    """Plain tensors inside activation_sharding on a (1, 1) mesh -- every
    hook is called, the group count is 1 -- and outside it: the loss and
    every gradient have the same bits, and no op ran replicated."""
    torch.set_num_threads(1)
    cfg = dataclasses.replace(smoke_config(get_arch(arch).config),
                              dtype="float32")
    model = init_model(cfg, 3, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32))}
    sharding.reset_replicated_calls()
    off = _grads(cfg, model, batch)
    rules = steps.rules_for(get_arch(arch), {"data": 1, "model": 1})
    with sharding.activation_sharding({"data": 1, "model": 1}, rules):
        assert sharding.sp_active(16)
        on = _grads(cfg, model, batch)
    assert torch.equal(on[0], off[0])
    for n, g in off[1].items():
        assert torch.equal(on[1][n], g), n
    assert sharding.replicated_calls() == {}
