"""The port's cost model and dry-run (repro_torch.launch.costs / dryrun)
against the JAX package's, on the CPU.

  * model_flops, slstm_correction and slstm_analytic_flops equal the
    reference's for every arch, shape and chip count (plain arithmetic).
  * The reference runs once, in a subprocess (its dryrun module forces
    512 host devices when imported): its run_cell on llama3-8b's smoke
    config with a (2, 4) mesh in place of the production one, for the
    keys of an ok record, and the argument bytes XLA's memory_analysis
    gives for that train cell ("t", "train", 32, 8).
  * The port runs once, in another subprocess, as rank 0 of fake-backend
    worlds: run_cell and run_micronn records (status "ok", the
    reference's keys), memory_dict's argument bytes for the same cell on a
    (2, 4) world, the collective counter on one gather_fsdp'd weight
    counted by hand, and the traced FLOPs of one single-rank smoke train
    step against the analytic count.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch import costs as jcosts
from repro.models import xlstm as jxlstm
from repro_torch.configs import SHAPES, arch_names, get_arch
from repro_torch.launch import costs
from repro_torch.models import xlstm

REFERENCE = r'''
import dataclasses, json, sys
import numpy as np
from repro.launch import dryrun, steps   # forces 512 host devices
import jax
from repro.configs import SHAPES, get_arch
from repro.configs.base import ShapeConfig
from repro.configs.smoke import smoke_config

mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
arch = get_arch("llama3-8b")
arch = dataclasses.replace(arch, config=smoke_config(arch.config))
lw = steps.train_lowerable(arch, ShapeConfig("t", "train", 32, 8), mesh)
args = steps.lower(lw, mesh).compile().memory_analysis()
dryrun.make_production_mesh = lambda multi_pod=False: mesh
dryrun.get_arch = lambda name: arch
rec = dryrun.run_cell("llama3-8b", "train_4k", False, verbose=False)
json.dump({"argument_bytes": int(args.argument_size_in_bytes),
           "status": rec["status"], "keys": sorted(rec),
           "memory_keys": sorted(rec.get("memory", {})),
           "roofline_keys": sorted(rec.get("roofline", {}))},
          open(sys.argv[1], "w"))
print("REFERENCE DONE")
'''

PORT = r'''
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.smoke import smoke_config
from repro_torch.launch import costs, dryrun, steps
from repro_torch.models import init_model, sharding, transformer
from repro_torch.train import optim, trainer

out = {}
arch = get_arch("llama3-8b")
smoke = dataclasses.replace(arch, config=smoke_config(arch.config))

# memory_dict's argument bytes: the smoke train cell on a (2, 4) world
dryrun.fake_world(8)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
lw = steps.train_lowerable(smoke, ShapeConfig("t", "train", 32, 8), mesh)
out["memory"] = costs.memory_dict(costs.trace(steps.lower(lw, mesh)))

# the collective counter on one gather_fsdp'd weight [64, 32] float32,
# ("embed", "ff") placed (data, model): one all-gather over data of a
# [32, 8] shard, its result [64, 8] = 2,048 bytes
rules = sharding.make_rules(fsdp=True)
w = steps.place(torch.empty(64, 32, device="meta"),
                sharding.placements(sharding.logical_to_pspec(
                    ("embed", "ff"), (64, 32), rules, mesh), mesh), mesh)
with sharding.activation_sharding(mesh, rules):
    with costs.StepCounter() as c:
        g = sharding.gather_fsdp(w, ("embed", "ff"))
out["gather"] = dict(calls=c.coll_calls, bytes=c.coll_bytes,
                     placements=[["S", p.dim] if p.is_shard() else ["R"]
                                 for p in g.placements])

# one single-rank smoke train step on "meta", remat off, float32
cfg = dataclasses.replace(smoke_config(arch.config), dtype="float32",
                          remat=False)
model = init_model(cfg, abstract=True)
step = trainer.make_train_step(cfg, trainer.TrainerConfig(), remat=False)
tok = torch.empty((4, 64), dtype=torch.int32, device="meta")
state = optim.init(model, abstract=True)
step(model, state, {"tokens": tok})        # the same warm-up trace() runs
with costs.StepCounter() as c:
    step(model, state, {"tokens": tok})
out["single"] = dict(flops=c.flops, params={
    n: list(p.shape) for n, p in model.named_parameters()})

# records on the production meshes
dryrun.get_arch = lambda name: smoke
out["cell"] = dryrun.run_cell("llama3-8b", "train_4k", False,
                              verbose=False)
out["cell_multi"] = dryrun.run_cell("llama3-8b", "prefill_32k", True,
                                    verbose=False)
dryrun.get_arch = get_arch
out["micronn"] = dryrun.run_micronn(False, verbose=False)
json.dump(out, open(sys.argv[1], "w"), default=str)
print("PORT DONE")
'''


def _run(tmp_path_factory, name, script, flag):
    work = tmp_path_factory.mktemp(name)
    path = work / f"{name}.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(path), str(work / "o.json")],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0 and flag in proc.stdout, \
        proc.stderr[-4000:]
    return json.loads((work / "o.json").read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run(tmp_path_factory, "reference", REFERENCE, "REFERENCE DONE")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _run(tmp_path_factory, "port", PORT, "PORT DONE")


@pytest.mark.parametrize("name", sorted(arch_names()))
def test_model_flops_and_slstm_terms_equal_reference(name):
    cfg, jcfg = get_arch(name).config, j_get_arch(name).config
    for shape in SHAPES:
        for n_chips in (1, 8, 256, 512):
            args, jargs = (cfg, SHAPES[shape], n_chips), \
                (jcfg, JSHAPES[shape], n_chips)
            assert costs.model_flops(*args) == jcosts.model_flops(*jargs)
            assert costs.slstm_correction(*args) == \
                jcosts.slstm_correction(*jargs)
    for batch, seq in ((1, 1), (256, 4096), (32, 32768)):
        assert xlstm.slstm_analytic_flops(batch, seq, cfg.d_model,
                                          cfg.num_heads) == \
            jxlstm.slstm_analytic_flops(batch, seq, cfg.d_model,
                                        cfg.num_heads)


def test_hardware_constants_are_the_cards():
    assert costs.PEAK_FLOPS == 989e12
    assert costs.HBM_BW == 3.35e12
    assert costs.HBM_BYTES == 80e9


def test_run_cell_record_has_the_reference_keys(reference, port):
    assert reference["status"] == "ok"
    for rec in (port["cell"], port["cell_multi"]):
        assert rec["status"] == "ok", rec.get("traceback")
        assert sorted(rec) == reference["keys"]
        assert sorted(rec["memory"]) == reference["memory_keys"]
        assert sorted(rec["roofline"]) == reference["roofline_keys"]
        assert rec["roofline"]["flops"] > 0 and rec["hbm_ok"]
    assert port["cell"]["mesh"] == "16x16"
    assert port["cell_multi"]["mesh"] == "2x16x16"


def test_run_micronn_traces_the_sharded_search(port):
    rec = port["micronn"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == {"arch", "shape", "mesh", "n_chips", "kind",
                        "status", "compile_s", "memory", "roofline",
                        "hbm_ok"}
    r = rec["roofline"]
    # the probe scores and the scan are products: the trace counts them
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    # the merges move scores and ids between the 16 model ranks
    assert r["coll_bytes"] > 0


def test_argument_bytes_equal_xla_memory_analysis(reference, port):
    """Each rank's local shards of the parameters, both moments, the
    count and the batch, against XLA's argument_size_in_bytes for the
    same cell compiled on a (2, 4) mesh."""
    assert port["memory"]["argument_bytes"] == reference["argument_bytes"]


def test_collective_counter_counts_one_gather_by_hand(port):
    g = port["gather"]
    assert g["calls"] == {"all-reduce": 0, "all-gather": 1,
                          "reduce-scatter": 0, "all-to-all": 0,
                          "collective-permute": 0}
    assert g["bytes"]["all-gather"] == 64 * 8 * 4
    assert sum(g["bytes"].values()) == 64 * 8 * 4
    assert g["placements"] == [["R"], ["S", 1]]     # the FSDP axis gathered


def test_traced_flops_equal_the_analytic_count(port):
    """One float32 step of llama3-8b's smoke config (1 layer, d 128, 4
    heads of 32, 1 KV head, d_ff 256, vocab 512) on 4 x 64 tokens, remat
    off. FlopCounterMode counts products only (no elementwise op), so the
    count is exact: each product's forward 2 m n k, its backward twice
    that (the gradients of both operands; the first projection's input
    gradient feeds the embedding's), over the weight matrices (every
    parameter of rank >= 2 but the embedding table, which is gathered)
    and attention's QK^T and PV (4 B S^2 H hd forward: unmasked blocks,
    the mask is applied to full products). Tolerance: none beyond
    float64 rounding of the sums (1e-12 relative)."""
    s = port["single"]
    b, seq = 4, 64
    n_mat = sum(int(__import__("math").prod(v)) for k, v in
                s["params"].items() if len(v) >= 2 and k != "embed.table")
    cfg = get_arch("llama3-8b").config
    from repro_torch.configs.smoke import smoke_config
    sc = smoke_config(cfg)
    attn = 4 * b * seq * seq * sc.num_heads * sc.head_dim * sc.num_layers
    want = 3 * (2 * n_mat * b * seq + attn)
    assert s["flops"] == pytest.approx(want, rel=1e-12)
