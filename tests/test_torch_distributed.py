"""The port's sharded index (repro_torch.distributed) and its cross-rank
merges (repro_torch.core.topk.tournament_merge / allgather_merge) on gloo,
against the JAX package's single-device search.

One module-scoped subprocess spawns 8 CPU ranks on a (data 2, model 4)
device mesh over a file rendezvous, on the data of tests/test_distributed.py
(2048 x 32, 16 clusters, target_partition_size=64, kmeans_iters=40,
delta_capacity=128; 8 queries, k=10, n_probe=6). The index is the JAX
build, carried over with repro_torch.convert, so both packages search the
same partitions:

  * sharded ids (both merges) equal the JAX single-device ann_search
    (match 1.0) and the port's single-device executor.run, row by row;
  * shard_index gives each model rank its partition range;
  * each refusal raises ValueError by name, `k % m != 0` included;
  * both merges at worlds 2 and 4 equal topk_smallest over the
    concatenation, ties included (the tournament in rank ^ j order, as the
    reference's ppermute merges), and with tie keys equal the keyed top-k
    on every rank; a world of 3 is refused.

The same subprocess first runs the reference's sharded train step
(`launch.steps.train_lowerable`, llama3-8b and phi3.5-moe at their smoke
configs in float32, shape ("t", "train", 32, 8), compiled on 8 forced
host devices as a (2, 4) mesh), then the 8 ranks run the port's step on
the same weights with DTensor parameters and moments: the losses, and the
gathered parameters and moments, agree within the training parity
tolerances, and llama's also with the port's single-device step.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import ivf as jivf
from repro.core import search as jsearch
from repro.core.types import IVFConfig as JConfig
from repro_torch import convert
from repro_torch.core import executor
from repro_torch.core.query import Q
from repro_torch.testing import compare_topk, score_tol
from tests.test_torch_slice import jax_arrays

WORLD, DATA, MODEL = 8, 2, 4
K, N_PROBE = 10, 6

RANKS = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, work):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import convert
    from repro_torch.core import topk
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q
    from repro_torch.distributed import (distributed_query,
                                         distributed_search, shard_index)
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                            world_size=8, rank=rank)
    out = {"rank": rank}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d_rank = mesh.get_local_rank("data")
    m_rank = mesh.get_local_rank("model")
    out["coords"] = [d_rank, m_rank]

    # -- the merges at worlds 2 and 4 (and a refused world of 3) -----------
    _, pairs = dist.new_subgroups(group_size=2)
    groups = {2: [g for g in pairs if rank in dist.get_process_group_ranks(g)][0],
              4: mesh.get_group("model")}
    three = dist.new_group([0, 1, 2])
    merges = {}
    for m, g in groups.items():
        me = dist.get_rank(g)
        rng = np.random.default_rng(100 * m + rank)
        s = np.sort(rng.integers(0, 12, (5, 7)).astype(np.float32), axis=1)
        s[0, 4:] = np.finfo(np.float32).max           # a short buffer
        i = (1000 * rank + np.arange(35).reshape(5, 7)).astype(np.int32)
        i[0, 4:] = -1
        st, it = torch.from_numpy(s), torch.from_numpy(i)
        parts_s = [torch.empty_like(st) for _ in range(m)]
        parts_i = [torch.empty_like(it) for _ in range(m)]
        dist.all_gather(parts_s, st, group=g)
        dist.all_gather(parts_i, it, group=g)
        want_a = topk.topk_smallest(torch.cat(parts_s, -1),
                                    torch.cat(parts_i, -1), 7)
        order = [me ^ j for j in range(m)]
        want_t = topk.topk_smallest(torch.cat([parts_s[j] for j in order], -1),
                                    torch.cat([parts_i[j] for j in order], -1),
                                    7)
        got_a = topk.allgather_merge(st, it, 7, g)
        got_t = topk.tournament_merge(st, it, 7, g)
        # with tie keys (unique, in another order than the ranks'), equal
        # scores order by key: one answer on every rank, either merge
        kt = torch.from_numpy((100_000 - 1000 * rank
                               - np.arange(35).reshape(5, 7)).astype(np.int64))
        parts_k = [torch.empty_like(kt) for _ in range(m)]
        dist.all_gather(parts_k, kt, group=g)
        want_k = topk.topk_smallest_by_key(torch.cat(parts_s, -1),
                                           torch.cat(parts_i, -1),
                                           torch.cat(parts_k, -1), 7)
        keyed = [topk.tournament_merge(st, it, 7, g, keys=kt),
                 topk.allgather_merge(st, it, 7, g, keys=kt)]
        merges[str(m)] = {
            "keyed": all(torch.equal(a, b) for got in keyed
                         for a, b in zip(got, want_k)),
            "keyed_differs_from_rank_order": not torch.equal(want_k[1],
                                                             want_a[1]),
            "allgather": all(torch.equal(a, b) for a, b in zip(got_a, want_a)),
            "tournament": all(torch.equal(a, b)
                              for a, b in zip(got_t, want_t)),
            "tournament_scores_eq_allgather": torch.equal(got_t[0], got_a[0]),
            "ties": bool((torch.cat(parts_s, -1)[:, :, None]
                          == torch.cat(parts_s, -1)[:, None, :]).sum()
                         > 5 * 7 * m)}
    out["merges"] = merges
    if rank in (0, 1, 2):
        try:
            topk.tournament_merge(torch.zeros(1, 2), torch.zeros(
                1, 2, dtype=torch.int32), 2, three)
            out["world3"] = "accepted"
        except ValueError as e:
            out["world3"] = str(e)

    # -- the sharded index (as built, and after writes into the delta) ------
    cfg = json.load(open(f"{work}/config.json"))
    queries = np.load(f"{work}/queries.npy")
    q = queries[4 * d_rank:4 * d_rank + 4]
    out["shard"] = {}
    for variant in ("built", "writes"):
        arrays = dict(np.load(f"{work}/index_{variant}.npz"))
        idx = convert.index_from_arrays(arrays, cfg, "cpu")
        shard = shard_index(idx, mesh)
        kl = idx.k // 4
        lo = m_rank * kl
        out["shard"][variant] = {
            "k": shard.k, "k_global": idx.k,
            "centroids": torch.equal(shard.centroids,
                                     idx.centroids[lo:lo + kl]),
            "vectors": torch.equal(shard.vectors, idx.vectors[lo:lo + kl]),
            "ids": torch.equal(shard.ids, idx.ids[lo:lo + kl]),
            "valid": torch.equal(shard.valid, idx.valid[lo:lo + kl]),
            "counts": torch.equal(shard.counts, idx.counts[lo:lo + kl]),
            "delta": torch.equal(shard.delta.vectors, idx.delta.vectors)
            and shard.delta.count == idx.delta.count}
        for merge in ("tournament", "allgather"):
            rs = distributed_query(shard, q, Q.knn(k=10, n_probe=6), mesh,
                                   merge=merge)
            ids, scores = rs.to_numpy()
            np.save(f"{work}/ids_{rank}_{variant}_{merge}.npy", ids)
            np.save(f"{work}/scores_{rank}_{variant}_{merge}.npy", scores)
        # the kwarg shim with a batch-sized local cap gives the same answers
        rs = distributed_search(shard, q, 10, 6, mesh, local_cap=kl)
        np.save(f"{work}/ids_{rank}_{variant}_shim.npy", rs.to_numpy()[0])

    # -- refusals: each raised before any collective --------------------------
    if rank == 0:
        refused = {}
        cases = {
            "exact": (Q.exact(k=10), {}),
            "predicate": (Q.knn(k=10).where(Pred(0, "==", 1.0)), {}),
            "union_cap": (Q.knn(k=10).union_cap(4), {}),
            "prefilter": (Q.knn(k=10).prefilter(64), {}),
            "quantized": (Q.knn(k=10).quantized(True), {}),
            "backend": (Q.knn(k=10).backend("cuda"), {}),
            "merge": (Q.knn(k=10), {"merge": "ring"}),
            "axis": (Q.knn(k=10), {"model_axis": "tensor"})}
        for name, (spec, kw) in cases.items():
            try:
                distributed_query(shard, q, spec, mesh, **kw)
                refused[name] = "accepted"
            except ValueError as e:
                refused[name] = str(e)
        odd = dataclasses.replace(idx, centroids=idx.centroids[:-1])
        try:
            shard_index(odd, mesh)
            refused["k_mod_m"] = "accepted"
        except ValueError as e:
            refused["k_mod_m"] = str(e)
        out["refused"] = refused
    out["staged"] = topk.host_staging()
    out["train"] = train(rank, work, mesh)
    with open(f"{work}/out_{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


TRAIN_ARCHS = ("llama3-8b", "phi3.5-moe")


def smoke_f32(cfg):
    from repro_torch.configs.smoke import smoke_config
    base = smoke_config(cfg)
    extra = dict(capacity_factor=float(base.n_experts)) \
        if base.n_experts else {}
    return dataclasses.replace(base, dtype="float32", remat=False, **extra)


def train(rank, work, mesh):
    """The port's sharded train step (launch.steps) on the JAX weights:
    rank 0 writes the loss and the gathered parameters and moments."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.train import optim
    out = {}
    tok = torch.from_numpy(np.load(f"{work}/train_tokens.npy"))
    for name in TRAIN_ARCHS:
        arch = get_arch(name)
        cfg = smoke_f32(arch.config)
        arch = dataclasses.replace(arch, config=cfg)
        model = convert.params_from_arrays(
            dict(np.load(f"{work}/train_w_{name}.npz")), cfg, "cpu")
        lw = steps.train_lowerable(arch, ShapeConfig("t", "train", 32, 8),
                                   mesh)
        low = steps.lower(lw, mesh, (model, optim.init(model),
                                     {"tokens": tok}))
        placed = {n: list(map(str, p.placements))
                  for n, p in model.named_parameters()}
        want = {n: list(map(str, pl)) for n, pl in lw.in_shardings[0].items()}
        sharding.reset_replicated_calls()
        params, state, metrics = low()
        full = {n: p.full_tensor() for n, p in params.named_parameters()}
        mu = {n: t.full_tensor() for n, t in state.mu.items()}
        nu = {n: t.full_tensor() for n, t in state.nu.items()}
        loss = metrics["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        if rank == 0:
            arrays = convert.arrays_from_params(full, cfg)
            arrays.update({f"mu/{k}": a for k, a in
                           convert.arrays_from_params(mu, cfg).items()})
            arrays.update({f"nu/{k}": a for k, a in
                           convert.arrays_from_params(nu, cfg).items()})
            np.savez(f"{work}/train_port_{name}.npz", **arrays)
        out[name] = {"loss": float(loss), "placed_as_rules": placed == want,
                     "replicated": sharding.replicated_calls(),
                     "count": int(state.count)}
    return out


def reference_train(work):
    """The JAX package's train_lowerable step on 8 forced host devices, a
    (2, 4) mesh, as tests/test_distributed.py runs it, but compiled with
    its in-shardings under the mesh and its activation-sharding rules:
    writes the JAX weights, the loss and the updated leaves."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.configs.smoke import smoke_config
    from repro.launch import steps
    from repro.models import init_model
    from repro.train import optim
    assert jax.device_count() == 8
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def flat(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    tok = np.random.default_rng(11).integers(1, 512, (8, 32)).astype(np.int32)
    np.save(f"{work}/train_tokens.npy", tok)
    losses = {}
    for name in TRAIN_ARCHS:
        arch = get_arch(name)
        base = smoke_config(arch.config)
        extra = dict(capacity_factor=float(base.n_experts)) \
            if base.n_experts else {}
        cfg = dataclasses.replace(base, dtype="float32", remat=False,
                                  **extra)
        arch = dataclasses.replace(arch, config=cfg)
        params, _ = init_model(cfg, jax.random.PRNGKey(1))
        np.savez(f"{work}/train_w_{name}.npz", **flat(params))
        lw = steps.train_lowerable(arch, ShapeConfig("t", "train", 32, 8),
                                   mesh, scan=False)
        args = jax.device_put((params, optim.init(params),
                               {"tokens": jnp.asarray(tok)}),
                              lw.in_shardings)
        p2, o2, m = steps.lower(lw, mesh).compile()(*args)
        arrays = flat(p2)
        arrays.update({f"mu/{k}": a for k, a in flat(o2.mu).items()})
        arrays.update({f"nu/{k}": a for k, a in flat(o2.nu).items()})
        np.savez(f"{work}/train_ref_{name}.npz", **arrays)
        losses[name] = float(m["loss"])
    json.dump(losses, open(f"{work}/train_ref_loss.json", "w"))


if __name__ == "__main__":
    reference_train(sys.argv[1])
    mp.spawn(worker, args=(sys.argv[1],), nprocs=8, join=True)
    print("RANKS DONE")
'''


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 32)) * 5
    X = (centers[rng.integers(0, 16, 2048)]
         + rng.normal(size=(2048, 32))).astype(np.float32)
    cfg = JConfig(dim=32, target_partition_size=64, kmeans_iters=40,
                  delta_capacity=128)
    jidx = jivf.build_index(X, cfg=cfg)
    queries = (X[:8] + 0.05 * rng.normal(size=(8, 32))).astype(np.float32)
    # writes: 4 fresh rows near the queries, 2 overwrites and a delete,
    # so the delta (scored on model rank 0 only) holds live rows
    new_ids = np.array([5000, 5001, 5002, 5003, 7, 700], np.int32)
    vecs = np.concatenate([queries[:4] + 0.01, X[[100, 200]]]).astype(
        np.float32)
    jw = jdelta.delete(
        jdelta.upsert(jidx, jnp.asarray(vecs), jnp.asarray(new_ids),
                      jnp.zeros((6, 0), jnp.float32)),
        jnp.asarray(np.array([5001, 11], np.int32)))
    jidx_by = {"built": jidx, "writes": jw}
    for variant, j in jidx_by.items():
        np.savez(work / f"index_{variant}.npz",
                 **{k: v for k, v in jax_arrays(j).items() if v is not None})
    (work / "config.json").write_text(
        json.dumps(dataclasses.asdict(jidx.config)))
    np.save(work / "queries.npy", queries)
    script = work / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(work)],
                          capture_output=True, text=True, timeout=240,
                          env=env)
    assert proc.returncode == 0 and "RANKS DONE" in proc.stdout, \
        proc.stderr[-4000:]
    outs = [json.loads((work / f"out_{r}.json").read_text())
            for r in range(WORLD)]
    jref, tref = {}, {}
    for variant, j in jidx_by.items():
        jref[variant] = jsearch.ann_search(j, jnp.asarray(queries), K,
                                           n_probe=N_PROBE)
        tidx = convert.index_from_arrays(
            jax_arrays(j), dataclasses.asdict(j.config), "cpu")
        tref[variant] = executor.run(tidx, queries,
                                     Q.knn(k=K, n_probe=N_PROBE))
    return dict(work=work, outs=outs, X=np.concatenate([X, vecs]),
                queries=queries, jref=jref, tref=tref, k=int(tidx.k))


def _gathered(sharded, model_rank, variant, tag):
    """The 8 queries' answers as model rank `model_rank` of each data group
    holds them (rank = 4 * data + model)."""
    work = sharded["work"]

    def load(kind):
        return np.concatenate([np.load(
            work / f"{kind}_{4 * d + model_rank}_{variant}_{tag}.npy")
            for d in range(DATA)])
    return load("ids"), None if tag == "shim" else load("scores")


VARIANTS = ["built", "writes"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("merge", ["tournament", "allgather"])
def test_sharded_ids_equal_jax_single_device(sharded, variant, merge):
    jids = np.asarray(sharded["jref"][variant].ids)
    for m in range(MODEL):
        ids, _ = _gathered(sharded, m, variant, merge)
        assert ids.shape == jids.shape
        assert float((ids == jids).mean()) == 1.0, (m, merge)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("merge", ["tournament", "allgather", "shim"])
def test_sharded_equals_port_single_device(sharded, variant, merge):
    t_ids, t_scores = sharded["tref"][variant].to_numpy()
    v2 = float(np.sum(sharded["X"] ** 2, -1).max())
    for m in range(MODEL):
        ids, scores = _gathered(sharded, m, variant, merge)
        np.testing.assert_array_equal(ids, t_ids)
        if scores is not None:
            err, ok, bad = compare_topk(t_scores, t_ids, scores, ids,
                                        score_tol(sharded["queries"], v2))
            assert ok, f"{bad} rows differ (max score err {err:.3e})"


@pytest.mark.parametrize("variant", VARIANTS)
def test_shard_index_partition_ranges(sharded, variant):
    k = sharded["k"]
    assert k % MODEL == 0
    for r, out in enumerate(sharded["outs"]):
        assert out["coords"] == [r // MODEL, r % MODEL]
        sh = out["shard"][variant]
        assert sh["k"] == k // MODEL and sh["k_global"] == k
        assert all(sh[f] for f in ("centroids", "vectors", "ids", "valid",
                                   "counts", "delta")), sh
        assert out["staged"]["calls"] == 0      # CPU tensors: no staging


@pytest.mark.parametrize("case,needle", [
    ("exact", "ANN"), ("predicate", "predicate"),
    ("union_cap", "union_cap"), ("prefilter", "prefilter"),
    ("quantized", "float32"), ("backend", "backend"), ("merge", "merge"),
    ("axis", "tensor"), ("k_mod_m", "evenly")])
def test_sharded_refusals_by_name(sharded, case, needle):
    msg = sharded["outs"][0]["refused"][case]
    assert msg != "accepted" and needle in msg, msg


@pytest.mark.parametrize("world", ["2", "4"])
@pytest.mark.parametrize("merge", ["tournament", "allgather", "keyed"])
def test_merges_equal_topk_of_concatenation(sharded, world, merge):
    for out in sharded["outs"]:
        m = out["merges"][world]
        assert m["ties"]                  # the buffers do hold ties
        assert m[merge], (out["rank"], world, merge)
        assert m["tournament_scores_eq_allgather"]
        assert m["keyed_differs_from_rank_order"]


def test_tournament_refuses_a_world_of_three(sharded):
    for r in (0, 1, 2):
        msg = sharded["outs"][r]["world3"]
        assert "power-of-two" in msg, msg


def test_host_staging_helper_counts_and_logs(caplog):
    """The one route by which a buffer crosses a gloo group through host
    memory: it runs the collective on host copies, returns its outputs on
    the buffers' device, counts every call and logs its first use."""
    from repro_torch.core import topk
    topk.reset_host_staging()
    logged0 = topk._LOGGED
    topk._LOGGED = False
    try:
        with caplog.at_level("WARNING", logger="repro_torch.core.topk"):
            out = topk._through_host(lambda ts: [t * 2 for t in ts],
                                     [torch.ones(3), torch.arange(4)])
            topk._through_host(lambda ts: ts, [torch.zeros(2)])
        assert torch.equal(out[0], torch.full((3,), 2.0))
        assert torch.equal(out[1], torch.arange(4) * 2)
        st = topk.host_staging()
        assert st["calls"] == 2 and st["bytes"] == 12 + 32 + 8
        assert st["seconds"] >= 0.0
        assert sum("through host memory" in r.message
                   for r in caplog.records) == 1
    finally:
        topk._LOGGED = logged0
        topk.reset_host_staging()


# ---------------------------------------------------------------------------
# the sharded train step (launch.steps) against the reference's
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("llama3-8b", "phi3.5-moe")
LR_1 = 3e-4 / 100          # AdamWConfig's learning rate at count 1


def _train_leaves(sharded, kind, name):
    return dict(np.load(sharded["work"] / f"train_{kind}_{name}.npz"))


def _assert_step_close(got, want, tag):
    """Parameters and moments after one AdamW step, leaf by leaf, within
    the training parity tolerances (test_torch_train.py): gradients agree
    within 1e-4 x each leaf's max |g|, so mu = 0.1 g within 1e-4 x max
    |mu| and nu = 0.05 g^2 within 2e-4 x max |nu|; parameters within
    1e-6 x max |p| (test_update_matches_jax_leaf_by_leaf), except where
    the gradient is within that tolerance of zero: there the first step's
    g / |g| may take either sign, moving a parameter by up to 2 lr."""
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        b = got[key]
        top = float(np.abs(a).max())
        if key.startswith("mu/"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * top,
                                       err_msg=f"{tag} {key}")
        elif key.startswith("nu/"):
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * top,
                                       err_msg=f"{tag} {key}")
        else:
            mu = want[f"mu/{key}"]
            loose = np.abs(mu) <= 1e-4 * np.abs(mu).max()
            atol = 1e-6 * top + np.where(loose, 2 * LR_1, 0.0)
            assert np.all(np.abs(b - a) <= atol), \
                (tag, key, float(np.abs(b - a).max()))


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_sharded_train_step_matches_reference(sharded, name):
    """One train_lowerable step on the (2, 4) mesh: the port's DTensor
    step against the reference's compiled on 8 host devices under the
    same rules (FSDP over data, TP and SP over model; phi3.5-moe's routing
    in 4 groups, one per sequence shard)."""
    ref_loss = json.loads((sharded["work"] / "train_ref_loss.json")
                          .read_text())[name]
    for out in sharded["outs"]:
        tr = out["train"][name]
        np.testing.assert_allclose(tr["loss"], ref_loss, rtol=1e-5)
        assert tr["count"] == 1
    _assert_step_close(_train_leaves(sharded, "port", name),
                       _train_leaves(sharded, "ref", name), name)


def test_sharded_llama_step_matches_single_device(sharded):
    """The same step on one device (no mesh, no hooks)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.train import optim, trainer
    base = smoke_config(get_arch("llama3-8b").config)
    cfg = dataclasses.replace(base, dtype="float32", remat=False)
    model = convert.params_from_arrays(
        _train_leaves(sharded, "w", "llama3-8b"), cfg, "cpu")
    tok = torch.from_numpy(np.load(sharded["work"] / "train_tokens.npy"))
    step = trainer.make_train_step(cfg, trainer.TrainerConfig(), remat=True)
    model, state, m = step(model, optim.init(model), {"tokens": tok})
    single = convert.arrays_from_params(model)
    for field in ("mu", "nu"):
        single.update({f"{field}/{k}": a for k, a in
                       convert.arrays_from_params(getattr(state, field),
                                                  cfg).items()})
    for out in sharded["outs"]:
        np.testing.assert_allclose(out["train"]["llama3-8b"]["loss"],
                                   float(m["loss"]), rtol=1e-5)
    _assert_step_close(_train_leaves(sharded, "port", "llama3-8b"), single,
                       "single")


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_sharded_step_places_and_falls_back_by_name(sharded, name):
    """Every parameter is a DTensor under its rule placements, and the
    only ops that ran replicated are the MoE sort dispatch and combine,
    once per MoE layer, each counted by name."""
    from repro_torch.configs import get_arch
    layers = 2
    for out in sharded["outs"]:
        tr = out["train"][name]
        assert tr["placed_as_rules"]
        if get_arch(name).config.n_experts:
            assert tr["replicated"] == {"moe dispatch": layers,
                                        "moe combine": layers}
        else:
            assert tr["replicated"] == {}
