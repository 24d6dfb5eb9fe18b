"""The port's LM serving path (core/rag, serving/engine, data/tokens,
launch/serve) against the JAX package's.

1. The five cases of tests/test_serving.py, on the port.
2. ServeEngine on the llama3-8b smoke config in float32, with the JAX
   weights carried over (convert.params_from_arrays) and, with RAG, the
   JAX-built datastore index (convert.index_from_arrays): every request's
   tokens equal JAX's. The cache is bfloat16 in both packages.
3. knn_logits, interpolate and rag_decode_logits against JAX: within 1e-5
   on the same neighbours; end to end, the neighbours' ids equal and the
   log-probabilities within temperature x the score tolerance (the scores
   differ by float32 summation order, see repro_torch.testing).
4. The engine's three reference quirks, TokenStream bit for bit,
   delta_live, the datastore recipe and the launcher.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.smoke import smoke_config as j_smoke
from repro.core import delta as jdelta
from repro.core import executor as jexecutor
from repro.core import ivf as jivf
from repro.core import rag as jrag
from repro.core.types import IVFConfig as JConfig
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch.serve import build_rag_datastore as j_build_ds
from repro.models import init_model as jinit_model
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.smoke import smoke_config
from repro_torch.core import delta, executor
from repro_torch.core.rag import (RagConfig, RagDatastore, interpolate,
                                  knn_logits, rag_decode_logits)
from repro_torch.data import synthetic
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import serve
from repro_torch.models import attention, init_cache, init_model, layers
from repro_torch.serving import Request, ServeEngine
from repro_torch.testing import score_tol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_param_arrays(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def jax_index_arrays(idx):
    """Leaves of a JAX IVFIndex as numpy arrays (the convert contract)."""
    out = {name: np.asarray(getattr(idx, name)) for name in
           ("centroids", "csizes", "vectors", "ids", "attrs", "valid",
            "counts", "base_mean_size")}
    for name in ("vectors", "ids", "attrs", "valid", "count", "codes"):
        leaf = getattr(idx.delta, name)
        out[f"delta.{name}"] = None if leaf is None else np.asarray(leaf)
    for name in ("codes", "code_norms", "drift"):
        leaf = getattr(idx, name)
        out[name] = None if leaf is None else np.asarray(leaf)
    if idx.qstats is not None:
        out["qstats.lo"] = np.asarray(idx.qstats.lo)
        out["qstats.scale"] = np.asarray(idx.qstats.scale)
    return out


def _index(jidx):
    return convert.index_from_arrays(
        jax_index_arrays(jidx), dataclasses.asdict(jidx.config), "cpu")


def _cfg(dtype="bfloat16"):
    return (dataclasses.replace(j_smoke(j_get_arch("llama3-8b").config),
                                dtype=dtype),
            dataclasses.replace(smoke_config(get_arch("llama3-8b").config),
                                dtype=dtype))


_CACHE = {}


def _models(dtype="float32"):
    if dtype not in _CACHE:
        jcfg, tcfg = _cfg(dtype)
        params, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
        _CACHE[dtype] = (jcfg, params, tcfg, convert.params_from_arrays(
            jax_param_arrays(params), tcfg, "cpu"))
    return _CACHE[dtype]


def _datastores(d, vocab, n=512, seed=0, same_token=None):
    """(JAX RagDatastore, port RagDatastore) over one JAX-built index."""
    key = ("ds", d, vocab, n, seed, same_token)
    if key not in _CACHE:
        rng = np.random.default_rng(seed)
        vecs = rng.normal(size=(n, d)).astype(np.float32)
        jidx = jivf.build_index(vecs, cfg=JConfig(
            dim=d, target_partition_size=64, kmeans_iters=10,
            delta_capacity=64))
        toks = np.full((n + 1,), same_token, np.int32) if same_token \
            else rng.integers(0, vocab, n + 1).astype(np.int32)
        _CACHE[key] = (
            jrag.RagDatastore(index=jidx, next_token=jnp.asarray(toks)),
            RagDatastore(index=_index(jidx),
                         next_token=torch.from_numpy(toks)), vecs)
    return _CACHE[key]


def _engine(rag_ds=None, slots=2, dtype="bfloat16"):
    """The port's engine as tests/test_serving.py builds JAX's."""
    _, tcfg = _cfg(dtype)
    return tcfg, ServeEngine(tcfg, init_model(tcfg, 0, device="cpu"),
                             slots=slots, s_max=64, rag=rag_ds,
                             device="cpu")


def _drive(eng, reqs, limit=200):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs) and steps < limit:
        eng.step()
        steps += 1
    return steps


# ---------------------------------------------------------------------------
# 1. tests/test_serving.py, on the port
# ---------------------------------------------------------------------------

def test_generates_and_finishes():
    cfg, eng = _engine()
    reqs = [Request(uid=i, prompt=[1, 2, 3], max_new_tokens=4)
            for i in range(3)]
    _drive(eng, reqs, 40)
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)


def test_continuous_batching_reuses_slots():
    cfg, eng = _engine(slots=1)
    reqs = [Request(uid=i, prompt=[5, 6], max_new_tokens=2)
            for i in range(3)]
    _drive(eng, reqs, 60)
    assert all(r.done for r in reqs)   # 3 requests through 1 slot


def test_greedy_decode_deterministic():
    outs = []
    for _ in range(2):
        cfg, eng = _engine()
        r = Request(uid=0, prompt=[7, 8, 9], max_new_tokens=5)
        _drive(eng, [r])
        outs.append(r.out)
    assert outs[0] == outs[1]


def test_rag_interpolation_shifts_logits():
    _, tcfg = _cfg()
    _, ds, vecs = _datastores(tcfg.d_model, tcfg.vocab_size,
                              same_token=42)
    rcfg = RagConfig(k=8, n_probe=4, lam=0.9)
    hidden = torch.from_numpy(vecs[:4])
    out = rag_decode_logits(ds, torch.zeros((4, tcfg.vocab_size)), hidden,
                            rcfg)
    assert (torch.argmax(out, -1) == 42).all()


def test_rag_lambda_zero_is_lm():
    lm = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32))
    knn = torch.full((2, 16), float(np.log(1 / 16.0)))
    out = interpolate(lm, knn, lam=1e-9)
    np.testing.assert_allclose(out.numpy(),
                               torch.log_softmax(lm, -1).numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# 2-3. against JAX
# ---------------------------------------------------------------------------

def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 64, 3 + i % 4))) for i in range(n)]


@pytest.mark.parametrize("with_rag", [False, True], ids=["lm", "rag"])
def test_serve_engine_tokens_equal_jax(with_rag):
    jcfg, params, tcfg, model = _models("float32")
    jds = tds = None
    rcfg = RagConfig(k=8, n_probe=4, lam=0.3)
    if with_rag:
        jds, tds, _ = _datastores(tcfg.d_model, tcfg.vocab_size)
    jeng = JServeEngine(jcfg, params, slots=3, s_max=64, rag=jds,
                        rag_cfg=jrag.RagConfig(k=8, n_probe=4, lam=0.3))
    teng = ServeEngine(tcfg, model, slots=3, s_max=64, rag=tds,
                       rag_cfg=rcfg, device="cpu")
    prompts = _prompts(5)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]
    _drive(jeng, jreqs)
    _drive(teng, treqs)
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert teng.cache["p0"]["k"].dtype == torch.bfloat16


def _fixed_results(monkeypatch, ids, scores):
    """Make both packages' retrieval return these neighbours."""
    def jrun(index, q, spec):
        return types.SimpleNamespace(ids=jnp.asarray(ids),
                                     scores=jnp.asarray(scores))

    def trun(index, q, spec):
        return types.SimpleNamespace(ids=torch.from_numpy(ids),
                                     scores=torch.from_numpy(scores))
    monkeypatch.setattr(jexecutor, "run", jrun)
    monkeypatch.setattr(executor, "run", trun)


def test_knn_logits_on_the_same_neighbours_match_jax(monkeypatch):
    _, tcfg = _cfg()
    jds, tds, vecs = _datastores(tcfg.d_model, tcfg.vocab_size)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, (4, 8)).astype(np.int32)
    ids[1, :3] = ids[1, 3]              # one token met several times
    ids[2, 5:] = -1                     # a short answer
    ids[3, :] = -1                      # an empty one: the uniform guard
    scores = np.sort(rng.random((4, 8)).astype(np.float32), axis=1)
    scores[ids < 0] = np.finfo(np.float32).max
    _fixed_results(monkeypatch, ids, scores)
    rcfg = RagConfig(k=8, n_probe=4, temperature=3.0)
    jcfg_r = jrag.RagConfig(k=8, n_probe=4, temperature=3.0)
    h = vecs[:4]
    jl = jrag.knn_logits(jds, jnp.asarray(h), tcfg.vocab_size, jcfg_r)
    tl = knn_logits(tds, torch.from_numpy(h), tcfg.vocab_size, rcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tl[3].numpy(), np.log(1 / tcfg.vocab_size),
                               rtol=1e-6)
    assert float(tl.min()) == pytest.approx(np.log(1e-20), rel=1e-6)
    lm = rng.normal(size=(4, tcfg.vocab_size)).astype(np.float32)
    for lam in (1e-9, 0.25, 0.9):
        np.testing.assert_allclose(
            interpolate(torch.from_numpy(lm), tl, lam).numpy(),
            np.asarray(jrag.interpolate(jnp.asarray(lm), jl, lam)),
            atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        rag_decode_logits(tds, torch.from_numpy(lm), torch.from_numpy(h),
                          rcfg).numpy(),
        np.asarray(jrag.rag_decode_logits(jds, jnp.asarray(lm),
                                          jnp.asarray(h), jcfg_r)),
        atol=1e-5, rtol=0)


def test_rag_decode_logits_end_to_end_match_jax():
    _, tcfg = _cfg()
    jds, tds, vecs = _datastores(tcfg.d_model, tcfg.vocab_size)
    rng = np.random.default_rng(6)
    h = (vecs[rng.integers(0, 512, 6)]
         + 0.5 * rng.normal(size=(6, tcfg.d_model))).astype(np.float32)
    lm = rng.normal(size=(6, tcfg.vocab_size)).astype(np.float32)
    rcfg, jcfg_r = RagConfig(), jrag.RagConfig()
    jres = jexecutor.run(jds.index, jnp.asarray(h), jcfg_r.spec())
    tres = executor.run(tds.index, h, rcfg.spec())
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    tol = rcfg.temperature * score_tol(h, float((vecs ** 2).sum(1).max()))
    got = rag_decode_logits(tds, torch.from_numpy(lm), torch.from_numpy(h),
                            rcfg).numpy()
    want = np.asarray(jrag.rag_decode_logits(jds, jnp.asarray(lm),
                                             jnp.asarray(h), jcfg_r))
    assert (np.abs(got - want) <= tol[:, None] + 1e-5).all()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ---------------------------------------------------------------------------
# 4. the quirks, tokens, delta_live, the recipe, the launcher
# ---------------------------------------------------------------------------

def test_step_slot_keeps_only_its_slot():
    """_step_slot runs a full-batch decode and keeps slot s's cache only."""
    _, tcfg = _cfg("float32")
    eng = ServeEngine(tcfg, _models("float32")[3], slots=3, s_max=16,
                      device="cpu")
    eng._step_slot(0, 11, 0)
    eng._step_slot(2, 12, 0)
    before = {k: v.clone() for k, v in eng.cache["p0"].items()}
    eng._step_slot(1, 13, 5)
    after = eng.cache["p0"]
    for s in (0, 2):
        for key in ("k", "v", "pos"):
            assert torch.equal(after[key][:, s], before[key][:, s])
    assert (after["pos"][:, 1, 5] == 5).all()
    assert (after["pos"][:, 1, 0] == -1).all()
    assert after["k"][:, 1, 5].abs().sum() > 0


def test_step_shares_one_position_and_run_returns_empty():
    """One pos = max(slot_pos) for the whole batch, and run() returns [],
    both as in the JAX engine (held on its cache)."""
    jcfg, params, tcfg, model = _models("float32")
    jeng = JServeEngine(jcfg, params, slots=2, s_max=32)
    teng = ServeEngine(tcfg, model, slots=2, s_max=32, device="cpu")
    for eng, R in ((jeng, JRequest), (teng, Request)):
        eng.submit(R(uid=0, prompt=[3, 4], max_new_tokens=3))
        eng.submit(R(uid=1, prompt=[5, 6, 7, 8, 9], max_new_tokens=3))
        eng.step()
    # both slots wrote this step's K/V at the ring slot of pos 4 (slot 1's
    # last prompt position); slot 0's own position 1 stays as prefill left
    tpos = teng.cache["p0"]["pos"]
    assert (tpos[:, :, 4] == 4).all()
    np.testing.assert_array_equal(tpos.numpy(),
                                  np.asarray(jeng.cache["p0"]["pos"]))
    np.testing.assert_allclose(
        teng.cache["p0"]["k"].float().numpy(),
        np.asarray(jeng.cache["p0"]["k"], np.float32), atol=2 ** -7,
        rtol=2 ** -7)
    reqs = [Request(uid=i, prompt=[1, 2], max_new_tokens=2)
            for i in range(2, 5)]
    for r in reqs:
        teng.submit(r)
    assert teng.run(max_steps=64) == []
    assert all(r.done and len(r.out) == 2 for r in reqs)


@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (512, 2, 32, 0), (128256, 16, 32, 0), (1000, 3, 64, 7)])
def test_token_stream_matches_jax_bitwise(vocab, batch, seq, seed):
    a = TokenStream(vocab=vocab, batch=batch, seq=seq, seed=seed)
    b = JTokenStream(vocab=vocab, batch=batch, seq=seq, seed=seed)
    for x, y, _ in zip(a.iter_from(3), b.iter_from(3), range(3)):
        assert x["tokens"].dtype == y["tokens"].dtype == np.int32
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_delta_live_matches_jax():
    _, tcfg = _cfg()
    jds, tds, vecs = _datastores(tcfg.d_model, tcfg.vocab_size)
    rng = np.random.default_rng(8)
    new = rng.normal(size=(5, tcfg.d_model)).astype(np.float32)
    ids = np.array([600, 601, 602, 3, 4], np.int32)
    attrs = np.zeros((5, 0), np.float32)
    j2 = jdelta.delete(jdelta.upsert(jds.index, jnp.asarray(new),
                                     jnp.asarray(ids), jnp.asarray(attrs)),
                       jnp.asarray(np.array([601, 3], np.int32)))
    t2 = delta.delete(delta.upsert(tds.index, torch.from_numpy(new),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(attrs)),
                      torch.from_numpy(np.array([601, 3], np.int32)))
    assert delta.delta_live(t2) == jdelta.delta_live(j2) == 3
    assert delta.delta_live(tds.index) == jdelta.delta_live(jds.index) == 0


def test_build_rag_datastore_follows_the_recipe():
    jcfg, tcfg = _cfg()
    jds = j_build_ds(jcfg, n=256, seed=1)
    tds = serve.build_rag_datastore(tcfg, n=256, seed=1, device="cpu")
    np.testing.assert_array_equal(tds.next_token.numpy(),
                                  np.asarray(jds.next_token))
    assert tds.index.config.target_partition_size == 64
    assert tds.index.config.kmeans_iters == 20
    assert tds.index.config.delta_capacity == 256
    for ds in (jds, tds):
        ids = np.asarray(ds.index.ids)[np.asarray(ds.index.valid)]
        assert sorted(ids.tolist()) == list(range(256))
    # the same rows: the port's build over JAX's vectors
    rows = np.asarray(jds.index.vectors)[np.asarray(jds.index.valid)]
    got = tds.index.vectors[tds.index.valid].numpy()
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(rows, axis=0))


def test_serve_launcher_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--rag", "--requests", "3",
                "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "RAG" in out
    assert out.count("done=True") == 3


def test_entry_points_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _cfg()
    model = init_model(tcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_rag_datastore(tcfg, n=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.mixture(8, 4, 2)
    assert synthetic.mixture(8, 4, 2, device="cpu").shape == (8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(tcfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(tcfg, 1, 8)
    spec = attention.KVCacheSpec(8, tcfg.num_kv_heads, tcfg.head_dim)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention.init_kv_cache(1, spec)
    assert attention.init_kv_cache(1, spec, device="cpu")["pos"].shape \
        == (1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.rope_freqs(tcfg.head_dim, tcfg.rope_theta)
    assert layers.rope_freqs(8, 1e4, "cpu").device.type == "cpu"
