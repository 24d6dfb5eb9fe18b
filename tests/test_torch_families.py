"""The port's other four model families against the JAX package's:
mixture-of-experts (phi3.5-moe, grok-1), RG-LRU (recurrentgemma), xLSTM
(xlstm-350m) and whisper's encoder-decoder.

1. Each module on numpy-seeded inputs, against its JAX function with the
   same weights: `moe` (outputs, aux; the routes, slots and `keep` of the
   dispatch exactly), `rglru_block` / `rglru_decode`, `mlstm_block` /
   `mlstm_block_chunked` / `mlstm_decode`, `slstm_block` /
   `slstm_decode`, the encoder, cross-attention, and the prefill states.
2. `configs.inputs`: input_specs' shapes and dtypes equal JAX's for all
   ten archs; materialize's values follow the reference's rules.
3. The MoE top-k tie rule, a combine with the same bits over repeated
   runs and under a permuted batch, and forward at the default capacity
   (with drops) against JAX.
4. ServeEngine tokens equal JAX's in float32 for the four archs without
   tail layers, with and without RAG; recurrentgemma's tail: the JAX
   engine's `_step_slot` writes column s of every slot's tail state (a
   reference defect), the port's engine equals a loop over JAX's
   decode_step that keeps each slot's own state.
5. The launcher serves every family on the CPU.

Tolerances: float32 models atol 1e-4, rtol 1e-4, float32 modules atol
1e-5 x max(1, max |reference|), rtol 1e-5 (sums in other orders);
bfloat16 atol 0.15, rtol 0.1, for modules at least 2^-6 x max
|reference| (4 bfloat16 roundings of the largest value). Module
tolerances scale because the MoE's outputs reach ~400: the reference
draws expert weights with fan-in n_experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.inputs import input_specs as j_input_specs
from repro.configs.smoke import SMOKE_DECODE as J_SMOKE_DECODE
from repro.configs.smoke import SMOKE_SHAPE as J_SMOKE_SHAPE
from repro.configs.smoke import smoke_config as j_smoke
from repro.core import ivf as jivf
from repro.core import rag as jrag
from repro.core.types import IVFConfig as JConfig
from repro.models import attention as jattn
from repro.models import decode as jdecode
from repro.models import forward as _jforward
from repro.models import init_model as jinit_model
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.models.layers import InitCtx as JCtx
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.inputs import input_specs, materialize
from repro_torch.configs.smoke import SMOKE_DECODE, SMOKE_SHAPE, smoke_config
from repro_torch.core.rag import RagConfig, RagDatastore
from repro_torch.launch import serve
from repro_torch.models import (attention, forward, init_model, layers, moe,
                                recurrent, transformer, xlstm)
from repro_torch.serving import Request, ServeEngine

ALL = ["llama3-8b", "gemma2-27b", "starcoder2-15b", "minitron-4b",
       "pixtral-12b", "phi3.5-moe", "grok-1-314b", "recurrentgemma-2b",
       "xlstm-350m", "whisper-medium"]
FAMILIES = ["phi3.5-moe", "grok-1-314b", "recurrentgemma-2b", "xlstm-350m",
            "whisper-medium"]
TAIL_FREE = ["phi3.5-moe", "grok-1-314b", "xlstm-350m", "whisper-medium"]
D = 128                                         # the smoke width

jforward = jax.jit(_jforward, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_autograd():
    """The model's parameters are trainable; these parity runs of the
    inference paths record no autograd graph, as the serving callers
    do."""
    with torch.no_grad():
        yield


DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype, module=True):
    if dtype == "bfloat16":
        return dict(atol=0.15, rtol=0.1)
    return dict(atol=1e-5, rtol=1e-5) if module else dict(atol=1e-4,
                                                          rtol=1e-4)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(j, t, dtype, what, module=True):
    tol = _tol(dtype, module)
    if module:          # a module's rounding error grows with its scale
        top = float(np.abs(_np(j)).max())
        tol["atol"] = max(tol["atol"], (1e-5 if dtype == "float32"
                                        else 2 ** -6) * top)
    np.testing.assert_allclose(_np(t), _np(j), err_msg=what, **tol)


def _j(fn, static=()):
    """The JAX function jitted: far fewer XLA compiles than op by op."""
    return jax.jit(fn, static_argnums=static)


def _load(tmod, jparams):
    """The port module `tmod` (built abstract) with the JAX leaves of the
    same dotted names."""
    tmod = tmod.to_empty(device="cpu")
    with torch.no_grad():
        for name, t in tmod.named_parameters():
            a = jparams
            for part in name.split("."):
                a = a[part]
            t.copy_(convert._tensor(np.asarray(a)).to(t.dtype))
    return tmod


def _pair_module(jinit, tinit, dtype, *args, seed=0, **kw):
    jdt, tdt = DT[dtype]
    jp, _ = jinit(JCtx(jax.random.PRNGKey(seed), jdt), *args, **kw)
    tp = _load(tinit(layers.InitCtx(None, tdt, abstract=True), *args, **kw),
               jp)
    return jp, tp


def _x(shape, dtype, seed=0, scale=1.0):
    x = (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)
    jdt, tdt = DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# ---------------------------------------------------------------------------
# 1. modules
# ---------------------------------------------------------------------------

MOE = {"phi3.5-moe": (4, "silu_glu"), "grok-1-314b": (4, "gelu_glu")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_matches_jax(name, dtype):
    """Outputs and aux within the tolerance; each row's routes (the top-2
    experts), slots, token order and `keep` exactly, with drops: 3 rows of
    16 tokens at capacity_factor 1.25 (cap 10 of 32 choices over 4
    experts)."""
    e, act = MOE[name]
    jp, tp = _pair_module(jmoe.init_moe, moe.init_moe, dtype, D, 256, e,
                          act)
    jx, tx = _x((3, 16, D), dtype, seed=1)
    jy, jaux = _j(lambda p, x: jmoe.moe(p, x, top_k=2, capacity_factor=1.25,
                                        act=act))(jp, jx)
    ty, taux = moe.moe(tp, tx, top_k=2, capacity_factor=1.25, act=act)
    _close(jy, ty, dtype, f"{name} moe output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    cap = int(max(1, round(16 * 2 / e * 1.25)))
    jd = _j(jax.vmap(lambda r: jmoe._dispatch_row(r, jp["router"], 2,
                                                  cap)))(jx)
    td = moe._dispatch(tx, tp.router, 2, cap)
    xe, slot, keep, gates, st, aux = (np.asarray(a) for a in jd)
    np.testing.assert_array_equal(td[1].numpy(), slot)
    np.testing.assert_array_equal(td[2].numpy(), keep)
    np.testing.assert_array_equal((td[4] // 2).numpy(), st)
    np.testing.assert_allclose(td[3].numpy(), gates, rtol=1e-6)
    _close(xe, td[0], dtype, f"{name} dispatched rows")
    np.testing.assert_allclose(td[5].numpy(), aux, rtol=1e-5)
    assert not keep.all() and keep.any()       # the drop path ran
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1)
    np.testing.assert_array_equal(moe.route(tx, tp.router, 2)[2].numpy(),
                                  np.asarray(jax.lax.top_k(probs, 2)[1]))


def test_moe_ties_take_the_lower_expert_first():
    """Equal probabilities rank the lower expert index first, as
    `lax.top_k` does: experts 1 and 2 share a router column, so each is
    tied with the other at every token."""
    rng = np.random.default_rng(2)
    router = rng.normal(size=(D, 4)).astype(np.float32)
    router[:, 2] = router[:, 1]
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    _, _, idx = moe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    want = np.asarray(jax.lax.top_k(probs, 2)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    both = (want == 1).any(-1) & (want == 2).any(-1)
    assert both.any()
    assert (idx.numpy()[both] == [1, 2]).all()


def test_moe_combine_is_deterministic():
    """The same bits over repeated runs, and each row's output unchanged
    when the batch's rows are permuted (no scatter-add in the combine)."""
    _, tp = _pair_module(jmoe.init_moe, moe.init_moe, "float32", D, 256, 4,
                         "silu_glu")
    _, tx = _x((5, 16, D), "float32", seed=3)
    y0, a0 = moe.moe(tp, tx)
    for _ in range(3):
        y, a = moe.moe(tp, tx)
        assert torch.equal(y, y0) and torch.equal(a, a0)
    perm = torch.tensor([3, 0, 4, 2, 1])
    assert torch.equal(moe.moe(tp, tx[perm])[0], y0[perm])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_matches_jax(dtype):
    """The full-sequence block (bf16 u in its conv), 6 decode steps
    (float32 u) with their states, and prefill's final state."""
    jp, tp = _pair_module(jrec.init_rglru_block, recurrent.init_rglru_block,
                          dtype, D, D, 4)
    with torch.no_grad():                      # non-zero biases
        for name in ("conv_b", "ba", "bi"):
            getattr(tp, name).add_(0.1)
    jp = dict(jp, **{n: jp[n] + 0.1 for n in ("conv_b", "ba", "bi")})
    jx, tx = _x((2, 6, D), dtype, seed=4)
    _close(_j(jrec.rglru_block)(jp, jx),
           recurrent.rglru_block(tp, tx), dtype, "rglru_block")
    js = jrec.init_rglru_state(2, D)
    ts = recurrent.init_rglru_state(2, D, device="cpu")
    jdec = _j(jrec.rglru_decode)
    for t in range(6):
        jo, js = jdec(jp, jx[:, t:t + 1], js)
        to, ts = recurrent.rglru_decode(tp, tx[:, t:t + 1], ts)
        _close(jo, to, dtype, f"rglru_decode out {t}")
        for k in ("h", "conv"):
            _close(js[k], ts[k], "float32" if dtype == "float32" else dtype,
                   f"rglru_decode {k} {t}")
        assert ts[k].dtype == torch.float32
    jf = _j(jdecode._rglru_final_state)(jp, jx)
    tf = recurrent.rglru_final_state(tp, tx)
    for k in ("h", "conv"):
        _close(jf[k], tf[k], dtype, f"rglru final {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_matches_jax(dtype):
    """The quadratic and chunked forms (chunks of 8 and 4), 8 decode steps
    with their (C, n, m), prefill's final state, and the chunk check."""
    jp, tp = _pair_module(jxlstm.init_mlstm_block, xlstm.init_mlstm_block,
                          dtype, D, 4)
    jx, tx = _x((2, 16, D), dtype, seed=5, scale=0.5)
    _close(_j(jxlstm.mlstm_block)(jp, jx), xlstm.mlstm_block(tp, tx),
           dtype, "mlstm_block")
    for chunk in (8, 4):
        _close(_j(jxlstm.mlstm_block_chunked, (2,))(jp, jx, chunk),
               xlstm.mlstm_block_chunked(tp, tx, chunk), dtype,
               f"mlstm_block_chunked {chunk}")
    with pytest.raises(ValueError, match="not divisible"):
        xlstm.mlstm_block_chunked(tp, tx, 6)
    js = jxlstm.init_mlstm_state(2, D, 4)
    ts = xlstm.init_mlstm_state(2, D, 4, device="cpu")
    assert float(ts["m"].abs().max()) == 0.0
    jdec = _j(jxlstm.mlstm_decode)
    for t in range(8):
        jo, js = jdec(jp, jx[:, t:t + 1], js)
        to, ts = xlstm.mlstm_decode(tp, tx[:, t:t + 1], ts)
        _close(jo, to, dtype, f"mlstm_decode out {t}")
        for k in ("C", "n", "m"):
            _close(js[k], ts[k], dtype, f"mlstm_decode {k} {t}")
    jf = _j(jdecode._mlstm_final_state, (2,))(jp, jx, None)
    tf = xlstm.mlstm_final_state(tp, tx)
    for k in ("C", "n", "m"):
        _close(jf[k], tf[k], dtype, f"mlstm final {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_matches_jax(dtype):
    """The block (a time loop from zeros), 6 decode steps with their
    state, the reference's tuple (c, n, h, m) against the port's names."""
    jp, tp = _pair_module(jxlstm.init_slstm_block, xlstm.init_slstm_block,
                          dtype, D, 4)
    jx, tx = _x((2, 6, D), dtype, seed=6)
    _close(_j(jxlstm.slstm_block, (2,))(jp, jx, 4),
           xlstm.slstm_block(tp, tx, 4), dtype, "slstm_block")
    js = jxlstm.init_slstm_state(2, D, 4)
    ts = xlstm.init_slstm_state(2, D, 4, device="cpu")
    assert [tuple(a.shape) for a in js] == \
        [tuple(ts[k].shape) for k in "cnhm"]
    jdec = _j(jxlstm.slstm_decode, (3,))
    for t in range(6):
        jo, js = jdec(jp, jx[:, t:t + 1], js, 4)
        to, ts = xlstm.slstm_decode(tp, tx[:, t:t + 1], ts, 4)
        _close(jo, to, dtype, f"slstm_decode out {t}")
        for a, k in zip(js, "cnhm"):
            _close(a, ts[k], dtype, f"slstm_decode {k} {t}")


def _pair_model(name, dtype="float32", seed=1, **over):
    jcfg = dataclasses.replace(j_smoke(j_get_arch(name).config),
                               dtype=dtype, **over)
    tcfg = dataclasses.replace(smoke_config(get_arch(name).config),
                               dtype=dtype, **over)
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(seed))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {"/".join(str(k.key) for k in path): np.asarray(leaf)
              for path, leaf in leaves}
    return jcfg, params, tcfg, convert.params_from_arrays(arrays, tcfg,
                                                          "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encoder_matches_jax(dtype):
    """The encoder over stub frames: learned positions, two non-causal
    layers, enc_norm."""
    jcfg, params, tcfg, model = _pair_model("whisper-medium", dtype)
    jf, tf = _x((2, tcfg.enc_seq, D), "bfloat16", seed=7, scale=0.1)
    _close(_j(jtransformer._encode, (0,))(jcfg, params, jf),
           transformer._encode(tcfg, model, tf), dtype, "encoder")


def test_cross_attention_matches_jax():
    """attention(kv_x=): q from x, k/v from the encoder's output, no mask,
    no rotation; precompute_cross_kv and cross_attention_decode over the
    static cache."""
    jp, tp = _pair_module(jattn.init_attention, attention.init_attention,
                          "float32", D, 4, 2, 32, bias=True)
    jp = jax.tree.map(lambda a: a + 0.05, jp)
    with torch.no_grad():
        for t in tp.parameters():
            t.add_(0.05)
    jx, tx = _x((2, 5, D), "float32", seed=8)
    je, te = _x((2, 16, D), "float32", seed=9)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    _close(jattn.attention(jp, jx, jnp.asarray(pos), kv_x=je,
                           use_rope=False, causal=False),
           attention.attention(tp, tx, torch.from_numpy(pos.copy()),
                               kv_x=te, use_rope=False, causal=False),
           "float32", "cross attention")
    jk, jv = jattn.precompute_cross_kv(jp, je)
    tk, tv = attention.precompute_cross_kv(tp, te)
    _close(jk, tk, "float32", "cross k")
    _close(jv, tv, "float32", "cross v")
    jc = jattn.init_cross_cache((jk, jv))
    tc = attention.init_cross_cache((tk, tv))
    for t in range(5):
        _close(jattn.cross_attention_decode(jp, jx[:, t:t + 1], jc),
               attention.cross_attention_decode(tp, tx[:, t:t + 1], tc),
               "float32", f"cross decode {t}")


# ---------------------------------------------------------------------------
# 2. configs.inputs
# ---------------------------------------------------------------------------

def _shapes(tree):
    """{path: (shape, dtype name)} of a spec tree; the sLSTM tuple named
    c, n, h, m."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(t, (tuple, list)):
            for k, v in zip("cnhm", t):
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = (tuple(t.shape), str(t.dtype).split(".")[-1])
    walk("", tree)
    return out


@pytest.mark.parametrize("name", ALL)
def test_input_specs_match_jax(name):
    """Shapes and dtypes of the train/prefill and decode inputs (the
    decode cache included) equal the reference's; the stand-ins hold no
    memory; materialize follows the reference's value rules, from a
    torch.Generator."""
    jcfg = j_smoke(j_get_arch(name).config)
    tcfg = smoke_config(get_arch(name).config)
    for jshape, tshape in ((J_SMOKE_SHAPE, SMOKE_SHAPE),
                           (J_SMOKE_DECODE, SMOKE_DECODE)):
        want = _shapes(j_input_specs(jcfg, jshape))
        specs = input_specs(tcfg, tshape)
        assert _shapes(specs) == want, name
        assert all(t.device.type == "meta" for t in
                   jax.tree.leaves(specs, is_leaf=torch.is_tensor))
    batch = materialize(input_specs(tcfg, SMOKE_SHAPE), seed=3,
                        device="cpu")
    again = materialize(input_specs(tcfg, SMOKE_SHAPE), seed=3,
                        device="cpu")
    tok = batch["tokens"]
    assert tok.dtype == torch.int32 and 0 <= int(tok.min()) \
        and int(tok.max()) < 64
    for k in batch:
        assert torch.equal(batch[k], again[k])
    for k in ("img", "frames"):
        if k in batch:
            assert batch[k].dtype == torch.bfloat16
            assert 0.05 < float(batch[k].float().std()) < 0.2
    dec = materialize(input_specs(tcfg, SMOKE_DECODE), device="cpu")
    assert dec["pos"].shape == () and int(dec["pos"]) == 0
    assert _shapes(dec) == _shapes(input_specs(tcfg, SMOKE_DECODE))


# ---------------------------------------------------------------------------
# 3. forward at the default capacity (drops) and the port's entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_forward_with_drops_matches_jax(name):
    """The smoke configs at capacity_factor 1.25 (the parallel path drops
    choices past an expert's capacity): logits and the summed aux loss
    against JAX's."""
    jcfg, params, tcfg, model = _pair_model(name)
    tok = np.random.default_rng(10).integers(1, 64, (2, 16)).astype(np.int32)
    jl, jaux, _, _ = jforward(jcfg, params, {"tokens": jnp.asarray(tok)})
    tl, taux, _, _ = forward(tcfg, model, {"tokens": torch.from_numpy(tok)})
    _close(jl, tl, "float32", f"{name} logits", module=False)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0


# ---------------------------------------------------------------------------
# 4. the serving engine
# ---------------------------------------------------------------------------

_DS = {}


def _datastores(vocab, n=512, seed=0):
    """(JAX RagDatastore, port RagDatastore) over one JAX-built index."""
    if vocab not in _DS:
        rng = np.random.default_rng(seed)
        vecs = rng.normal(size=(n, D)).astype(np.float32)
        jidx = jivf.build_index(vecs, cfg=JConfig(
            dim=D, target_partition_size=64, kmeans_iters=10,
            delta_capacity=64))
        toks = rng.integers(0, vocab, n + 1).astype(np.int32)
        arrays = {k: np.asarray(getattr(jidx, k)) for k in (
            "centroids", "csizes", "vectors", "ids", "attrs", "valid",
            "counts", "base_mean_size")}
        for k in ("vectors", "ids", "attrs", "valid", "count", "codes"):
            leaf = getattr(jidx.delta, k)
            arrays[f"delta.{k}"] = None if leaf is None else np.asarray(leaf)
        tidx = convert.index_from_arrays(
            arrays, dataclasses.asdict(jidx.config), "cpu")
        _DS[vocab] = (jrag.RagDatastore(index=jidx,
                                        next_token=jnp.asarray(toks)),
                      RagDatastore(index=tidx,
                                   next_token=torch.from_numpy(toks)))
    return _DS[vocab]


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 64, 3 + i % 4))) for i in range(n)]


def _serve(eng, R, prompts, new=5):
    reqs = [R(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs) and steps < 200:
        eng.step()
        steps += 1
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("with_rag", [False, True], ids=["lm", "rag"])
@pytest.mark.parametrize("name", TAIL_FREE)
def test_serve_engine_tokens_equal_jax(name, with_rag):
    """3 slots, 5 prompts, float32 weights (the caches bfloat16 and
    float32 state, as in the reference)."""
    jcfg, params, tcfg, model = _pair_model(name)
    jds = tds = None
    if with_rag:
        jds, tds = _datastores(tcfg.vocab_size)
    jeng = JServeEngine(jcfg, params, slots=3, s_max=32, rag=jds,
                        rag_cfg=jrag.RagConfig(k=8, n_probe=4, lam=0.3))
    teng = ServeEngine(tcfg, model, slots=3, s_max=32, rag=tds,
                       rag_cfg=RagConfig(k=8, n_probe=4, lam=0.3),
                       device="cpu")
    prompts = _prompts(5)
    assert _serve(teng, Request, prompts) == _serve(jeng, JRequest, prompts)


def _rg():
    return _pair_model("recurrentgemma-2b")


def test_jax_engine_step_slot_writes_every_slots_tail():
    """The reference defect the port does not carry: the JAX engine
    slices every cache leaf on axis 1, which for recurrentgemma's tail
    entry t0 (h [slots, d_rnn], batch on axis 0) is the feature axis, so
    `_step_slot(1, ...)` writes column 1 of all three slots' h and leaves
    the rest of slot 1's row as it was; the stacked p0 entry changes in
    slot 1's row only. The port's engine changes slot 1's row of both."""
    jcfg, params, tcfg, model = _rg()
    assert jcfg.tail_kinds == ("rglru",)
    jeng = JServeEngine(jcfg, params, slots=3, s_max=16)
    before = np.asarray(jeng.cache["t0"]["h"]).copy()
    p_before = np.asarray(jeng.cache["p0"]["h"]).copy()
    jeng._step_slot(1, 7, 0)
    changed = np.asarray(jeng.cache["t0"]["h"]) != before
    assert changed[:, 1].all()              # column 1 of every slot
    assert not np.delete(changed, 1, axis=1).any()
    p_changed = (np.asarray(jeng.cache["p0"]["h"]) != p_before).any(-1)
    assert p_changed[:, 1].all() and not p_changed[:, [0, 2]].any()

    teng = ServeEngine(tcfg, model, slots=3, s_max=16, device="cpu")
    t_before = teng.cache["t0"]["h"].clone()
    teng._step_slot(1, 7, 0)
    t_changed = teng.cache["t0"]["h"] != t_before
    assert t_changed[1].any() and not t_changed[[0, 2]].any()


class PerSlotJaxEngine(JServeEngine):
    """The JAX engine with the semantics it documents: `_reset_slot` and
    `_step_slot` slice each cache entry on its own batch axis (1 in a
    stacked entry, 0 in a tail entry), so each slot keeps its own state.
    Its decode is the JAX package's decode_step."""

    def _mix(self, old, new, s):
        out = {}
        for key in old:
            ax = 1 if key.startswith("p") else 0
            out[key] = jax.tree.map(
                lambda o, n, ax=ax: jax.lax.dynamic_update_slice_in_dim(
                    o, jax.lax.dynamic_slice_in_dim(n, s, 1, axis=ax), s,
                    axis=ax), old[key], new[key])
        return out

    def _reset_slot(self, s):
        fresh = jdecode.init_cache(self.cfg, self.slots, self.s_max)
        self.cache = self._mix(self.cache, fresh, s)

    def _step_slot(self, s, tok, pos):
        toks = self.slot_tok.copy()
        toks[s, 0] = tok
        _, _, new = self._decode(self.params, self.cache, jnp.asarray(toks),
                                 jnp.asarray(pos, jnp.int32))
        self.cache = self._mix(self.cache, new, s)


def test_engine_keeps_each_slots_tail_state():
    """recurrentgemma (a tail RG-LRU layer): the port's engine gives the
    tokens of a loop over JAX's decode_step that keeps each slot's own
    state, and a request served alone gives its tokens in the batch."""
    jcfg, params, tcfg, model = _rg()
    prompts = _prompts(5, seed=1)
    jeng = PerSlotJaxEngine(jcfg, params, slots=3, s_max=32)
    teng = ServeEngine(tcfg, model, slots=3, s_max=32, device="cpu")
    batched = _serve(teng, Request, prompts)
    assert batched == _serve(jeng, JRequest, prompts)
    for i in (0, 3):
        alone = ServeEngine(tcfg, model, slots=3, s_max=32, device="cpu")
        assert _serve(alone, Request, [prompts[i]]) == [batched[i]]


def test_reset_slot_zeroes_recurrent_and_encoder_entries():
    """A fresh slot's recurrent state and whisper's encoder K/V are zero
    (the reference's fresh cache), its ring positions -1; other slots
    keep theirs."""
    for name in ("xlstm-350m", "whisper-medium"):
        _, _, tcfg, model = _pair_model(name)
        eng = ServeEngine(tcfg, model, slots=2, s_max=16, device="cpu")
        with torch.no_grad():
            for entry in eng.cache.values():
                for t in entry.values():
                    t.fill_(3)
        eng._reset_slot(1)
        for entry in eng.cache.values():
            for key, t in entry.items():
                assert bool((t[:, 0] == 3).all()), (name, key)
                assert bool((t[:, 1] == (-1 if key == "pos" else 0)).all())


# ---------------------------------------------------------------------------
# 5. the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_serve_launcher_serves_every_family(name, capsys):
    serve.main(["--arch", name, "--device", "cpu", "--requests", "2",
                "--max-new", "2"] + (["--rag"] if name == "xlstm-350m"
                                     else []))
    out = capsys.readouterr().out
    assert "served 2 requests" in out and out.count("done=True") == 2


@pytest.mark.parametrize("name", FAMILIES)
def test_new_state_needs_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = smoke_config(get_arch(name).config)
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(input_specs(cfg, SMOKE_SHAPE))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, init_model(cfg, 0, device="cpu"))
    for make in (lambda: recurrent.init_rglru_state(1, 8),
                 lambda: xlstm.init_mlstm_state(1, 8, 2),
                 lambda: xlstm.init_slstm_state(1, 8, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
