"""The port's model zoo against the JAX package's, on all ten archs.

The JAX `init_model` parameters are carried into the port with
`convert.params_from_arrays`; the same tokens (pixtral's image prefix,
whisper's frames) then run through both packages' `forward`,
`decode_step` (8 steps) and `prefill`, for the smoke configs of every
registered architecture, in float32 and bfloat16 (xlstm-350m, the ssm
family, in float32 only, as the reference's own decode test runs it).
MoE configs lift the capacity (capacity_factor = n_experts) so the
forward drops nothing and decode reproduces it, as
tests/test_models.py does; tests/test_torch_families.py holds the drops.

Tolerances: float32 configs atol 1e-4, rtol 1e-4 (float32 sums in other
orders); bfloat16 configs atol 0.15, rtol 0.1 (the reference's own
decode-vs-forward tolerance: one bfloat16 rounding of an activation moves
a logit by up to ~2^-8 of its size, and differences compound over layers).
xlstm-350m's float32 runs take the reference's own float32 tolerance for
it, atol 1e-4, rtol 0.1 (tests/test_models.py): its smoke stack moves
its logits by ~2e-4 under a 1e-7 relative change of one input
(test_xlstm_stack_amplifies_rounding), so no other summation order meets
rtol 1e-4; tests/test_torch_families.py holds its blocks to 1e-5.

The JAX side runs jitted in float32 (one compile per config) and op by
op in bfloat16: jit fuses bfloat16 chains and keeps float32 between their
ops, which moves grok-1's and whisper's logits by up to 0.28 from the
reference's op-by-op result (beyond the tolerance), while the port
rounds where the reference's ops do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_names as j_arch_names
from repro.configs import get_arch as j_get_arch
from repro.configs import SHAPES as J_SHAPES
from repro.configs import shape_applicable as j_shape_applicable
from repro.configs.smoke import smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import decode_step as _jdecode_step
from repro.models import forward as _jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit_model
from repro.models import prefill as _jprefill
from repro.models.decode import fill_cache_from_forward as _jfill
from repro.models.layers import InitCtx as JCtx
from repro_torch import convert
from repro_torch.configs import SHAPES, arch_names, get_arch
from repro_torch.configs import shape_applicable
from repro_torch.configs.smoke import SMOKE_DECODE, SMOKE_SHAPE, smoke_config
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                init_model, layers, prefill)
from repro_torch.models.decode import fill_cache_from_forward

# jitted once per config: far fewer XLA compiles than op-by-op dispatch
jdecode_step = jax.jit(_jdecode_step, static_argnums=0)
jforward = jax.jit(_jforward, static_argnums=0,
                   static_argnames=("last_logits_only",))
jprefill = jax.jit(_jprefill, static_argnums=(0, 3))
jfill = jax.jit(_jfill, static_argnums=(0, 3))
_EAGER = {jdecode_step: _jdecode_step, jforward: _jforward,
          jprefill: _jprefill, jfill: _jfill}


def jax_fn(fn, dtype):
    """The JAX function as the parity runs call it: jitted in float32, op
    by op in bfloat16 (module docstring)."""
    return fn if dtype == "float32" else _EAGER[fn]

ALL = ["llama3-8b", "gemma2-27b", "starcoder2-15b", "minitron-4b",
       "pixtral-12b", "phi3.5-moe", "grok-1-314b", "recurrentgemma-2b",
       "xlstm-350m", "whisper-medium"]
# (arch, dtype) pairs of the parity runs: the ssm family in float32 only
RUNS = [(n, dt) for n in ALL for dt in ("float32", "bfloat16")
        if not (n == "xlstm-350m" and dt == "bfloat16")]


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


def jax_param_arrays(params):
    """JAX params flattened by tree path (the params_from_arrays keys)."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def _tol(dtype, family=None):
    if dtype != "float32":
        return dict(atol=0.15, rtol=0.1)
    return dict(atol=1e-4, rtol=0.1 if family == "ssm" else 1e-4)


_MODELS = {}


def _pair(name, dtype, seed=1):
    """(JAX cfg, JAX params, port cfg, port model) on the smoke config."""
    key = (name, dtype, seed)
    if key not in _MODELS:
        base = smoke_config(get_arch(name).config)
        extra = dict(capacity_factor=float(base.n_experts)) \
            if base.n_experts else {}
        jcfg = dataclasses.replace(j_smoke(j_get_arch(name).config),
                                   dtype=dtype, remat=False, **extra)
        tcfg = dataclasses.replace(base, dtype=dtype, remat=False, **extra)
        params, _ = jinit_model(jcfg, jax.random.PRNGKey(seed))
        model = convert.params_from_arrays(jax_param_arrays(params), tcfg,
                                           "cpu")
        _MODELS[key] = (jcfg, params, tcfg, model)
    return _MODELS[key]


def _batches(cfg, s=8, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, 64, (2, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.num_img_tokens:
        img = (0.1 * rng.normal(size=(2, cfg.num_img_tokens, cfg.d_model))
               ).astype(np.float32)
        jb["img"] = jnp.asarray(img, jnp.bfloat16)
        tb["img"] = torch.from_numpy(img).to(torch.bfloat16)
    if cfg.encoder_layers:
        frames = (0.1 * rng.normal(size=(2, cfg.enc_seq, cfg.d_model))
                  ).astype(np.float32)
        jb["frames"] = jnp.asarray(frames, jnp.bfloat16)
        tb["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
    return jb, tb


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(j, t, dtype, what, family=None):
    np.testing.assert_allclose(_np(t), _np(j), err_msg=what,
                               **_tol(dtype, family))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_equal_jax():
    assert arch_names() == j_arch_names()
    for name in arch_names():
        a, b = get_arch(name), j_get_arch(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert dataclasses.asdict(smoke_config(a.config)) == \
            dataclasses.asdict(j_smoke(b.config)), name
        assert a.config.param_count() == b.config.param_count()
        assert a.config.active_param_count() == \
            b.config.active_param_count()
        for shape in SHAPES:
            assert shape_applicable(a.config, SHAPES[shape]) == \
                j_shape_applicable(b.config, J_SHAPES[shape])
    for alias in ("llama3-8b", "phi3.5-moe", "grok-1-314b", "pixtral-12b"):
        assert get_arch(alias).config.name == j_get_arch(alias).config.name
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert SMOKE_SHAPE.seq_len == SMOKE_DECODE.seq_len == 32


@pytest.mark.parametrize("name", ["llama3-8b", "gemma2-27b"])
def test_param_count_analytic_close(name):
    cfg = get_arch(name).config
    model = init_model(cfg, abstract=True)
    actual = sum(p.numel() for p in model.parameters())
    assert abs(cfg.param_count() - actual) / actual < 0.05
    jparams, _ = jinit_model(j_get_arch(name).config, abstract=True)
    assert actual == sum(int(np.prod(p.shape))
                         for p in jax.tree.leaves(jparams))


@pytest.mark.parametrize("name", ALL)
def test_init_leaves_match_jax_shapes(name):
    """Every JAX leaf has a port parameter of its shape and dtype, and the
    port's own draw follows the reference's recipe."""
    cfg = smoke_config(get_arch(name).config)
    jparams, _ = jinit_model(j_smoke(j_get_arch(name).config),
                             abstract=True)
    model = init_model(cfg, 3, device="cpu")
    names = dict(model.named_parameters())
    stacked = ("stack/", "enc_stack/")
    for key, leaf in jax_param_arrays_abstract(jparams).items():
        shape = leaf.shape[1:] if key.startswith(stacked) else leaf.shape
        for pname, _ in convert.port_names(key, np.empty(leaf.shape[:1]),
                                           cfg):
            p = names[pname]
            assert tuple(p.shape) == tuple(shape), pname
            assert str(p.dtype).split(".")[-1] == str(leaf.dtype), pname
    assert len(names) == sum(
        leaf.shape[0] if k.startswith(stacked) else 1
        for k, leaf in jax_param_arrays_abstract(jparams).items())
    first = dict(model.layers[0].named_parameters())
    wq = next(first[n] for n in ("attn.wq", "rnn.wy", "cell.w_up")
              if n in first).float()
    bound = 2.0 / cfg.d_model ** 0.5
    assert float(wq.abs().max()) <= bound * (1 + 2 ** -7)
    assert 0.5 < float(wq.std()) * cfg.d_model ** 0.5 < 1.0
    assert model.final_norm.scale.dtype == torch.float32
    assert bool((model.final_norm.scale == 1).all())


def jax_param_arrays_abstract(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in leaves}


def test_params_from_arrays_refuses_a_missing_or_odd_leaf():
    jcfg, params, tcfg, _ = _pair("llama3-8b", "float32")
    arrays = jax_param_arrays(params)
    short = dict(arrays)
    del short["final_norm/scale"]
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.params_from_arrays(short, tcfg, "cpu")
    odd = dict(arrays, **{"stack/p0/attn/wz": arrays["stack/p0/attn/wq"]})
    with pytest.raises(ValueError, match="wz"):
        convert.params_from_arrays(odd, tcfg, "cpu")
    bad = dict(arrays, **{"embed/table": arrays["embed/table"][:, :8]})
    with pytest.raises(ValueError, match="embed/table"):
        convert.params_from_arrays(bad, tcfg, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "relu2", "gelu"])
def test_mlp_matches_jax(act):
    p, _ = jlayers.init_mlp(JCtx(jax.random.PRNGKey(0), jnp.float32), 16, 32,
                            act, bias=True)
    p = jax.tree.map(lambda a: a + 0.1, p)       # non-zero biases
    tm = layers.init_mlp(layers.InitCtx(None, torch.float32, abstract=True),
                         16, 32, act, bias=True).to_empty(device="cpu")
    with torch.no_grad():
        for name, t in tm.named_parameters():
            sub, leaf = name.split(".")
            t.copy_(torch.from_numpy(np.asarray(p[sub][leaf])))
    x = np.random.default_rng(1).normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        layers.mlp(tm, torch.from_numpy(x), act).numpy(),
        np.asarray(jlayers.mlp(p, jnp.asarray(x), act)), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_softcap_match_jax(kind, dtype):
    rng = np.random.default_rng(2)
    x = (3 * rng.normal(size=(2, 5, 4, 16))).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = layers.Norm(layers.InitCtx(None, torch.float32, abstract=True),
                     kind, 16).to_empty(device="cpu")
    with torch.no_grad():
        tp.scale.copy_(torch.from_numpy(scale))
        if kind == "layernorm":
            tp.bias.copy_(torch.from_numpy(bias))
    tol = _tol(dtype) if dtype == "bfloat16" else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(layers.apply_norm(kind, tp, tx)),
                               _np(jlayers.apply_norm(kind, jp, jx)), **tol)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(layers.apply_rope(tx, torch.from_numpy(pos), 5e5)),
        _np(jlayers.apply_rope(jx, jnp.asarray(pos), 5e5)),
        **(tol if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-5)))
    np.testing.assert_allclose(_np(layers.softcap(tx, 2.0)),
                               _np(jlayers.softcap(jx, 2.0)), atol=1e-6)


# ---------------------------------------------------------------------------
# forward / decode / prefill against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype", RUNS)
def test_forward_and_decode_match_jax(name, dtype):
    jcfg, params, tcfg, model = _pair(name, dtype)
    fam = tcfg.family

    def close(j, t, what):
        _close(j, t, dtype, what, fam)
    jb, tb = _batches(jcfg)
    jfwd = jax_fn(jforward, dtype)
    jl, _, jh, off = jfwd(jcfg, params, jb)
    off = int(off)
    tl, _, th, toff = forward(tcfg, model, tb)
    assert toff == off
    close(jl, tl, f"{name} forward logits")
    close(jh, th, f"{name} forward hidden")
    jl1 = jfwd(jcfg, params, jb, last_logits_only=True)[0]
    tl1 = forward(tcfg, model, tb, last_logits_only=True)[0]
    close(jl1, tl1, f"{name} last logits")

    cdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jc = jinit_cache(jcfg, 2, 32, dtype=cdt[0])
    tc = init_cache(tcfg, 2, 32, dtype=cdt[1], device="cpu")
    start = 0
    if jcfg.num_img_tokens or jcfg.encoder_layers:
        # the image prefix / the encoder's frames go in by cache fill
        jc = jax_fn(jfill, dtype)(
            jcfg, params, dict(jb, tokens=jb["tokens"][:, :1]), 32)
        tc = fill_cache_from_forward(
            tcfg, model, dict(tb, tokens=tb["tokens"][:, :1]), 32)
        start = 1
    jdec = jax_fn(jdecode_step, dtype)
    for t in range(start, 8):
        pos = off + t
        a, ah, jc = jdec(jcfg, params, jc, jb["tokens"][:, t:t + 1],
                         jnp.asarray(pos, jnp.int32))
        b, bh, tc = decode_step(tcfg, model, tc, tb["tokens"][:, t:t + 1],
                                pos)
        close(a, b, f"{name} decode logits pos {pos}")
        close(ah, bh, f"{name} decode hidden pos {pos}")
        # decode reproduces the parallel forward at every position
        close(tl[:, pos], b, f"{name} decode vs forward")
    assert_caches_close(jc, tc, dtype, f"{name} decode", fam)


def cache_leaves(cache):
    """{"p0/k": array, ...}: a cache's leaves by path, the sLSTM state's
    tuple (c, n, h, m) named by its letters as in the port."""
    out = {}
    for key, entry in cache.items():
        if isinstance(entry, (tuple, list)):
            entry = dict(zip("cnhm", entry))
        for leaf, a in entry.items():
            out[f"{key}/{leaf}"] = a
    return out


def assert_caches_close(jc, tc, dtype, what, family=None):
    jl, tl = cache_leaves(jc), cache_leaves(tc)
    assert sorted(jl) == sorted(tl), what
    for key, a in jl.items():
        assert tuple(np.shape(a)) == tuple(tl[key].shape), f"{what} {key}"
        if key.endswith("/pos"):
            np.testing.assert_array_equal(np.asarray(a), tl[key].numpy(),
                                          err_msg=f"{what} {key}")
        else:
            _close(a, tl[key], dtype, f"{what} cache {key}", family)


@pytest.mark.parametrize("name", ALL)
def test_prefill_matches_jax_and_step_by_step(name):
    jcfg, params, tcfg, model = _pair(name, "float32")
    fam = tcfg.family
    # 12 positions; 16 where mLSTM chunks of 8 must divide the prompt
    s = 16 if "mlstm" in tcfg.pattern else 12
    jb, tb = _batches(jcfg, s=s, seed=3)
    jl, jh, jc = jprefill(jcfg, params, jb, 32)
    tl, th, tc = prefill(tcfg, model, tb, 32)
    _close(jl, tl, "float32", f"{name} prefill logits", fam)
    _close(jh, th, "float32", f"{name} prefill hidden", fam)
    assert_caches_close(jc, tc, "float32", f"{name} prefill", fam)
    for leaf, t in cache_leaves(tc).items():
        if not leaf.endswith("/pos"):       # activation dtype, or float32
            assert t.dtype == torch.float32, leaf
    if jcfg.num_img_tokens or jcfg.encoder_layers:
        return
    # the step-by-step cache equals prefill's. mLSTM's stabiliser m
    # differs by construction (decode's includes its initial 0, prefill's
    # does not, in the reference too), so its C and n are held as
    # C exp(m) and n exp(m), the state both forms stand for
    sc = init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    for t in range(s):
        _, _, sc = decode_step(tcfg, model, sc, tb["tokens"][:, t:t + 1], t)
    for key in tc:
        a, b = dict(sc[key]), dict(tc[key])
        if set(a) == {"C", "n", "m"}:
            for c in (a, b):
                e = torch.exp(c.pop("m"))
                c["C"], c["n"] = c["C"] * e[..., None, None], \
                    c["n"] * e[..., None]
        for leaf in b:
            _close(a[leaf], b[leaf], "float32",
                   f"{name} step cache {key}/{leaf}", fam)


def test_xlstm_stack_amplifies_rounding():
    """Why xlstm-350m's float32 runs take the reference's rtol 0.1: the
    reference itself moves its smoke logits by more than 1e-4 (+1e-4
    relative) when its embedding table changes by 1e-7 relative, about
    one float32 rounding."""
    jcfg, params, _, _ = _pair("xlstm-350m", "float32")
    jb, _ = _batches(jcfg)
    base = np.asarray(jforward(jcfg, params, jb)[0])
    noise = 1 + 1e-7 * np.random.default_rng(1).normal(
        size=params["embed"]["table"].shape)
    moved = dict(params, embed={"table": params["embed"]["table"]
                                * noise.astype(np.float32)})
    got = np.asarray(jforward(jcfg, moved, jb)[0])
    assert (np.abs(got - base) > 1e-4 + 1e-4 * np.abs(base)).any()
    np.testing.assert_allclose(got, base, **_tol("float32", "ssm"))


def test_cache_defaults_to_bfloat16():
    _, _, tcfg, _ = _pair("llama3-8b", "float32")
    c = init_cache(tcfg, 2, 16, device="cpu")
    assert c["p0"]["k"].dtype == torch.bfloat16
    assert c["p0"]["k"].shape == (tcfg.stack_count, 2, 16, 4, 32)
    assert bool((c["p0"]["pos"] == -1).all())


@pytest.mark.parametrize("s,attn_chunk,kv_chunk", [(32, 16, 8), (24, 8, 8)])
def test_chunked_and_online_softmax_paths_match_jax(monkeypatch, s,
                                                    attn_chunk, kv_chunk):
    """The query-chunk loop and the online softmax over KV chunks (taken
    when the keys outnumber KV_CHUNK and divide by it), exercised at a
    small size by shrinking both packages' chunk constants alike."""
    monkeypatch.setattr(jattn, "ATTN_CHUNK", attn_chunk)
    monkeypatch.setattr(jattn, "KV_CHUNK", kv_chunk)
    monkeypatch.setattr(attention, "ATTN_CHUNK", attn_chunk)
    monkeypatch.setattr(attention, "KV_CHUNK", kv_chunk)
    for name in ("llama3-8b", "gemma2-27b"):
        jcfg, params, tcfg, model = _pair(name, "float32")
        jb, tb = _batches(jcfg, s=s, seed=5)
        jl = jforward(jcfg, params, jb)[0]
        tl = forward(tcfg, model, tb)[0]
        _close(jl, tl, "float32", f"{name} chunked forward")


def test_local_attention_window_and_ring_match_jax():
    """Tokens beyond the window do not reach local attention, and the
    ring cache keeps the last W positions (tests/test_models.py)."""
    p, _ = jattn.init_attention(JCtx(jax.random.PRNGKey(0), jnp.float32),
                                16, 2, 1, 8)
    tp = attention.init_attention(
        layers.InitCtx(None, torch.float32, abstract=True), 16, 2, 1,
        8).to_empty(device="cpu")
    with torch.no_grad():
        for name, t in tp.named_parameters():
            t.copy_(torch.from_numpy(np.asarray(p[name])))
    S, W = 12, 4
    x = np.random.default_rng(1).normal(size=(1, S, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    y1 = attention.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             window=W)
    jatt = jax.jit(jattn.attention, static_argnames=("window",))
    np.testing.assert_allclose(
        y1.numpy(), np.asarray(jatt(p, jnp.asarray(x), jnp.asarray(pos),
                                    window=W)), atol=1e-5, rtol=1e-5)
    x2 = x.copy()
    x2[:, 0] += 100.0
    y2 = attention.attention(tp, torch.from_numpy(x2), torch.from_numpy(pos),
                             window=W)
    np.testing.assert_allclose(y1[:, W + 1:].numpy(), y2[:, W + 1:].numpy(),
                               atol=1e-5)
    assert not np.allclose(y1[:, 0].numpy(), y2[:, 0].numpy())

    jdec = jax.jit(jattn.attention_decode, static_argnames=("window",))
    jc = jattn.init_kv_cache(1, jattn.KVCacheSpec(W, 1, 8), dtype=jnp.float32)
    tc = attention.init_kv_cache(1, attention.KVCacheSpec(W, 1, 8),
                                 dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    for t in range(10):
        xt = rng.normal(size=(1, 1, 16)).astype(np.float32)
        jo, jc = jdec(p, jnp.asarray(xt), jc, jnp.asarray(t, jnp.int32),
                      window=W)
        to, tc = attention.attention_decode(tp, torch.from_numpy(xt), tc, t,
                                            window=W)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
    assert sorted(tc["pos"][0].tolist()) == [6, 7, 8, 9]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("name", ALL)
def test_entry_points_need_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = smoke_config(get_arch(name).config)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
