"""The port's training half against the JAX package's, on the CPU.

JAX weights are carried into the port with `convert.params_from_arrays`
(and back with `convert.arrays_from_params`); the same batches, made
from a seed with numpy, go through both packages.

- `transformer.loss_fn` and its gradients against
  `jax.value_and_grad(transformer.loss_fn)` for all ten archs' smoke
  configs in float32 (MoE with capacity_factor = n_experts, as in
  test_torch_models.py): loss within 1e-5 relative, each leaf's gradient
  within 1e-4 x the leaf's max |g|, or within twice the reference's own
  change of that leaf under a 1e-7 relative change of its embedding
  (for a leaf whose exact gradient is zero, so both packages' values are
  rounding noise); xlstm-350m also rtol 0.1, the reference's own float32
  tolerance for it (its stack amplifies a rounding ~2,000-fold,
  test_torch_models.py).
- `optim.update` / `schedule` / `global_norm` against the reference's on
  the same gradients, within 1e-6 relative, the count equal.
- The five cases of tests/test_trainer.py on the port; ten Trainer steps
  of that file's TINY config against JAX's (losses within 2e-3 relative
  at every step: bfloat16 weights, whose one-ulp roundings the two
  packages' float32 sums decide differently, then carried by Adam).
- Checkpoints both ways, bit for bit, in the reference's format; remat
  on and off equal; the serving entry points build no autograd graph;
  the launcher runs.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.smoke import smoke_config as j_smoke
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import init_model as jinit_model
from repro.models import transformer as jtransformer
from repro.storage import checkpoint as jckpt
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import optim as joptim
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.smoke import smoke_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                prefill, transformer)
from repro_torch.storage import checkpoint
from repro_torch.train import Trainer, TrainerConfig, optim
from repro_torch.train.trainer import StragglerStats, make_train_step

ROOT = Path(__file__).resolve().parents[1]

ALL = ["llama3-8b", "gemma2-27b", "starcoder2-15b", "minitron-4b",
       "pixtral-12b", "phi3.5-moe", "grok-1-314b", "recurrentgemma-2b",
       "xlstm-350m", "whisper-medium"]

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=64,
               num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
               vocab_size=256, pattern=("attn",), tie_embeddings=True,
               remat=False)
TINY = ModelConfig(**TINY_KW)
JTINY = JModelConfig(**TINY_KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_arrays(tree):
    """A JAX pytree flattened by tree path (the params_from_arrays keys)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def f32(a):
    return np.asarray(a, np.float32)


def _configs(name, dtype="float32"):
    base = smoke_config(get_arch(name).config)
    extra = dict(capacity_factor=float(base.n_experts)) \
        if base.n_experts else {}
    jcfg = dataclasses.replace(j_smoke(j_get_arch(name).config),
                               dtype=dtype, remat=False, **extra)
    tcfg = dataclasses.replace(base, dtype=dtype, remat=False, **extra)
    return jcfg, tcfg


def _batches(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    for key, n, on in (("img", cfg.num_img_tokens, cfg.num_img_tokens),
                       ("frames", cfg.enc_seq, cfg.encoder_layers)):
        if on:
            x = (0.1 * rng.normal(size=(b, n, cfg.d_model))).astype(
                np.float32)
            jb[key], tb[key] = jnp.asarray(x), torch.from_numpy(x)
    return jb, tb


def port_grads(cfg, model, batch, remat=False):
    total, metrics = transformer.loss_fn(cfg, model, batch, remat=remat)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(total, list(model.parameters()))
    return total, metrics, dict(zip(names, gs))


_jgrad = jax.jit(jax.value_and_grad(jtransformer.loss_fn, argnums=1,
                                    has_aux=True), static_argnums=0)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg = _configs(name)
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(1))
    model = convert.params_from_arrays(jax_arrays(params), tcfg, "cpu")
    jb, tb = _batches(tcfg)
    (jtotal, jm), jg = _jgrad(jcfg, params, jb)
    total, metrics, grads = port_grads(tcfg, model, tb)
    assert total.dtype == torch.float32
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in ("loss", "aux", "ppl"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    if tcfg.n_experts:
        assert float(metrics["aux"].detach()) > 0
    jgrads = jax_arrays(jg)
    tgrads = convert.arrays_from_params(grads, tcfg)
    assert sorted(jgrads) == sorted(tgrads)
    # the reference's own gradients move this much when its embedding
    # changes by 1e-7 relative: a leaf whose exact gradient is zero is
    # rounding noise in both packages (an attention key bias: softmax
    # ignores a shift shared by every key; the last sLSTM's input-gate
    # bias: c / n cancels the gate's scale), held to twice that
    moved = jax.tree_util.tree_map(lambda a: a, params)
    moved["embed"]["table"] = moved["embed"]["table"] * (1 + 1e-7)
    noise = {k: 2 * float(np.abs(a - jgrads[k]).max())
             for k, a in jax_arrays(_jgrad(jcfg, moved, jb)[1]).items()}
    rtol = 0.1 if tcfg.family == "ssm" else 0.0
    for key, a in jgrads.items():
        atol = max(1e-4 * float(np.abs(a).max()), noise[key])
        np.testing.assert_allclose(tgrads[key], a, atol=atol, rtol=rtol,
                                   err_msg=f"{name} d/d {key}")


@pytest.mark.parametrize("name", ["llama3-8b", "phi3.5-moe",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "whisper-medium"])
def test_remat_on_and_off_give_equal_gradients(name, monkeypatch):
    """torch.utils.checkpoint around each period (and the tail) recomputes
    the same ops: the gradients have the same bits, under either
    REPRO_REMAT_POLICY (nothing_saveable, and `dots`, which keeps the
    unbatched products' outputs)."""
    _, tcfg = _configs(name)
    model = init_model(tcfg, 2, device="cpu")
    _, tb = _batches(tcfg, seed=4)
    off = port_grads(tcfg, model, tb, remat=False)
    for policy in ("nothing", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        on = port_grads(tcfg, model, tb, remat=True)
        assert torch.equal(on[0], off[0]), policy
        for n, g in off[2].items():
            assert torch.equal(on[2][n], g), (policy, n)


def test_dots_policy_saves_the_unbatched_products():
    """`dots` keeps mm / addmm outputs and a bmm's with a batch of one (a
    projection through torch.einsum); the attention's batched products
    and everything else are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    a, b = torch.zeros(1, 4, 8), torch.zeros(1, 8, 2)
    pol = transformer._saves_dots
    assert pol(None, aten.mm.default, a[0], b[0]) == \
        CheckpointPolicy.MUST_SAVE
    assert pol(None, aten.bmm.default, a, b) == CheckpointPolicy.MUST_SAVE
    assert pol(None, aten.bmm.default, a.expand(3, 4, 8),
               b.expand(3, 8, 2)) == CheckpointPolicy.PREFER_RECOMPUTE
    assert pol(None, aten.mul.Tensor, a, a) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_loss_masks_the_prefix_and_the_last_position():
    """pixtral: the image prefix predicts nothing; the last position has
    no target. The loss equals a direct mean over the text targets."""
    _, tcfg = _configs("pixtral-12b")
    model = init_model(tcfg, 5, device="cpu")
    _, tb = _batches(tcfg, seed=5)
    with torch.no_grad():
        total, m = transformer.loss_fn(tcfg, model, tb)
        logits, aux, _, off = forward(tcfg, model, tb)
    assert off == tcfg.num_img_tokens
    tok = tb["tokens"].long()
    logp = torch.log_softmax(logits.float(), -1)[:, off:off + tok.shape[1] - 1]
    want = -torch.gather(logp, -1, tok[:, 1:, None]).mean()
    torch.testing.assert_close(m["loss"], want, rtol=1e-6, atol=0)
    torch.testing.assert_close(total, m["loss"] + 0.01 * aux)
    assert float(m["ppl"]) == pytest.approx(float(torch.exp(m["loss"])))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedule_and_global_norm_match_jax():
    cfg = optim.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = joptim.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            float(got), float(joptim.schedule(jcfg, jnp.int32(step))),
            rtol=1e-6, err_msg=str(step))
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in
              ((3, 4), (7,), (2, 2, 5))]
    np.testing.assert_allclose(
        float(optim.global_norm({str(i): torch.from_numpy(a)
                                 for i, a in enumerate(leaves)})),
        float(joptim.global_norm([jnp.asarray(a) for a in leaves])),
        rtol=1e-6)


def test_update_matches_jax_leaf_by_leaf():
    """Three AdamW steps on a model's parameters with seeded gradients
    (the third clipped): parameters, moments, count and metrics equal
    JAX's. A stacked layer's norm scale is decayed (the reference's leaf
    has rank 2), the final norm's not."""
    jcfg, tcfg = _configs("gemma2-27b")
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(3))
    model = convert.params_from_arrays(jax_arrays(params), tcfg, "cpu")
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg_o = joptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate, state = joptim.init(params), optim.init(model)
    rng = np.random.default_rng(7)
    for it, size in enumerate((1e-3, 1e-2, 10.0)):
        garr = {k: (size * rng.normal(size=a.shape)).astype(np.float32)
                for k, a in jax_arrays(params).items()}
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jnp.asarray(garr[k]) for k in jax_arrays(params)])
        tgrads = {n: p for k, a in garr.items()
                  for n, p in convert.port_names(k, torch.from_numpy(a),
                                                 tcfg)}
        params, jstate, jm = joptim.update(jcfg_o, jgrads, jstate, params)
        model, state, m = optim.update(cfg, tgrads, state, model)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        assert int(state.count) == int(jstate.count) == it + 1
        got = convert.arrays_from_params(model)
        # within 1e-6 of each leaf's largest magnitude
        for key, a in jax_arrays(params).items():
            np.testing.assert_allclose(got[key], a, rtol=1e-6,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=f"step {it} {key}")
        for field in ("mu", "nu"):
            gm = convert.arrays_from_params(getattr(state, field), tcfg)
            for key, a in jax_arrays(getattr(jstate, field)).items():
                np.testing.assert_allclose(gm[key], a, rtol=1e-6,
                                           atol=1e-6 * np.abs(a).max(),
                                           err_msg=key)
    assert optim.decays("layers.0.norm1.scale", model.layers[0].norm1.scale,
                        tcfg)
    assert not optim.decays("final_norm.scale", model.final_norm.scale,
                            tcfg)


# ---------------------------------------------------------------------------
# the five cases of tests/test_trainer.py
# ---------------------------------------------------------------------------

def _data(batch=4, seq=64, vocab=256):
    stream = TokenStream(vocab=vocab, batch=batch, seq=seq)

    def it(start):
        for b in stream.iter_from(start):
            yield {"tokens": torch.from_numpy(b["tokens"])}
    return it


def _jdata(batch=4, seq=64, vocab=256):
    stream = JTokenStream(vocab=vocab, batch=batch, seq=seq)

    def it(start):
        for b in stream.iter_from(start):
            yield {"tokens": jnp.asarray(b["tokens"])}
    return it


def test_trainer_loss_decreases():
    model = init_model(TINY, 0, device="cpu")
    tcfg = TrainerConfig(opt=optim.AdamWConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=40))
    tr = Trainer(TINY, tcfg)
    tr.fit(model, _data(), 40)
    losses = [m["loss"] for m in tr.history]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses[:3]


def test_trainer_checkpoint_resume_exact(tmp_path):
    """20 straight steps == 10 steps + restart + 10 steps (same stream),
    bit for bit; the caller's model is untouched."""
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    model = init_model(TINY, 0, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    tr1 = Trainer(TINY, TrainerConfig(opt=opt_cfg))
    p_full, s_full = tr1.fit(model, _data(), 20)

    d = str(tmp_path / "ck")
    tcfg = TrainerConfig(opt=opt_cfg, checkpoint_every=10, ckpt_dir=d)
    tr2 = Trainer(TINY, tcfg)
    tr2.fit(model, _data(), 10)                # writes step_10
    assert checkpoint.latest_step(d) == 10
    tr3 = Trainer(TINY, tcfg)                  # fresh process analogue
    p_resumed, s_resumed = tr3.fit(model, _data(), 20)   # resumes at 10
    assert tr3.history[0]["step"] == 10
    assert [h["loss"] for h in tr3.history] == \
        [h["loss"] for h in tr1.history[10:]]
    for (n, a), b in zip(p_full.named_parameters(), p_resumed.parameters()):
        assert torch.equal(a, b), n
    for n in s_full.mu:
        assert torch.equal(s_full.mu[n], s_resumed.mu[n])
        assert torch.equal(s_full.nu[n], s_resumed.nu[n])
    assert int(s_resumed.count) == 20
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_trainer_microbatch_accumulation_matches_full_batch():
    model = init_model(TINY, 0, device="cpu")
    t1 = make_train_step(TINY, TrainerConfig(microbatches=1), donate=False)
    t4 = make_train_step(TINY, TrainerConfig(microbatches=4), donate=False)
    batch = next(_data(batch=8)(0))
    import copy
    m1, m4 = copy.deepcopy(model), copy.deepcopy(model)
    p1, _, _ = t1(m1, optim.init(m1), batch)
    p4, _, mt4 = t4(m4, optim.init(m4), batch)
    for a, b in zip(p1.parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   atol=5e-3, rtol=5e-3)
    # the metrics are the last microbatch's
    last = {"tokens": batch["tokens"][6:]}
    with torch.no_grad():
        _, ml = transformer.loss_fn(TINY, model, last)
    assert float(mt4["loss"]) == float(ml["loss"])


def test_trainer_straggler_detection():
    st = StragglerStats()
    flagged = [st.observe(dt, z=3.0)
               for dt in [1.0] * 20 + [5.0] + [1.0] * 5]
    assert any(flagged), "slow step not flagged"
    assert sum(flagged) <= 2, "over-flagging"


def test_trainer_grad_clip_bounds_update():
    params = {"w": torch.ones((4, 4), dtype=torch.float32)}
    grads = {"w": torch.full((4, 4), 1e6, dtype=torch.float32)}
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0)
    state = optim.init(params)
    new_p, _, metrics = optim.update(cfg, grads, state, params)
    assert float(metrics["grad_norm"]) > 1e5
    # post-clip update magnitude is bounded by lr * O(1)
    delta = float((new_p["w"] - 1.0).abs().max())
    assert delta < 0.1


# ---------------------------------------------------------------------------
# the trainer against JAX's
# ---------------------------------------------------------------------------

def test_microbatches_match_jax():
    """make_train_step with microbatches=4: parameters after one step
    equal JAX's (float32)."""
    jcfg = dataclasses.replace(JTINY, dtype="float32")
    tcfg = dataclasses.replace(TINY, dtype="float32")
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_arrays(jax_arrays(params), tcfg, "cpu")
    from repro.train.trainer import make_train_step as jmake
    jstep = jmake(jcfg, JTrainerConfig(microbatches=4), donate=False)
    tstep = make_train_step(tcfg, TrainerConfig(microbatches=4))
    jb = next(_jdata(batch=8)(0))
    tb = next(_data(batch=8)(0))
    jp, _, jm = jstep(params, joptim.init(params), jb)
    tp, _, tm = tstep(model, optim.init(model), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    got = convert.arrays_from_params(tp)
    for key, a in jax_arrays(jp).items():
        np.testing.assert_allclose(got[key], a, atol=1e-5, err_msg=key)


def test_ten_trainer_steps_match_jax():
    opt = dict(lr=3e-3, warmup_steps=3, total_steps=10)
    params, _ = jinit_model(JTINY, jax.random.PRNGKey(0))
    model = convert.params_from_arrays(jax_arrays(params), TINY, "cpu")
    jt = JTrainer(JTINY, JTrainerConfig(opt=joptim.AdamWConfig(**opt)))
    jt.fit(params, _jdata(), 10)
    tt = Trainer(TINY, TrainerConfig(opt=optim.AdamWConfig(**opt)))
    tt.fit(model, _data(), 10)
    for a, b in zip(jt.history, tt.history):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=2e-3,
                                   err_msg=f"step {a['step']}")
        np.testing.assert_allclose(b["lr"], a["lr"], rtol=1e-6)
    assert len(tt.history) == 10


# ---------------------------------------------------------------------------
# checkpoints: the reference's format, both ways
# ---------------------------------------------------------------------------

def _ck_files(d, step):
    import json
    path = os.path.join(d, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(path, v["file"]))
            for k, v in man["leaves"].items()}, man


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX trains TINY (bfloat16) 5 steps and saves; the port restores
    every leaf bit for bit, and its continuation to step 10 follows
    JAX's own."""
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    params, _ = jinit_model(JTINY, jax.random.PRNGKey(0))
    d = str(tmp_path / "jax")
    jt = JTrainer(JTINY, JTrainerConfig(opt=joptim.AdamWConfig(**opt),
                                        checkpoint_every=5, ckpt_dir=d))
    jt.fit(params, _jdata(), 5)
    files, man = _ck_files(d, 5)
    port_dir = str(tmp_path / "port")
    shutil.copytree(d, port_dir)    # JAX's continuation saves into d
    assert man["extra"] == {"data_step": 5}

    model = init_model(TINY, 9, device="cpu")
    tmpl = {"params": model, "opt": optim.init(model, abstract=True)}
    state, step, extra = checkpoint.restore_checkpoint(port_dir, tmpl)
    assert step == 5 and extra == {"data_step": 5}
    got = {f"params/{k}": v for k, v in
           convert.tensors_from_params(state["params"]).items()}
    for field in ("mu", "nu"):
        got.update({f"opt/.{field}/{k}": v for k, v in
                    convert.tensors_from_params(
                        getattr(state["opt"], field), TINY).items()})
    got["opt/.count"] = state["opt"].count
    assert sorted(got) == sorted(files)
    for key, t in got.items():
        want = files[key]
        have = t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=key)

    # both continue from step 5 to 10 on the same stream
    jt.fit(params, _jdata(), 10)
    tt = Trainer(TINY, TrainerConfig(opt=optim.AdamWConfig(**opt),
                                     checkpoint_every=5, ckpt_dir=port_dir))
    tt.fit(model, _data(), 10)
    assert [h["step"] for h in tt.history] == list(range(5, 10))
    for a, b in zip(jt.history[5:], tt.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=2e-3,
                                   err_msg=f"step {a['step']}")


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port trains TINY (bfloat16) 4 steps and saves; JAX's
    restore_checkpoint reads every leaf bit for bit into its own tree."""
    opt = optim.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    model = init_model(TINY, 0, device="cpu")
    d = str(tmp_path / "port")
    tr = Trainer(TINY, TrainerConfig(opt=opt, checkpoint_every=4,
                                     ckpt_dir=d))
    params, state = tr.fit(model, _data(), 4)
    jparams, _ = jinit_model(JTINY, jax.random.PRNGKey(1))
    jtmpl = {"params": jparams, "opt": joptim.init(jparams)}
    restored, step, extra = jckpt.restore_checkpoint(d, jtmpl)
    assert step == 4 and extra == {"data_step": 4}
    assert int(restored["opt"].count) == 4
    jp = jax_arrays(restored["params"])
    for key, t in convert.tensors_from_params(params).items():
        assert str(jp[key].dtype) == str(t.dtype).split(".")[-1], key
        np.testing.assert_array_equal(
            np.asarray(jp[key]).view(np.uint16)
            if t.dtype == torch.bfloat16 else jp[key],
            t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy(), err_msg=key)
    for field in ("mu", "nu"):
        jm = jax_arrays(getattr(restored["opt"], field))
        for key, a in convert.arrays_from_params(getattr(state, field),
                                                 TINY).items():
            np.testing.assert_array_equal(jm[key], a, err_msg=key)
    # the JAX trainer resumes from the port's checkpoint
    jt = JTrainer(JTINY, JTrainerConfig(opt=joptim.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=10), checkpoint_every=4,
        ckpt_dir=d))
    jt.fit(jparams, _jdata(), 6)
    assert [h["step"] for h in jt.history] == [4, 5]


def test_checkpoint_atomic_and_shape_checked(tmp_path):
    """tests/test_storage.py's two checkpoint cases on the port (a shape
    mismatch raises ValueError where the reference asserts)."""
    import os
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.int32)}}
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, 10, tree, extra={"note": "x"})
    checkpoint.save_checkpoint(d, 20, tree)
    assert checkpoint.latest_step(d) == 20
    restored, step, extra = checkpoint.restore_checkpoint(d, tree, step=10)
    assert step == 10 and extra["note"] == "x"
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    os.makedirs(os.path.join(d, "step_30.tmp"), exist_ok=True)
    assert checkpoint.latest_step(d) == 20
    # the same tree's keys are JAX's: JAX restores it
    jr, _, _ = jckpt.restore_checkpoint(
        d, {"a": jnp.zeros((3, 4)), "nested": {"b": jnp.zeros(5, jnp.int32)}})
    np.testing.assert_array_equal(np.asarray(jr["a"]), tree["a"].numpy())
    with pytest.raises(ValueError, match="a:"):
        checkpoint.restore_checkpoint(d, {"a": torch.ones(2, 2),
                                          "nested": tree["nested"]})


def test_arrays_from_params_inverts_params_from_arrays():
    jcfg, tcfg = _configs("recurrentgemma-2b", "bfloat16")
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    arrays = jax_arrays(params)
    model = convert.params_from_arrays(arrays, tcfg, "cpu")
    back = convert.arrays_from_params(model)
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        assert back[k].shape == a.shape
        np.testing.assert_array_equal(back[k], f32(a), err_msg=k)
    state = optim.init(model)
    arr = convert.arrays_from_opt_state(state, tcfg)
    again = convert.opt_state_from_arrays(arr, tcfg, "cpu")
    for field in ("mu", "nu"):
        got = {n: tuple(t.shape) for n, t in getattr(again, field).items()}
        assert got == {n: tuple(p.shape) for n, p in
                       model.named_parameters()}, field
    assert int(again.count) == 0 and again.count.dtype == torch.int32


# ---------------------------------------------------------------------------
# serving builds no graph; the launcher
# ---------------------------------------------------------------------------

def test_serving_entry_points_build_no_graph():
    from repro_torch.core.rag import RagConfig
    from repro_torch.launch.serve import build_rag_datastore
    from repro_torch.serving import Request, ServeEngine
    cfg = smoke_config(get_arch("llama3-8b").config)
    model = init_model(cfg, 0, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    tok = torch.randint(1, 64, (2, 6), generator=torch.Generator()
                        .manual_seed(0)).int()
    logits, hidden, cache = prefill(cfg, model, {"tokens": tok}, 16)
    assert not logits.requires_grad and not hidden.requires_grad
    lg, h, cache = decode_step(cfg, model, cache, tok[:, :1], 6)
    assert not lg.requires_grad and not h.requires_grad
    assert not any(t.requires_grad for c in cache.values()
                   for t in c.values())
    ds = build_rag_datastore(cfg, n=256, device="cpu")
    assert not ds.index.vectors.requires_grad
    eng = ServeEngine(cfg, model, slots=2, s_max=32, rag=ds,
                      rag_cfg=RagConfig(k=4, n_probe=2), device="cpu")
    eng.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=3))
    eng.run()
    assert not any(t.requires_grad for c in eng.cache.values()
                   for t in c.values())
    with torch.no_grad():
        assert not forward(cfg, model, {"tokens": tok})[0].requires_grad
    assert forward(cfg, model, {"tokens": tok})[0].requires_grad
    assert not init_cache(cfg, 1, 8, device="cpu")["p0"]["k"].requires_grad


def test_train_launcher_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("arch=llama3-8b-smoke params=")
    assert lines[1].startswith("loss ") and "over 3 steps" in lines[1]
