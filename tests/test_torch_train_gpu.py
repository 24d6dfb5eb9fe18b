"""Training on the card: each smoke arch's gradients and one AdamW step on
the card against the port on the CPU, two runs on the card bit for bit
(the MoE backward of phi3.5-moe and grok-1 included), checkpoint-resume
on the card, and a CPU-written checkpoint restored onto the card.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present. On a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_train_gpu.py

Tolerance (float32 models, TF32 off): each leaf's gradient within 1e-4 x
its max |g|, or within twice the CPU's own change of that leaf under a
1e-7 relative change of the embedding (a leaf whose exact gradient is
zero is rounding noise on both devices); xlstm-350m also rtol 0.1 (its
stack amplifies rounding ~2,000-fold: tests/test_torch_models.py); the
step's loss within 1e-5 relative, its grad_norm within 1e-4 relative.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.smoke import smoke_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import init_model, transformer
from repro_torch.storage import checkpoint
from repro_torch.train import Trainer, TrainerConfig, optim
from repro_torch.train.trainer import make_train_step

pytestmark = pytest.mark.gpu

ALL = ["llama3-8b", "gemma2-27b", "starcoder2-15b", "minitron-4b",
       "pixtral-12b", "phi3.5-moe", "grok-1-314b", "recurrentgemma-2b",
       "xlstm-350m", "whisper-medium"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(name, dtype, remat=False):
    cfg = smoke_config(get_arch(name).config)
    extra = dict(capacity_factor=float(cfg.n_experts)) if cfg.n_experts \
        else {}
    return dataclasses.replace(cfg, dtype=dtype, remat=remat, **extra)


def _batch(cfg, device, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32))}
    for key, n, on in (("img", cfg.num_img_tokens, cfg.num_img_tokens),
                       ("frames", cfg.enc_seq, cfg.encoder_layers)):
        if on:
            out[key] = torch.from_numpy((0.1 * rng.normal(
                size=(b, n, cfg.d_model))).astype(np.float32))
    return {k: v.to(device) for k, v in out.items()}


def _grads(cfg, model, batch):
    total, _ = transformer.loss_fn(cfg, model, batch)
    names = [n for n, _ in model.named_parameters()]
    return total.detach(), dict(zip(names, torch.autograd.grad(
        total, list(model.parameters()))))


@pytest.mark.parametrize("name", ALL)
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    cfg = _cfg(name, "float32")
    model = init_model(cfg, 0, device="cpu")
    cpu_batch, card_batch = _batch(cfg, "cpu"), _batch(cfg, cuda)
    l_cpu, g_cpu = _grads(cfg, model, cpu_batch)
    moved = copy.deepcopy(model)
    with torch.no_grad():
        moved.embed.table.mul_(1 + 1e-7)
    noise = {n: 2 * float((g - g_cpu[n]).abs().max())
             for n, g in _grads(cfg, moved, cpu_batch)[1].items()}
    card = copy.deepcopy(model).to(cuda)
    l_card, g_card = _grads(cfg, card, card_batch)
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
    rtol = 0.1 if cfg.family == "ssm" else 0.0
    for n, g in g_cpu.items():
        atol = max(1e-4 * float(g.abs().max()), noise[n])
        np.testing.assert_allclose(g_card[n].cpu().numpy(), g.numpy(),
                                   atol=atol, rtol=rtol, err_msg=n)
    # one whole step: loss, grad_norm and lr of the two devices
    step = make_train_step(cfg, TrainerConfig())
    _, _, m_cpu = step(model, optim.init(model), cpu_batch)
    _, _, m_card = step(card, optim.init(card), card_batch)
    np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_card["grad_norm"]),
                               float(m_cpu["grad_norm"]), rtol=1e-4)
    assert float(m_card["lr"]) == float(m_cpu["lr"])


def _digest(model, state):
    return [(n, p.detach().cpu().clone()) for n, p in model.named_parameters()] \
        + [(n, t.cpu().clone()) for n, t in state.mu.items()] \
        + [(n, t.cpu().clone()) for n, t in state.nu.items()]


@pytest.mark.parametrize("name", ["llama3-8b", "phi3.5-moe", "grok-1-314b",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_two_runs_on_the_card_are_bit_for_bit(cuda, name):
    """bfloat16 smoke configs with remat on: three Trainer steps twice
    from one model give the same losses and the same bits in every
    parameter and moment (the embedding's repeated rows and the MoE's
    top-2 copies meet in the backward pass in a fixed order)."""
    cfg = _cfg(name, "bfloat16", remat=True)
    model = init_model(cfg, 0, device=cuda)
    stream = TokenStream(vocab=cfg.vocab_size, batch=4, seq=32, seed=0)
    extra = {k: v for k, v in _batch(cfg, cuda, b=4, s=32).items()
             if k != "tokens"}

    def data(start):
        for b in stream.iter_from(start):
            yield dict(extra, tokens=torch.as_tensor(b["tokens"],
                                                     device=cuda))
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, TrainerConfig(opt=optim.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=3)))
        p, s = tr.fit(model, data, 3)
        runs.append(([h["loss"] for h in tr.history], _digest(p, s)))
    assert runs[0][0] == runs[1][0]
    for (n, a), (_, b) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b), n


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """llama3-8b's smoke config on the card: 20 straight steps equal 10
    steps, a save, a fresh Trainer and 10 more, bit for bit."""
    cfg = smoke_config(get_arch("llama3-8b").config)
    model = init_model(cfg, 0, device=cuda)
    stream = TokenStream(vocab=cfg.vocab_size, batch=2, seq=64, seed=0)

    def data(start):
        for b in stream.iter_from(start):
            yield {"tokens": torch.as_tensor(b["tokens"], device=cuda)}
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    full = Trainer(cfg, TrainerConfig(opt=opt))
    p_full, s_full = full.fit(model, data, 20)
    tcfg = TrainerConfig(opt=opt, checkpoint_every=10,
                         ckpt_dir=str(tmp_path / "ck"))
    Trainer(cfg, tcfg).fit(model, data, 10)
    tr = Trainer(cfg, tcfg)
    p_res, s_res = tr.fit(model, data, 20)
    assert tr.history[0]["step"] == 10
    assert [h["loss"] for h in tr.history] == \
        [h["loss"] for h in full.history[10:]]
    assert next(p_res.parameters()).device.type == "cuda"
    for (n, a), (_, b) in zip(_digest(p_full, s_full), _digest(p_res, s_res)):
        assert torch.equal(a, b), n


def test_cpu_checkpoint_restores_onto_the_card(cuda, tmp_path):
    cfg = smoke_config(get_arch("phi3.5-moe").config)
    model = init_model(cfg, 3, device="cpu")
    state = optim.init(model)
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, 7, {"params": model, "opt": state},
                               extra={"data_step": 7})
    tmpl = {"params": model, "opt": state}
    restored, step, extra = checkpoint.restore_checkpoint(d, tmpl,
                                                          device=cuda)
    assert step == 7 and extra == {"data_step": 7}
    assert int(restored["opt"].count) == 0
    for (n, a), b in zip(model.named_parameters(),
                         restored["params"].parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu()), n
