"""The other four model families on the card: each smoke arch's forward
and decode on the card against the port on the CPU, the MoE combine's
bits over repeated runs, recurrentgemma's per-slot tail state in the
engine, and grok-1 serving at its smoke size.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present. On a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_families_gpu.py

Tolerance: bfloat16 models atol 0.15, rtol 0.1 (the card's and the CPU's
products round in other orders); xlstm-350m (the ssm family) in float32,
atol 1e-4, rtol 0.1, as the reference's own decode test runs it (its
stack amplifies rounding ~1,000-fold: tests/test_torch_models.py); engine
tokens equal (float32 weights, float32 products on both devices).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.smoke import smoke_config
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                moe)
from repro_torch.models.layers import InitCtx
from repro_torch.models.decode import fill_cache_from_forward
from repro_torch.serving import Request, ServeEngine

pytestmark = pytest.mark.gpu

FAMILIES = ["phi3.5-moe", "grok-1-314b", "recurrentgemma-2b", "xlstm-350m",
            "whisper-medium"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(name, dtype):
    cfg = smoke_config(get_arch(name).config)
    extra = dict(capacity_factor=float(cfg.n_experts)) if cfg.n_experts \
        else {}
    return dataclasses.replace(cfg, dtype=dtype, **extra)


def _batch(cfg, device, s=8):
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(
        rng.integers(1, 64, (2, s)).astype(np.int32))}
    if cfg.encoder_layers:
        b["frames"] = torch.from_numpy((0.1 * rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model))).astype(np.float32)).to(
            torch.bfloat16)
    return {k: v.to(device) for k, v in b.items()}


def _run(cfg, model, device):
    """Forward logits and 8 decode steps' logits on `device`."""
    batch = _batch(cfg, device)
    fwd = forward(cfg, model, batch)[0].detach()
    cache = init_cache(cfg, 2, 32, device=device)
    start = 0
    if cfg.encoder_layers:
        cache = fill_cache_from_forward(
            cfg, model, dict(batch, tokens=batch["tokens"][:, :1]), 32)
        start = 1
    steps = []
    for t in range(start, 8):
        lg, _, cache = decode_step(cfg, model, cache,
                                   batch["tokens"][:, t:t + 1], t)
        steps.append(lg)
    return fwd.float().cpu(), torch.stack(steps).float().cpu()


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_on_the_card_matches_the_cpu(cuda, name):
    ssm = get_arch(name).config.family == "ssm"
    cfg = _cfg(name, "float32" if ssm else "bfloat16")
    model = init_model(cfg, 0, device="cpu")
    cpu = _run(cfg, model, "cpu")
    card = _run(cfg, model.to(cuda), cuda)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   **(dict(atol=1e-4, rtol=0.1) if ssm
                                      else dict(atol=0.15, rtol=0.1)))


def test_moe_combine_is_bit_stable_on_the_card(cuda):
    cfg = get_arch("phi3.5-moe").config
    layer = moe.init_moe(InitCtx(torch.Generator(device=cuda).manual_seed(0),
                                 torch.bfloat16, cuda), 256, 512,
                         cfg.n_experts)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((8, 16, 256), generator=g, device=cuda).to(
        torch.bfloat16)
    y0, a0 = moe.moe(layer, x)
    for _ in range(10):
        y, a = moe.moe(layer, x)
        assert torch.equal(y, y0) and torch.equal(a, a0)
    perm = torch.tensor([3, 0, 7, 2, 1, 6, 5, 4], device=cuda)
    assert torch.equal(moe.moe(layer, x[perm])[0], y0[perm])


def _serve(cfg, model, device, prompts, slots=3):
    eng = ServeEngine(cfg, model, slots=slots, s_max=32, device=device)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _prompts(n):
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, 64, 3 + i % 4))) for i in range(n)]


def test_recurrentgemma_engine_keeps_each_slots_state(cuda):
    """The tail RG-LRU layer's state stays per slot on the card: a request
    alone gives its batched tokens, and the card's tokens equal the
    CPU's."""
    cfg = _cfg("recurrentgemma-2b", "float32")
    model = init_model(cfg, 0, device="cpu")
    prompts = _prompts(5)
    cpu = _serve(cfg, model, "cpu", prompts)
    model = model.to(cuda)
    batched = _serve(cfg, model, cuda, prompts)
    assert batched == cpu
    for i in (0, 4):
        assert _serve(cfg, model, cuda, [prompts[i]]) == [batched[i]]


def test_grok1_serves_on_the_card(cuda):
    cfg = _cfg("grok-1-314b", "float32")
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    model = init_model(cfg, 0, device="cpu")
    prompts = _prompts(4)
    cpu = _serve(cfg, model, "cpu", prompts)
    card = _serve(cfg, model.to(cuda), cuda, prompts)
    assert card == cpu
    assert all(0 <= t < cfg.vocab_size for o in card for t in o)
