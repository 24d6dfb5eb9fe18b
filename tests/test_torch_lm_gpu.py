"""The LM serving path on the card: ServeEngine on the card against the
port on the CPU, the three kernels at the model width d = 4096 (llama3-8b's
d_model) against their plain versions, and knn_logits run twice.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present. On a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_lm_gpu.py

Tolerance: scan scores within 1e-5 * (||q||^2 + max ||v||^2), ids equal
outside runs of tied scores (tests/test_torch_kernels_gpu.py); K2 over
precomputed norms bit for bit; the engine's tokens equal (float32 model,
float32 matrix products on both devices).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.smoke import smoke_config
from repro_torch.core import quantize
from repro_torch.core.rag import RagConfig, RagDatastore, knn_logits
from repro_torch.kernels import ivf_scan, kmeans_assign, sq_scan
from repro_torch.launch import serve
from repro_torch.models import init_model
from repro_torch.serving import Request, ServeEngine
from repro_torch.testing import compare_topk, score_tol

pytestmark = pytest.mark.gpu

D = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    return dataclasses.replace(smoke_config(get_arch("llama3-8b").config),
                               dtype="float32")


def _serve(cfg, device, with_rag):
    model = init_model(cfg, 0, device="cpu").to(device)
    ds = None
    if with_rag:
        cpu = serve.build_rag_datastore(cfg, n=1024, device="cpu")
        ds = RagDatastore(index=_to(cpu.index, device),
                          next_token=cpu.next_token.to(device))
    eng = ServeEngine(cfg, model, slots=3, s_max=64, rag=ds,
                      rag_cfg=RagConfig(k=8, n_probe=4, lam=0.3),
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=list(map(int, rng.integers(1, 64, 4))),
                    max_new_tokens=6) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def _to(index, device):
    """An index built on the CPU, moved to `device` leaf by leaf."""
    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: mv(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)
                or dataclasses.is_dataclass(getattr(x, f.name))})
        return x
    return mv(index)


@pytest.mark.parametrize("with_rag", [False, True], ids=["lm", "rag"])
def test_serve_engine_on_the_card_equals_the_cpu(cuda, with_rag):
    cfg = _cfg()
    assert _serve(cfg, cuda, with_rag) == _serve(cfg, "cpu", with_rag)


def _scan_inputs(dev, kp=24, p_max=64, n_q=8, n_probe=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    vec = torch.randn((kp, p_max, D), generator=g)
    valid = torch.rand((kp, p_max), generator=g) < 0.9
    ids = torch.arange(kp * p_max, dtype=torch.int32).reshape(kp, p_max)
    q = vec[torch.randint(0, kp, (n_q,), generator=g), 0] \
        + 0.1 * torch.randn((n_q, D), generator=g)
    parts = torch.stack([torch.randperm(kp, generator=g)[:n_probe]
                         for _ in range(n_q)])
    union = torch.unique(parts).to(torch.int32)
    qsel = (parts[:, :, None] == union[None, None, :].long()).any(1)
    x = dict(vec=vec, valid=valid, ids=ids, q=q, union=union, qsel=qsel)
    x = {k: v.to(dev) for k, v in x.items()}
    x["tol"] = score_tol(q.numpy(), float((vec ** 2).sum(-1).max()))
    return x


def _same(ref, got, tol):
    torch.cuda.synchronize()
    err, ok, bad = compare_topk(ref[0].cpu().numpy(), ref[1].cpu().numpy(),
                                got[0].cpu().numpy(), got[1].cpu().numpy(),
                                tol)
    assert ok, f"{bad} rows differ (max err {err:.3e})"
    return err


@pytest.mark.parametrize("with_qsel", [True, False], ids=["ann", "exact"])
def test_ivf_scan_kernel_at_model_width(cuda, with_qsel):
    x = _scan_inputs(cuda)
    qsel = x["qsel"] if with_qsel else None
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 16, "l2",
            qsel, None)
    before = ivf_scan.LAUNCHES
    got = ivf_scan.ivf_scan_topk(*args[:6], qsel=qsel)
    assert ivf_scan.LAUNCHES == before + 1
    _same(ivf_scan.ivf_scan_plain(*args), got, x["tol"])


def test_sq_scan_kernel_at_model_width(cuda):
    x = _scan_inputs(cuda, seed=1)
    st = quantize.train(x["vec"].reshape(-1, D))
    codes = quantize.encode(st, x["vec"])
    q_i8, alpha, beta = quantize.fold_queries(st, x["q"])
    for norms in (quantize.row_norms(st, codes), None):
        args = (q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"], None,
                x["union"], 64, "l2", x["qsel"], None, norms)
        got = sq_scan.sq_scan_folded(*args[:10], qsel=x["qsel"], norms=norms)
        err = _same(sq_scan.sq_scan_plain(*args), got, x["tol"])
        if norms is not None:
            assert err == 0.0      # exact accumulators, same epilogue order


def test_kmeans_assign_kernel_at_model_width(cuda):
    g = torch.Generator().manual_seed(2)
    cents = (torch.randn((600, D), generator=g) * 3).to(cuda)
    batch = cents[torch.randint(0, 600, (700,), generator=g).to(cuda)] \
        + torch.randn((700, D), generator=g).to(cuda)
    zero = torch.zeros((600,), device=cuda)
    a_k, c_k = kmeans_assign.kmeans_assign(batch, cents, zero)
    a_r, c_r = kmeans_assign.kmeans_assign_plain(batch, cents, zero)
    torch.cuda.synchronize()
    tol = 1e-5 * (torch.sum(batch ** 2, -1)
                  + float(torch.sum(cents ** 2, -1).max()))
    assert bool(((c_r - c_k).abs() <= tol).all())
    assert float((a_r == a_k).float().mean()) >= 0.999


def test_knn_logits_is_deterministic_on_the_card(cuda):
    cfg = dataclasses.replace(_cfg(), d_model=D)
    vecs = np.random.default_rng(3).normal(size=(2048, D)).astype(np.float32)
    # the recipe draws these rows from the same seed
    ds = serve.build_rag_datastore(cfg, n=2048, seed=3, device=cuda)
    # neighbours that share tokens, so the sums meet in one entry
    ds.next_token = (ds.next_token % 7).to(torch.int32)
    h = torch.from_numpy(vecs[:16] + 0.01).to(cuda)
    a = knn_logits(ds, h, cfg.vocab_size, RagConfig())
    b = knn_logits(ds, h, cfg.vocab_size, RagConfig())
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a).all())
