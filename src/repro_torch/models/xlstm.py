"""xLSTM blocks: mLSTM (matrix memory, parallelisable) + sLSTM (scalar
memory with recurrent mixing); port of repro.models.xlstm.

mLSTM -- parallel form for the full sequence (exact, stabilised in log
space), O(1)-state recurrent form for decode:

    C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t^T q_t / max(|n_t^T q_t|, exp(-m_t))

with exponential input gate i = exp(~i), log-sigmoid forget gate, and
the max-stabiliser m_t (0 at init). `mlstm_block_chunked` is quadratic
inside a chunk and runs the stabilised linear recurrence across chunks
as a doubling scan (`layers.associative_scan`).

sLSTM -- scalar memory with recurrent gate mixing (R h_{t-1} inside the
gates) is sequential: a loop over time. Its state is the reference's
4-tuple (c, n, h, m), named by those letters here; h is [B, H, hd].

Block layout follows xLSTM: pre-LN, mLSTM block = up-proj x2 -> cell
gated by a SiLU branch -> down-proj; sLSTM block = cell -> GLU
projection (factor 4/3).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import (InitCtx, Params, associative_scan, cache_device, einsum,
                     einsum_f32, gelu, matmul)
from .sharding import constrain_seq_replicated, loop_once, reshape


def _log_sigmoid(x):
    """F.logsigmoid; on a DTensor -softplus(-x) (DTensor has no sharding
    rule for logsigmoid's backward)."""
    return -F.softplus(-x) if hasattr(x, "device_mesh") else F.logsigmoid(x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(Params):
    def __init__(self, ctx: InitCtx, dim: int, n_heads: int,
                 proj_factor: float = 2.0):
        super().__init__()
        d_inner = int(dim * proj_factor)
        hd = d_inner // n_heads
        f32 = torch.float32
        qkv = ("rnn", "heads", "head_dim")
        self.w_up = ctx.param((dim, d_inner), ("embed", "rnn"))
        self.w_gate = ctx.param((dim, d_inner), ("embed", "rnn"))
        self.wq = ctx.param((d_inner, n_heads, hd), qkv)
        self.wk = ctx.param((d_inner, n_heads, hd), qkv)
        self.wv = ctx.param((d_inner, n_heads, hd), qkv)
        self.wi = ctx.param((d_inner, n_heads), ("rnn", "heads"), scale=0.02,
                            dtype=f32)
        self.bi = ctx.param((n_heads,), ("heads",), zeros=True, dtype=f32)
        self.wf = ctx.param((d_inner, n_heads), ("rnn", "heads"), scale=0.02,
                            dtype=f32)
        self.bf = ctx.param((n_heads,), ("heads",), ones=True, dtype=f32)
        self.gn_scale = ctx.param((d_inner,), ("rnn",), ones=True, dtype=f32)
        self.w_down = ctx.param((d_inner, dim), ("rnn", "embed"))


def init_mlstm_block(ctx: InitCtx, dim: int, n_heads: int,
                     proj_factor: float = 2.0) -> MLSTM:
    return MLSTM(ctx, dim, n_heads, proj_factor)


def _mlstm_qkvif(p, x):
    u = matmul(x, p.w_up)                                  # [B,S,di]
    q = einsum("bsd,dhk->bshk", u, p.wq)
    k = einsum("bsd,dhk->bshk", u, p.wk)
    v = einsum("bsd,dhk->bshk", u, p.wv)
    uf = u.float()
    log_i = uf @ p.wi + p.bi                            # [B,S,H]
    log_f = _log_sigmoid(uf @ p.wf + p.bf)              # [B,S,H]
    gate = F.silu(matmul(x, p.w_gate))
    return u, q, k, v, log_i, log_f, gate


def _head_norm(h, n_heads: int, scale):
    """Per-head normalisation over the flattened head outputs, in float32,
    times `scale` (float32 result)."""
    b, s, di = h.shape
    hf = reshape(h.float(), (b, s, n_heads, di // n_heads))
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, unbiased=False)
    hf = (hf - mu) * torch.rsqrt(var + 1e-6)
    return reshape(hf, (b, s, di)) * scale


def _groupnorm(p, h, n_heads: int):
    return _head_norm(h, n_heads, p.gn_scale).to(h.dtype)


def _causal(logw, mask):
    return torch.where(mask, logw, torch.full((), -float("inf"),
                                              device=logw.device))


def mlstm_block(p, x) -> torch.Tensor:
    """Parallel (quadratic) exact form. x: [B, S, D]."""
    b, s, _ = x.shape
    n_heads = p.wi.shape[1]
    u, q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, x)
    hd = q.shape[-1]

    Fc = torch.cumsum(log_f, dim=1)                     # [B,S,H]
    # log weight of source s' at target t: F_t - F_s' + log_i_s' (t >= s')
    logw = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    logw = _causal(logw, tri[None, :, :, None])         # [B,T,S',H]
    m = logw.amax(dim=2, keepdim=True)                  # [B,T,1,H]
    w = torch.exp(logw - m)

    scores = einsum_f32("bthk,bshk->btsh", q, k) * (hd ** -0.5)
    scores = scores * w
    denom = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    hidden = einsum("btsh,bshk->bthk", scores.to(v.dtype), v)
    hidden = hidden / torch.clamp(denom[..., None], min=1e-6) \
        .to(hidden.dtype)
    hidden = _groupnorm(p, reshape(hidden, (b, s, -1)), n_heads) * gate
    return matmul(hidden, p.w_down)


def _chunk_combine(e1, e2):
    a1, m1, C1, n1 = e1
    a2, m2, C2, n2 = e2
    m = torch.maximum(m1 + a2, m2)
    s1 = torch.exp(m1 + a2 - m)
    s2 = torch.exp(m2 - m)
    return (a1 + a2, m, s1[..., None, None] * C1 + s2[..., None, None] * C2,
            s1[..., None] * n1 + s2[..., None] * n2)


def _shift_in(t, fill: float):
    """The state entering each chunk: the scan's value of the chunk before
    (`fill` for the first)."""
    return torch.cat([torch.full_like(t[:, :1], fill), t[:, :-1]], dim=1)


def mlstm_block_chunked(p, x, chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM: O(S*chunk) time and memory instead of the
    quadratic form's O(S^2); the same stabilised math. Within a chunk the
    quadratic form; across chunks the stabilised linear recurrence on the
    (C, n) state. S must divide by `chunk` (ValueError otherwise)."""
    b, s, _ = x.shape
    n_heads = p.wi.shape[1]
    u, q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, x)
    hd = q.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk

    def cs(a):                       # [B,S,...] -> [B,nc,L,...]
        return reshape(a, (b, nc, chunk) + tuple(a.shape[2:]))

    qc = cs(q) * (hd ** -0.5)
    kc, vc = cs(k), cs(v)
    lic, lfc = cs(log_i.float()), cs(log_f.float())

    Fc = torch.cumsum(lfc, dim=2)                       # [B,nc,L,H]
    a_tot = Fc[:, :, -1, :]                             # decay per chunk

    # per-chunk state contribution, stabilised by mloc: source t weighs
    # exp(a_tot - F_t + log_i_t)
    w_src = a_tot[:, :, None, :] - Fc + lic             # [B,nc,L,H]
    mloc = w_src.amax(dim=2)                            # [B,nc,H]
    wsrc = torch.exp(w_src - mloc[:, :, None, :])
    kf, vf = kc.float(), vc.float()
    C_con = einsum("bnlh,bnlhk,bnlhv->bnhkv", wsrc, kf, vf)
    n_con = einsum("bnlh,bnlhk->bnhk", wsrc, kf)

    _, M, Cs, Ns = associative_scan(_chunk_combine,
                                    (a_tot, mloc, C_con, n_con), dim=1)
    M_in = _shift_in(M, -float("inf"))
    C_in, N_in = _shift_in(Cs, 0.0), _shift_in(Ns, 0.0)

    # the inter-chunk state beside the chunk's local quadratic part
    logw = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] \
        + lic[:, :, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    logw = _causal(logw, tri[None, None, :, :, None])
    mrow = logw.amax(dim=3)                             # [B,nc,L,H]
    m_state = M_in[:, :, None, :] + Fc                  # [B,nc,L,H]
    m_tot = torch.maximum(mrow, m_state)
    w_loc = torch.exp(logw - m_tot[:, :, :, None, :])
    w_sta = torch.exp(m_state - m_tot)

    scores = einsum_f32("bnthk,bnshk->bntsh", qc, kc) * w_loc
    num_loc = einsum("bntsh,bnshv->bnthv", scores, vf)
    den_loc = scores.sum(dim=3)                         # [B,nc,L,H]
    qf = qc.float()
    num_sta = einsum("bnthk,bnhkv->bnthv", qf, C_in) \
        * w_sta[..., None]
    den_sta = einsum("bnthk,bnhk->bnth", qf, N_in) * w_sta

    num = num_loc + num_sta
    den = torch.maximum((den_loc + den_sta).abs(), torch.exp(-m_tot))
    hidden = reshape(num / torch.clamp(den[..., None], min=1e-6),
                     (b, s, -1))
    hidden = _groupnorm(p, hidden.to(x.dtype), n_heads) * gate
    return matmul(hidden, p.w_down)


def mlstm_final_state(p, x) -> Dict[str, torch.Tensor]:
    """The decode state (C, n, m) after the sequence x [B, S, D], from the
    parallel form (prefill's cache fill)."""
    _, q, k, v, log_i, log_f, _ = _mlstm_qkvif(p, x)
    hd = q.shape[-1]
    Fc = torch.cumsum(log_f, dim=1)
    w_src = Fc[:, -1:, :] - Fc + log_i                  # [B,S,H]
    m = w_src.amax(dim=1)                               # [B,H]
    w = torch.exp(w_src - m[:, None, :])
    kf = k.float() * (hd ** -0.5)
    C = einsum("bsh,bshk,bshv->bhkv", w, kf, v.float())
    n = einsum("bsh,bshk->bhk", w, kf)
    return {"C": C, "n": n, "m": m}


def init_mlstm_state(batch: int, dim: int, n_heads: int,
                     proj_factor: float = 2.0, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Zero state (m = 0) on `device` (None means the card)."""
    d_inner = int(dim * proj_factor)
    hd = d_inner // n_heads
    dev = cache_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return {"C": z(batch, n_heads, hd, hd), "n": z(batch, n_heads, hd),
            "m": z(batch, n_heads)}


def mlstm_decode(p, x, state) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step. x: [B, 1, D] -> ([B, 1, D], new state)."""
    n_heads = p.wi.shape[1]
    _, q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                 # [B,H,hd]
    log_i, log_f = log_i[:, 0], log_f[:, 0]             # [B,H]
    hd = q.shape[-1]

    m_new = torch.maximum(log_f + state["m"], log_i)
    fp = torch.exp(log_f + state["m"] - m_new)
    ip = torch.exp(log_i - m_new)
    kf = k.float() * (hd ** -0.5)
    C = fp[..., None, None] * state["C"] + ip[..., None, None] \
        * einsum("bhk,bhv->bhkv", kf, v.float())
    n = fp[..., None] * state["n"] + ip[..., None] * kf

    qf = q.float()
    num = einsum("bhkv,bhk->bhv", C, qf)
    den = torch.maximum(einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
    h = reshape(num / torch.clamp(den[..., None], min=1e-6),
                (x.shape[0], 1, -1))
    h = _groupnorm(p, h.to(x.dtype), n_heads) * gate
    return matmul(h, p.w_down), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


class SLSTM(Params):
    def __init__(self, ctx: InitCtx, dim: int, n_heads: int,
                 ff_factor: float = 4.0 / 3.0):
        super().__init__()
        hd = dim // n_heads
        d_ff = int(dim * ff_factor)
        for g in GATES:
            setattr(self, f"w_{g}", ctx.param((dim, dim), ("embed", "rnn")))
            setattr(self, f"r_{g}", ctx.param(
                (n_heads, hd, hd), ("heads", "head_dim", "head_dim"),
                scale=0.5 / hd ** 0.5))
            setattr(self, f"b_{g}", ctx.param((dim,), ("rnn",), zeros=True,
                                              dtype=torch.float32))
        self.gn_scale = ctx.param((dim,), ("rnn",), ones=True,
                                  dtype=torch.float32)
        self.w_up = ctx.param((dim, d_ff), ("embed", "ff"))
        self.w_gate = ctx.param((dim, d_ff), ("embed", "ff"))
        self.w_down = ctx.param((d_ff, dim), ("ff", "embed"))


def init_slstm_block(ctx: InitCtx, dim: int, n_heads: int,
                     ff_factor: float = 4.0 / 3.0) -> SLSTM:
    return SLSTM(ctx, dim, n_heads, ff_factor)


def _slstm_scan(p, wx, n_heads: int, state):
    """wx: {gate: W x [B, S, D]}; state {c, n, h [B, H, hd], m}; a loop
    over S. -> (h [B, S, D] float32, final state)."""
    b, s, d = wx["z"].shape
    hd = d // n_heads
    r = {g: getattr(p, f"r_{g}").float() for g in GATES}
    bias = {g: getattr(p, f"b_{g}") for g in GATES}
    xs = {g: wx[g].float() for g in GATES}
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    # the dry-run's cost trace runs the body once (costs.slstm_correction
    # adds the rest, as for the reference's while-loop body)
    for t in range(1 if loop_once() else s):
        pre = {g: xs[g][:, t] + reshape(einsum("bhk,hkj->bhj", h, r[g]),
                                        (b, d)) + bias[g] for g in GATES}
        z = torch.tanh(pre["z"])
        log_i = pre["i"]
        log_f = _log_sigmoid(pre["f"])
        o = torch.sigmoid(pre["o"])
        m_new = torch.maximum(log_f + m, log_i)
        fp = torch.exp(log_f + m - m_new)
        ip = torch.exp(log_i - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h_flat = o * c / torch.clamp(n, min=1e-6)
        h, m = reshape(h_flat, (b, n_heads, hd)), m_new
        hs.append(h_flat)
    return torch.stack(hs * (s // len(hs)), dim=1), \
        {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(batch: int, dim: int, n_heads: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Zero state {c, n, h, m} (the reference's tuple order) on `device`
    (None means the card)."""
    dev = cache_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return {"c": z(batch, dim), "n": z(batch, dim),
            "h": z(batch, n_heads, dim // n_heads), "m": z(batch, dim)}


def _slstm_norm(p, h, n_heads: int):
    return _head_norm(h, n_heads, p.gn_scale)


def _slstm_out(p, x, h, n_heads: int):
    h = _slstm_norm(p, h, n_heads).to(x.dtype)
    up = gelu(matmul(h, p.w_up)) * matmul(h, p.w_gate)
    return matmul(up, p.w_down)


def slstm_block(p, x, n_heads: int) -> torch.Tensor:
    x = constrain_seq_replicated(x)   # the time loop needs the sequence
    b, _, d = x.shape
    wx = {g: matmul(x, getattr(p, f"w_{g}")) for g in GATES}
    h, _ = _slstm_scan(p, wx, n_heads,
                       init_slstm_state(b, d, n_heads, device=x.device))
    return _slstm_out(p, x, h, n_heads)


def slstm_decode(p, x, state, n_heads: int) -> Tuple[torch.Tensor, dict]:
    wx = {g: matmul(x, getattr(p, f"w_{g}")) for g in GATES}
    h, new_state = _slstm_scan(p, wx, n_heads, state)
    return _slstm_out(p, x, h, n_heads), new_state


def slstm_final_state(p, x, n_heads: int) -> Dict[str, torch.Tensor]:
    """The decode state after the sequence x [B, S, D]: the scan from
    zeros (prefill's cache fill)."""
    b, _, d = x.shape
    wx = {g: matmul(x, getattr(p, f"w_{g}")) for g in GATES}
    return _slstm_scan(p, wx, n_heads,
                       init_slstm_state(b, d, n_heads, device=x.device))[1]


def slstm_analytic_flops(batch: int, seq: int, dim: int, n_heads: int) -> float:
    """Analytic FLOPs of the sLSTM time loop: 4 recurrent matvecs per step
    x the trip count (the reference's roofline correction, where XLA counts
    a while-loop body once)."""
    hd = dim // n_heads
    per_step = 4 * (2 * n_heads * hd * hd) * batch   # 4 recurrent matvecs
    return float(per_step * seq)
