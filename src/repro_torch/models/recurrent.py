"""RG-LRU recurrent block (Griffin / recurrentgemma; port of
repro.models.recurrent).

Block: x -> [gate branch: GeLU(W_y x)] ⊙ [main: W_x x -> causal depthwise
conv1d(w=4) -> RG-LRU] -> W_o -> out.

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_a u_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)                  (input gate)
    log a_t = -c * softplus(Lambda) * r_t         (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ u_t)

The full sequence runs the recurrence as a log-depth doubling scan
(`layers.associative_scan`); decode is one step on O(D_rnn) state. The
dtypes follow the reference's, which differ by path: over the full
sequence u stays in the activation dtype (the conv sums shifts in it),
while decode forms u in float32, so its gate products promote to float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import (InitCtx, Params, associative_scan, cache_device, einsum,
                     gelu, matmul)
from .sharding import constrain_feature

RGLRU_C = 8.0


class RGLRU(Params):
    def __init__(self, ctx: InitCtx, dim: int, d_rnn: int,
                 conv_width: int = 4):
        super().__init__()
        self.wy = ctx.param((dim, d_rnn), ("embed", "rnn"))  # gate branch
        self.wx = ctx.param((dim, d_rnn), ("embed", "rnn"))  # main branch
        self.conv_w = ctx.param((conv_width, d_rnn), (None, "rnn"),
                                scale=1.0 / conv_width)
        self.conv_b = ctx.param((d_rnn,), ("rnn",), zeros=True)
        self.wa = ctx.param((d_rnn, d_rnn), ("rnn", "rnn_out"))  # r gate
        self.ba = ctx.param((d_rnn,), ("rnn",), zeros=True)
        self.wi = ctx.param((d_rnn, d_rnn), ("rnn", "rnn_out"))  # i gate
        self.bi = ctx.param((d_rnn,), ("rnn",), zeros=True)
        self.lam = ctx.param((d_rnn,), ("rnn",), scale=1.0,
                             dtype=torch.float32)
        self.wo = ctx.param((d_rnn, dim), ("rnn", "embed"))


def init_rglru_block(ctx: InitCtx, dim: int, d_rnn: int,
                     conv_width: int = 4) -> RGLRU:
    return RGLRU(ctx, dim, d_rnn, conv_width)


def _gates(p, u):
    r = torch.sigmoid(matmul(u, p.wa) + p.ba)
    i = torch.sigmoid(matmul(u, p.wi) + p.bi)
    log_a = -RGLRU_C * F.softplus(p.lam) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * u).float()
    return a, b


def _conv_full(p, u):
    """Causal depthwise conv over [B, S, D_rnn], in u's dtype."""
    w = p.conv_w
    width, s = w.shape[0], u.shape[1]
    out = torch.zeros_like(u)
    for j in range(width):
        shifted = F.pad(u, (0, 0, width - 1 - j, 0))[:, :s, :]
        out = out + shifted * w[j]
    return out + p.conv_b


def _linear_combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a1 * a2, a2 * b1 + b2


def rglru_block(p, x) -> torch.Tensor:
    """Full-sequence forward. x: [B, S, D] -> [B, S, D]. On a mesh the
    RNN-state activations shard on the feature dim (the time scan is
    elementwise in R, so it stays local)."""
    y = gelu(matmul(x, p.wy))
    u = constrain_feature(_conv_full(p, matmul(x, p.wx)))
    a, b = _gates(p, u)
    a, b = constrain_feature(a), constrain_feature(b)
    _, h = associative_scan(_linear_combine, (a, b), dim=1)
    return matmul((y.float() * h).to(x.dtype), p.wo)


def rglru_final_state(p, x) -> Dict[str, torch.Tensor]:
    """The decode state after the sequence x [B, S, D] (prefill's cache
    fill): the last h of the scan and the last conv_width - 1 raw inputs
    (zeros before the start), in float32."""
    raw = matmul(x, p.wx)
    _, h = associative_scan(_linear_combine, _gates(p, _conv_full(p, raw)),
                            dim=1)
    w = p.conv_w.shape[0]
    tail = F.pad(raw.float(), (0, 0, w - 1, 0))[:, -(w - 1):, :]
    return {"h": h[:, -1, :], "conv": tail}


def init_rglru_state(batch: int, d_rnn: int, conv_width: int = 4,
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero state on `device` (None means the card; "meta" allocates
    nothing)."""
    dev = cache_device(device)
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, conv_width - 1, d_rnn),
                                dtype=torch.float32, device=dev)}


def rglru_decode(p, x, state) -> Tuple[torch.Tensor, dict]:
    """One-token step. x: [B, 1, D] -> ([B, 1, D], new state)."""
    y = gelu(matmul(x, p.wy))            # [B, 1, R]
    u_raw = matmul(x, p.wx)[:, 0, :].float()                   # [B, R]
    hist = torch.cat([state["conv"], u_raw[:, None, :]], dim=1)
    u = einsum("bwr,wr->br", hist, p.conv_w.to(hist.dtype)) \
        + p.conv_b
    a, b = _gates(p, u)
    h = a * state["h"] + b
    out = matmul((y[:, 0, :].float() * h).to(x.dtype), p.wo)
    return out[:, None, :], {"h": h, "conv": hist[:, 1:, :]}
