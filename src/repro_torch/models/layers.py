"""Parameters and common layers of the model zoo (port of
repro.models.layers).

A model is a tree of `nn.Module`s whose leaves are the JAX package's
parameter leaves under the same names and shapes (`attn.wq` is
[d, H, hd], `mlp.wi.w` is [d, d_ff]), so carrying weights across is a
plain copy (convert.params_from_arrays). The functions keep the
reference's names and take the module where the reference takes its
parameter dict. Parameters are trainable (`nn.Parameter`'s default):
serving callers run under `torch.no_grad()` themselves, so decode builds
no autograd graph, while `transformer.loss_fn` differentiates the same
model.

Every random draw goes through an explicit `torch.Generator` on the
parameters' device; the port draws other numbers than `jax.random` from
the same seed, so parity tests carry the JAX weights over instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import resolve_device


@dataclasses.dataclass
class InitCtx:
    """Carries the generator, dtype and device; abstract=True allocates
    on the "meta" device (shapes and dtypes only, no memory)."""
    generator: Optional[torch.Generator]
    param_dtype: torch.dtype = torch.bfloat16
    device: Optional[torch.device] = None
    abstract: bool = False

    def param(self, shape: Sequence[int], axes: Tuple[Optional[str], ...],
              scale: Optional[float] = None, zeros: bool = False,
              ones: bool = False, dtype: Optional[torch.dtype] = None
              ) -> nn.Parameter:
        """A parameter of `shape` carrying its logical axis names `axes`
        (the reference's spec of the leaf; a `Params` module records them
        under the attribute it is assigned to)."""
        dtype = dtype or self.param_dtype
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        if self.abstract:
            v = torch.empty(shape, dtype=dtype, device="meta")
        elif zeros:
            v = torch.zeros(shape, dtype=dtype, device=self.device)
        elif ones:
            v = torch.ones(shape, dtype=dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) else 1
                scale = 1.0 / max(1, fan_in) ** 0.5
            # truncated normal on [-2, 2], drawn in float32, scaled by
            # fan-in, then cast (the reference's recipe)
            v = torch.empty(shape, dtype=torch.float32, device=self.device)
            nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                  generator=self.generator)
            v = v.mul_(scale).to(dtype)
        p = nn.Parameter(v)
        p._logical_axes = tuple(axes)
        return p


class Params(nn.Module):
    """A module of parameters: assigning it a parameter made by
    `InitCtx.param` records that parameter's logical axes in
    `param_axes[attribute name]`, kept with the module through copies,
    `to_empty` and checkpoint restores (models.sharding.logical_axes
    reads them)."""

    def __setattr__(self, name, value):
        axes = getattr(value, "_logical_axes", None)
        if axes is not None:
            self.__dict__.setdefault("param_axes", {})[name] = axes
        super().__setattr__(name, value)


def cache_device(device) -> torch.device:
    """A cache's device: "meta" (shapes and dtypes only, for
    configs.inputs.decode_specs) or resolve_device's answer."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def promote(*ts: torch.Tensor):
    """JAX's implicit dtype promotion for a product: torch's products want
    equal dtypes."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


def _sharded(ts) -> bool:
    return any(hasattr(t, "device_mesh") for t in ts)


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """torch.einsum after `promote`; on DTensors shard-locally
    (sharding.einsum)."""
    ts = promote(*ts)
    if _sharded(ts):
        from .sharding import einsum as sharded_einsum
        return sharded_einsum(eq, *ts)
    return torch.einsum(eq, *ts)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`preferred_element_type=float32`: exact products of the inputs
    summed in float32, with a float32 result."""
    return einsum(eq, a.float(), b.float())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] after `promote` (an einsum on DTensors)."""
    if _sharded((a, b)):
        return einsum("...k,kn->...n", a, b)
    return torch.matmul(*promote(a, b))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(Params):
    """rmsnorm (`scale`) or layernorm (`scale`, `bias`), float32 params."""

    def __init__(self, ctx: InitCtx, kind: str, dim: int):
        super().__init__()
        self.kind = kind
        self.scale = ctx.param((dim,), ("embed",), ones=True,
                               dtype=torch.float32)
        if kind != "rmsnorm":
            self.bias = ctx.param((dim,), ("embed",), zeros=True,
                                  dtype=torch.float32)

    def forward(self, x):
        return apply_norm(self.kind, self, x)


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * p.scale).to(dt)


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias).to(dt)


def apply_norm(kind: str, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def init_norm(ctx: InitCtx, kind: str, dim: int) -> Norm:
    return Norm(ctx, kind, dim)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Table(Params):
    """A lookup table (`table` [rows, dim]): token embedding (axes
    ("vocab", "embed")) or learned positions ((None, "embed"))."""

    def __init__(self, ctx: InitCtx, rows: int, dim: int, scale: float,
                 axes: Tuple[Optional[str], ...] = (None, "embed")):
        super().__init__()
        self.table = ctx.param((rows, dim), axes, scale=scale)


def init_embed(ctx: InitCtx, vocab: int, dim: int) -> Table:
    return Table(ctx, vocab, dim, scale=1.0, axes=("vocab", "embed"))


def embed(p, tokens, dim: int):
    # plain lookup; models that scale by sqrt(dim) do it at the call site
    return p.table[tokens]


def unembed_logits(p, x):
    """Tied unembedding: [.., D] @ [V, D]^T -> [.., V]."""
    return einsum("...d,vd->...v", x, p.table)


class Unembed(Params):
    def __init__(self, ctx: InitCtx, vocab: int, dim: int):
        super().__init__()
        self.w = ctx.param((dim, vocab), ("embed", "vocab"))


def init_unembed(ctx: InitCtx, vocab: int, dim: int) -> Unembed:
    return Unembed(ctx, vocab, dim)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

class Dense(Params):
    def __init__(self, ctx: InitCtx, d_in: int, d_out: int,
                 axes=("embed", "ff"), bias: bool = False):
        super().__init__()
        self.w = ctx.param((d_in, d_out), axes)
        self.b = ctx.param((d_out,), (axes[1],), zeros=True) \
            if bias else None


def init_dense(ctx: InitCtx, d_in: int, d_out: int, axes=("embed", "ff"),
               bias: bool = False) -> Dense:
    return Dense(ctx, d_in, d_out, axes, bias=bias)


def dense(p, x):
    y = matmul(x, p.w)
    if p.b is not None:
        y = y + p.b
    return y


class MLP(nn.Module):
    """act: silu_glu (llama) | gelu_glu (gemma) | relu2 (minitron) |
    gelu (starcoder2)."""

    def __init__(self, ctx: InitCtx, dim: int, d_ff: int, act: str,
                 bias: bool = False):
        super().__init__()
        self.wi = init_dense(ctx, dim, d_ff, ("embed", "ff"), bias=bias)
        self.wo = init_dense(ctx, d_ff, dim, ("ff", "embed"), bias=bias)
        self.wg = init_dense(ctx, dim, d_ff, ("embed", "ff"), bias=bias) \
            if act.endswith("_glu") else None


def init_mlp(ctx: InitCtx, dim: int, d_ff: int, act: str,
             bias: bool = False) -> MLP:
    return MLP(ctx, dim, d_ff, act, bias=bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation, op by op as the
    reference forms it: in bfloat16 each op rounds, as XLA's do (the fused
    F.gelu rounds once and differs in ~8 % of bfloat16 outputs)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def mlp(p, x, act: str):
    h = dense(p.wi, x)
    if act == "silu_glu":
        h = F.silu(dense(p.wg, x)) * h
    elif act == "gelu_glu":
        h = gelu(dense(p.wg, x)) * h
    elif act == "relu2":  # nemotron/minitron squared ReLU
        h = torch.square(F.relu(h))
    else:
        h = gelu(h)
    return dense(p.wo, h)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The rotation's [hd/2] frequencies on `device` (None means the
    card; "meta" gives the shape only)."""
    return _freqs(head_dim, float(theta), cache_device(device))


@functools.lru_cache(maxsize=32)
def _freqs(head_dim: int, theta: float, device: torch.device):
    # one table per (width, theta, device): every layer of every decode
    # step reads the same one (callers never write it)
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) [B, S, 1, hd/2] of the rotation at `positions` [B, S]."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # [hd/2]
    ang = positions[..., None].float() * freqs              # [B, S, hd/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs) of x [B, S, H, hd], in
    float32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] absolute token positions."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def associative_scan(fn, elems, dim: int = 1):
    """Inclusive scan of the associative `fn` over `dim` of every tensor in
    the tuple `elems` (`lax.associative_scan`'s result): a log-depth
    doubling scan (Hillis-Steele), where round r combines each element
    with the one 2^r before it. The combine tree differs from XLA's, so
    float results agree with the reference up to summation order."""
    n = elems[0].shape[dim]
    step = 1
    while step < n:
        lo = tuple(e.narrow(dim, 0, n - step) for e in elems)
        hi = tuple(e.narrow(dim, step, n - step) for e in elems)
        elems = tuple(torch.cat([e.narrow(dim, 0, step), c], dim)
                      for e, c in zip(elems, fn(lo, hi)))
        step *= 2
    return elems


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap and cap > 0:
        return cap * torch.tanh(x.float() / cap)
    return x
