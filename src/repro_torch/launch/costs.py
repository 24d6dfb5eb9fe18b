"""Roofline terms of one traced step (port of repro.launch.costs).

Per (arch x shape x mesh), per device:
  compute term    = FLOPs / PEAK_FLOPS
  memory term     = bytes accessed / HBM_BW
  collective term = collective bytes / LINK_BW

The reference reads an XLA compiled module. Nothing is compiled here:
`trace` runs a step bound by `launch.steps.lower` once, on "meta" tensors
(shapes and dtypes, no memory) as rank 0 of a fake-backend world, under a
dispatch mode (`StepCounter`) that lets DTensor desugar each op and sees
what rank 0 runs: every op on its local shards, in the forward, the
backward and the update, and every collective DTensor issues:

  * FLOPs: torch.utils.flop_counter's formula for each local op with a
    rule (products, attention, convolutions): per device, replicated work
    counted on each device that does it;
  * bytes accessed: each local op's input tensors read once and its
    output written once (eager ops do not fuse, so this is an upper bound
    of what a fused XLA module moves).
  * collective bytes by kind: each functional collective's result bytes
    (all-reduce twice: the ring's reduce-scatter and all-gather phases),
    as the reference counts XLA's; calls are counted beside them.
  * memory (`memory_dict`): argument and output bytes from each rank's
    local shard shapes; the peak is the largest sum of live local storage
    bytes during the trace -- every storage an op creates stays live until
    the last reference to it (a tensor, a view, or autograd's saved
    activations) is gone, tracked by weak references and swept every
    `SWEEP_EVERY` ops (so the peak may include storages freed within the
    last sweep interval: an upper bound).

The hardware constants are the card's, not the reference's TPU v5e.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# NVIDIA H100 80GB HBM3 (SXM5), 700 W
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s of HBM3
HBM_BYTES = 80e9             # device memory (the reference's 16e9 v5e limit)
# NVLink 4 between H100s: 450 GB/s per direction. An assumption: the
# machine this port runs on has one card, so no link was measured.
LINK_BW = 450e9

_KINDS = {      # the functional collectives DTensor issues
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {       # the plain c10d calls (the sharded index's merges)
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

SWEEP_EVERY = 64


def _local(t):
    return getattr(t, "_local_tensor", t)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif hasattr(tree, "_fields"):               # a NamedTuple
        for v in tree:
            yield from _tensors(v)


def local_bytes(tree) -> int:
    """Bytes of each rank's local shards of every tensor in `tree`."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


class StepCounter:
    """Counts FLOPs, bytes accessed, collectives and live bytes of the ops
    run inside it (a TorchDispatchMode; see the module docstring)."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll_bytes = {k: 0 for k in _COLLECTIVES}
        self.coll_calls = {k: 0 for k in _COLLECTIVES}
        self.live = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._ops = 0
        self._registry = flop_registry

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented     # count its local ops instead
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                # DTensor's sharding propagation runs ops on fake global
                # tensors: shapes, not work
                if not any(issubclass(t, FakeTensor) for t in types):
                    counter._observe(func, args, kwargs, out)
                return out
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._sweep()

    def hold(self, tree) -> None:
        """Count the storages of `tree` (the step's arguments) as live."""
        for t in _tensors(tree):
            self._track(_local(t))
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        st = t.untyped_storage()
        key = st._cdata
        held = self.live.get(key)
        if held is not None and not held[0].expired():
            return
        if held is not None:
            self.live_bytes -= held[1]
        self.live[key] = (StorageWeakRef(st), st.nbytes())
        self.live_bytes += st.nbytes()

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.live_bytes -= self.live.pop(key)[1]

    def _observe(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        outs = list(_tensors(out))
        kind = _KINDS.get(name) if func.namespace == "_c10d_functional" \
            else _C10D.get(name) if func.namespace == "c10d" else None
        if kind is not None:
            # result bytes; a send's are the tensors it sends
            res = list(_tensors(args[0])) if name == "send" else outs
            nbytes = sum(t.numel() * t.element_size() for t in res)
            self.coll_bytes[kind] += nbytes * (2 if kind == "all-reduce"
                                               else 1)
            self.coll_calls[kind] += 1
        packet = func.overloadpacket
        if packet in self._registry and outs:
            self.flops += self._registry[packet](*args, **kwargs,
                                                 out_val=out)
        ins = [t for t in _tensors(list(args) + list(kwargs.values()))]
        self.bytes_accessed += local_bytes(ins) + local_bytes(outs)
        for t in outs:
            self._track(_local(t))
        self._ops += 1
        if self._ops % SWEEP_EVERY == 0:
            self._sweep()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)


@dataclasses.dataclass
class StepTrace:
    """What one traced step counted, per device."""
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    coll_calls: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int


def trace(lowered) -> StepTrace:
    """Run the bound step (`launch.steps.lower`) once uncounted, then once
    under a StepCounter, its arguments live from the start. (DTensor's
    first call of each op propagates its sharding on stand-ins of the
    global shape, which would count as work; the second call hits its
    cache. On "meta" the extra run costs only its dispatch.)"""
    args = lowered.args
    lowered()
    with StepCounter() as c:
        c.hold(args)
        out = lowered()
        c.hold(out)
    return StepTrace(flops=c.flops, bytes_accessed=c.bytes_accessed,
                     coll_bytes=dict(c.coll_bytes),
                     coll_calls=dict(c.coll_calls),
                     argument_bytes=local_bytes(args),
                     output_bytes=local_bytes(out),
                     peak_bytes=c.peak_bytes)


def collective_bytes(tr: StepTrace) -> Dict[str, int]:
    """Result bytes per collective kind (all-reduce counted twice)."""
    return dict(tr.coll_bytes)


@dataclasses.dataclass
class RooflineTerms:
    flops: float                  # per-device
    bytes_accessed: float         # per-device memory traffic
    coll_bytes: float             # per-device collective payload
    coll_breakdown: Dict[str, int]
    flops_correction: float = 0.0  # analytic scan-body corrections

    @property
    def t_compute(self) -> float:
        return (self.flops + self.flops_correction) / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "flops_correction": self.flops_correction,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def extract(tr: StepTrace, flops_correction: float = 0.0) -> RooflineTerms:
    coll = collective_bytes(tr)
    return RooflineTerms(
        flops=float(tr.flops),
        bytes_accessed=float(tr.bytes_accessed),
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        flops_correction=flops_correction,
    )


def memory_dict(tr: StepTrace) -> dict:
    """The reference's keys: arguments and outputs from the local shards;
    temp = the traced peak of live bytes beyond the larger of the two
    (parameters and moments are updated in place, as the reference's
    donated buffers alias its outputs); no generated code."""
    base = max(tr.argument_bytes, tr.output_bytes)
    temp = max(0, tr.peak_bytes - base)
    return {
        "argument_bytes": int(tr.argument_bytes),
        "output_bytes": int(tr.output_bytes),
        "temp_bytes": int(temp),
        "generated_code_bytes": 0,
        "peak_bytes_est": int(base + temp),
    }


def model_flops(cfg, shape, n_chips: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) per *device* per step.

    Train counts fwd+bwd (6ND); prefill counts forward only (2ND);
    decode counts one token (2*N_active per sequence)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens / n_chips
    return 2.0 * n_active * shape.global_batch / n_chips


def slstm_correction(cfg, shape, n_chips: int) -> float:
    """Analytic FLOPs of sequential sLSTM scan bodies x trip count."""
    from ..models.xlstm import slstm_analytic_flops
    n_slstm = sum(1 for k in cfg.layer_kinds() if k == "slstm")
    if n_slstm == 0:
        return 0.0
    seq = 1 if shape.kind == "decode" else shape.seq_len
    per_layer = slstm_analytic_flops(shape.global_batch, seq, cfg.d_model,
                                     cfg.num_heads)
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd
    return mult * n_slstm * per_layer / n_chips


def slope(u1: RooflineTerms, u2: RooflineTerms, count: int,
          flops_correction: float = 0.0) -> RooflineTerms:
    """Totals at `count` periods from depth-1 and depth-2 terms:
    U1 + (count - 1) * (U2 - U1)."""
    def ext(a, b):
        return a + (count - 1) * (b - a)
    return RooflineTerms(
        flops=ext(u1.flops, u2.flops),
        bytes_accessed=ext(u1.bytes_accessed, u2.bytes_accessed),
        coll_bytes=ext(u1.coll_bytes, u2.coll_bytes),
        coll_breakdown={k: int(ext(u1.coll_breakdown[k],
                                   u2.coll_breakdown[k]))
                        for k in u1.coll_breakdown},
        flops_correction=flops_correction)

