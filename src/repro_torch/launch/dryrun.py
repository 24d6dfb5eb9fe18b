"""Multi-pod dry-run (port of repro.launch.dryrun): trace every
(arch x shape x mesh) cell on a fake-backend world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --micronn

The process joins a fake-backend world (torch.testing's FakeStore: every
collective returns at once and moves nothing) as rank 0 of 256 (one pod,
a (16, 16) mesh) or 512 ranks (two pods, (2, 16, 16)), places the cell's
arguments on "meta" (shapes only) under their DTensor placements, and
traces one step (launch.costs): FLOPs, bytes, collectives by kind and the
live-bytes peak, per device, against the H100's constants. Each record
(the reference's keys) is appended to --out (default
results/dryrun_torch.json); skip rules are recorded as skip rows, and an
error is a record with status "error". The CLI exits 1 if any cell erred.

Nothing compiles, so `compile_s` holds the time of the full-depth
placement and `slope_s` that of the traces. The stack runs unrolled; the
sLSTM's time loop runs its body once in the trace (`sharding.loop_once`),
and `flops_correction` adds the whole loop analytically
(`costs.slstm_correction`), as the reference does for XLA's while-loop
body.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import SHAPES, arch_names, get_arch, shape_applicable
from . import costs, steps
from .mesh import make_production_mesh


FAKE_BACKEND = "cpu:fake,meta:fake"   # "meta": the plain c10d calls of
                                      # the sharded index's merges


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake-backend world of `size` ranks
    (a world of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == FAKE_BACKEND:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0,
                            world_size=size)


def _mesh(multi_pod: bool):
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _depth_arch(arch, j: int):
    """Same arch at j period-repeats of depth (+ the tail, which belongs
    to the intercept), for cost slope fitting."""
    cfg = arch.config
    period = len(cfg.stack_period)
    tail = len(cfg.tail_kinds)
    enc_per = cfg.encoder_layers // cfg.stack_count if cfg.encoder_layers \
        else 0
    return dataclasses.replace(
        arch, config=dataclasses.replace(
            cfg, num_layers=j * period + tail,
            encoder_layers=j * enc_per,
            scan_layers=False))


def _trace_cell(arch, shape, mesh, exact_attn: bool = False):
    lw = steps.build(arch, shape, mesh, exact_attn=exact_attn)
    lw.rules = dict(lw.rules, loop_once=True)
    return costs.trace(steps.lower(lw, mesh))


def _n_chips(mesh) -> int:
    import math
    return math.prod(mesh.shape)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             scan: bool = None, verbose: bool = True) -> dict:
    """Trace one cell and extract its roofline terms.

    Where the stack repeats (stack_count > 1, unless scan=False asks for
    the whole depth), depth-1 and depth-2 traces give exact totals by the
    reference's slope, total = U1 + (count-1)*(U2 - U1), for the terms and
    the live-bytes temporaries; the arguments are counted on the full
    model. Otherwise the full depth is traced ("unrolled-exact")."""
    arch = get_arch(arch_name)
    cfg = arch.config
    shape = SHAPES[shape_name]
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": "x".join(map(str, (2, 16, 16) if multi_pod
                                else (16, 16))),
           "n_chips": 512 if multi_pod else 256, "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[skip] {arch_name} x {shape_name}: {why}")
        return rec
    count = cfg.stack_count
    use_slope = count > 1 if scan is None else scan
    try:
        mesh = _mesh(multi_pod)
        n_chips = _n_chips(mesh)
        t0 = time.time()
        full = steps.lower(steps.build(arch, shape, mesh), mesh)
        arg_bytes = costs.local_bytes(full.args)
        del full
        corr = costs.slstm_correction(cfg, shape, n_chips)
        t1 = time.time()
        if use_slope and count > 1:
            t_1 = _trace_cell(_depth_arch(arch, 1), shape, mesh,
                              exact_attn=True)
            t_2 = _trace_cell(_depth_arch(arch, 2), shape, mesh,
                              exact_attn=True)
            terms = costs.slope(costs.extract(t_1), costs.extract(t_2),
                                count, flops_correction=corr)
            m1, m2 = costs.memory_dict(t_1), costs.memory_dict(t_2)
            temp = m1["temp_bytes"] + (count - 1) * (m2["temp_bytes"]
                                                      - m1["temp_bytes"])
            out_bytes = arg_bytes + m1["output_bytes"] - m1["argument_bytes"]
            base = max(arg_bytes, out_bytes)
            mem = {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(temp), "generated_code_bytes": 0,
                   "peak_bytes_est": int(base + temp)}
            rec["cost_method"] = "trace+slope(U1,U2)"
        else:
            tr = _trace_cell(arch, shape, mesh)
            terms = costs.extract(tr, flops_correction=corr)
            mem = costs.memory_dict(tr)
            rec["cost_method"] = "unrolled-exact"
        t2 = time.time()
        mf = costs.model_flops(cfg, shape, n_chips)
        total_flops = terms.flops + terms.flops_correction
        rec.update(
            status="ok",
            compile_s=round(t1 - t0, 2), slope_s=round(t2 - t1, 2),
            memory=mem,
            roofline=terms.as_dict(),
            model_flops=mf,
            useful_flops_ratio=(mf / total_flops) if total_flops else 0.0,
            hbm_ok=bool(mem["peak_bytes_est"] < costs.HBM_BYTES),
        )
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {arch_name} x {shape_name} mesh={rec['mesh']}  "
                  f"place={rec['compile_s']}s trace={rec['slope_s']}s "
                  f"({rec['cost_method']})")
            print(f"     memory/device: args={mem['argument_bytes']/1e9:.2f}G"
                  f" temp={mem['temp_bytes']/1e9:.2f}G"
                  f" peak~{mem['peak_bytes_est']/1e9:.2f}G"
                  f" (<{costs.HBM_BYTES/1e9:.0f}G: {rec['hbm_ok']})")
            print(f"     roofline/device: compute={r['t_compute_s']*1e3:.2f}ms"
                  f" memory={r['t_memory_s']*1e3:.2f}ms"
                  f" collective={r['t_collective_s']*1e3:.2f}ms"
                  f" -> {r['bottleneck']}-bound;"
                  f" useful={rec['useful_flops_ratio']:.2f}")
    except Exception as e:  # a trace failure is a fault of the port
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch_name} x {shape_name}: {rec['error']}")
    return rec


def _micronn_index(dim=512, k_parts=8192, p_max=128, dcap=8192, n_attr=0,
                  dtype=None):
    """The reference's dry-run index (1.05M x 512 in 8,192 partitions of
    128 slots, a delta of 8,192) on "meta"."""
    import torch
    from ..core.types import DeltaStore, IVFConfig, IVFIndex
    vdt = dtype or torch.float32

    def m(shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")
    cfg = IVFConfig(dim=dim, delta_capacity=dcap)
    return IVFIndex(
        centroids=m((k_parts, dim)), csizes=m((k_parts,)),
        vectors=m((k_parts, p_max, dim), vdt),
        ids=m((k_parts, p_max), torch.int32),
        attrs=m((k_parts, p_max, n_attr), vdt),
        valid=m((k_parts, p_max), torch.bool),
        counts=m((k_parts,), torch.int32),
        delta=DeltaStore(vectors=m((dcap, dim), vdt),
                         ids=m((dcap,), torch.int32),
                         attrs=m((dcap, n_attr), vdt),
                         valid=m((dcap,), torch.bool), count=0),
        base_mean_size=float(p_max), config=cfg)


def run_micronn(multi_pod: bool, verbose: bool = True,
                optimized: bool = False) -> dict:
    """Dry-run the paper's own workload: distributed ANN search over a
    model-sharded IVF index (1.05M x 512, a batch of 4,096 queries,
    n_probe 64, top 100), traced through `distributed_query` on "meta".

    optimized=True is the reference's variant: bfloat16 vector storage
    and a probe cap of 16 per rank."""
    import torch
    from ..core.query import Q
    from ..distributed.sharded_index import distributed_query, shard_index
    from .mesh import data_axes

    rec = {"arch": "micronn-search" + ("-opt" if optimized else ""),
           "shape": "batch4096",
           "mesh": "x".join(map(str, (2, 16, 16) if multi_pod
                                else (16, 16))),
           "n_chips": 512 if multi_pod else 256, "kind": "search"}
    try:
        mesh = _mesh(multi_pod)
        dax = data_axes(mesh)
        n_data = 1
        for a in dax:
            n_data *= mesh.size(mesh.mesh_dim_names.index(a))
        Qn, topk, n_probe = 4096, 100, 64
        index = _micronn_index(
            dtype=torch.bfloat16 if optimized else torch.float32)
        t0 = time.time()
        shard = shard_index(index, mesh)
        queries = torch.empty((Qn // n_data, index.dim),
                              dtype=torch.float32, device="meta")

        class _Bound:
            args = (shard, queries)

            def __call__(self):
                rs = distributed_query(
                    shard, queries, Q.knn(k=topk, n_probe=n_probe), mesh,
                    data_axes=dax, local_cap=16 if optimized else None)
                return rs.ids, rs.scores
        tr = costs.trace(_Bound())
        t1 = time.time()
        terms = costs.extract(tr)
        mem = costs.memory_dict(tr)
        rec.update(status="ok", compile_s=round(t1 - t0, 2), memory=mem,
                   roofline=terms.as_dict(),
                   hbm_ok=bool(mem["peak_bytes_est"] < costs.HBM_BYTES))
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {rec['arch']} mesh={rec['mesh']}"
                  f" trace={rec['compile_s']}s peak~"
                  f"{mem['peak_bytes_est']/1e9:.2f}G ->"
                  f" {r['bottleneck']}-bound")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] micronn-search: {rec['error']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micronn", action="store_true")
    ap.add_argument("--scan", action="store_const", const=True, default=None,
                    help="force the depth slope (default: auto per arch)")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.mesh]

    def save(rec):
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
        keep = [r for r in existing if key(r) != key(rec)]
        with open(args.out, "w") as f:
            json.dump(keep + [rec], f, indent=1)

    records = []
    if args.micronn or args.all:
        for mp in pods:
            records.append(run_micronn(mp))
            save(records[-1])
            records.append(run_micronn(mp, optimized=True))
            save(records[-1])
    if args.all or args.arch:
        archs = arch_names() if args.all else [args.arch]
        shapes = list(SHAPES) if args.shape is None else [args.shape]
        for a in archs:
            for s in shapes:
                for mp in pods:
                    records.append(run_cell(a, s, mp, scan=args.scan))
                    save(records[-1])
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors"
          f" -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
