#!/usr/bin/env python3
"""Drive the PyTorch/CUDA MicroNN port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # full run (one card, ~a few minutes)
    python3 chip_smoke.py --quick    # build + one launch of each kernel
    python3 chip_smoke.py --kernels-only [--src OTHER/src]
                                     # phase 4 alone, on an in-memory index
    python3 chip_smoke.py --lm-only  # build + the lm and lm_families
                                     # phases alone
    python3 chip_smoke.py --train-only   # build + the train phase alone
                                     # (with the sharded train step and
                                     # the remat policies side by side)

Phases (any failure exits non-zero and prints no result line):
  1. device   -- name, count, `nvidia-smi` name and power limit.
  2. build    -- nvcc builds the three kernels from src/repro_torch/kernels/
                 csrc, all at once, into build/kernels/ (ptxas -v printed).
  3. main     -- the resident engine at real size: the synthetic SIFT set
                 (1,000,000 x 128, l2, 2 attributes, seed 0) ingested into
                 SQLite, build() with the int8 tier (rerank_factor=4),
                 queries at Q in {1, 32, 512} on the int8 and f32 tiers,
                 exact queries, a post-filter query (the predicate program
                 evaluated in the scan, held bit for bit against the mask
                 route), upserts, a delete and a recover() into a second
                 engine. Recall is held against a brute-force oracle on
                 the card.
     hybrid   -- (inside main, before the writes) the optimizer on the
                 resident engine: a selective predicate resolves to the
                 pre-filter plan (K1 over the gathered rows; recall@100 =
                 1.000 against a filtered brute force), a broad one to the
                 post-filter plan (program route == mask route).
     serving  -- (inside main, after hybrid, before the writes) the front
                 door on the resident engine: 32 threads x 16 single-row
                 callers, every answer equal to its solo query() bit for
                 bit, int8 and f32, with the rates of both; explain() on
                 the int8, f32, exact, pre- and post-filter routes (stages,
                 span sums, scan launches == launch delta); the tracing
                 hooks' cost on untraced Q=1 (median ratio <= 1.03); a
                 flight capture of 256 front-door queries replayed bit for
                 bit; a 40,000-query batch equal to its two launch slices
                 and an oversize k_scan refused by name; the maintenance
                 daemon beside 8 write sessions with HTTP scrapes that
                 change no answer. Its paged half (front door, explain()
                 with the fault span == stats(), flight replay) runs at
                 the end of the paged phase on the int8 pool.
     sharded  -- (inside main, after the writes, before maintenance) the
                 sharded index on a (data 1, model 4) mesh: 4 ranks spawned
                 by torch.multiprocessing, all on the one card, on gloo
                 (host-staged collectives); each gets the resident index
                 by CUDA IPC and slices its quarter (k = 10,000, the delta
                 holding the 8 upserts), runs distributed_query over the
                 512 queries (k=100, n_probe=8) with each merge; rank 0
                 holds both to executor.run on the whole index: ids equal,
                 scores bit for bit (a row may differ only at a
                 probe-boundary tie of centroid scores, reported).
                 Launches are counted in each rank.
     maintenance -- (inside main, after the writes, before recover) the
                 monitor's verdict and work queue on the 1M engine, then
                 maintain(until_idle=True, max_steps=S), each step timed by
                 part; exact recall, ANN recall against its value before,
                 writes still visible. Recover and the paged phase then
                 read the repaired file.
     paged    -- (after recover) the disk-resident mode on the same file:
                 an int8 pool and an f32 pool of memory_budget_mb=10 answer
                 like the recovered resident engine, bit for bit; paged
                 exact on the int8 pool; the pool never exceeds the budget.
     paged build -- a paged build (int8, 10 MiB) of the first 100,000 rows
                 into a fresh file: streamed from SQLite, its final
                 assignment through K3.
     rebuild  -- on that file: upserts, maintain() acting on the monitor's
                 verdict, then maintain(force="rebuild") paged and, on the
                 same file, resident -- each through K3.
     fleet    -- 16 tenants of 25,000 x 128 rows (int8, rf 4), each built
                 once by the paged build and copied into two arms: one
                 Fleet at budget B (the smallest whole MiB seating one
                 tenant's partitions) and 16 solo paged engines at B/16;
                 bench_fleet's Zipf(1.6) traffic, 800 calls of 4 rows
                 (k=10, n_probe=8): every call equal across the arms bit
                 for bit, the fleet's bytes <= B at every 16th call, both
                 arms' calls/s; a second Fleet with max_live=4 (spills)
                 answering the same; upserts into 2 tenants drained by the
                 deficit round robin; health() and /healthz; a flight
                 capture through the fleet replayed bit for bit.
     lm       -- (last, after phase 4, the 1M engine and the fleet freed)
                 the LM serving path at llama3-8b's full width and depth
                 (32 layers, d 4096, vocab 128,256, bf16, random weights
                 from seed 0): a kNN-LM datastore of 262,144 x 4,096 rows
                 with launch/serve.build_rag_datastore's recipe (k =
                 4,096; the padded layout projected for the recipe's
                 Gaussian rows and the mixture first, outside the counted
                 path; the build's own K3 launches read just after it), an
                 int8 twin over the same partitions; ServeEngine (8 slots,
                 s_max 1,024, RAG k 16, n_probe 8, lam 0.25) over 16
                 TokenStream prompts of 32 tokens, 32 new tokens each,
                 twice (tokens bit for bit); 64 recorded hidden states: K1
                 through executor.run against the plain scan, knn_logits of
                 both routes bit for bit, recall@16 of the f32 and int8
                 tiers against Q.exact, and Q.exact against a numpy brute
                 force; an upserted hidden state decides the next token at
                 lam 0.9 and shows in delta_live; lam -> 0 is the LM; the
                 three kernels at the RAG shapes against their plain
                 versions, timed (K1 / K2 on stored rows with noise and on
                 a decode step's hidden states); decode == forward and
                 prefill == step-by-step at full width on 2 float32 layers.
     lm_families -- (after lm, llama3-8b freed, its datastore and int8
                 twin kept) the lm_moe path: phi3.5-moe at full width (d
                 4,096, 16 experts top-2, vocab 32,064, bf16, seed 0) cut
                 to 8 of its 32 layers (83.8 GB whole), ServeEngine (8
                 slots, s_max 1,024, RagConfig()) over the lm datastore
                 with its next tokens redrawn over 32,064, 16 TokenStream
                 prompts of 32 tokens, 32 new tokens each, twice (bit for
                 bit), each layer's choices per expert and drops (0), then
                 Q.exact and the f32 (K1) and int8 (K2) tiers on 64
                 recorded hidden states; decode step times with and
                 without RAG, the host's op count, the card's busy time
                 beside the byte bound of the chosen experts, routing vs
                 expert device time, K1 / K2 on the decode hidden states
                 against their plain versions; phi3.5-moe decode ==
                 forward (routes equal) and prefill == step-by-step on 2
                 float32 layers. Then recurrentgemma-2b and xlstm-350m
                 whole (ServeEngine, 8 slots, s_max 256, 8 prompts of 32
                 tokens, 16 new, twice bit for bit; recurrentgemma's
                 requests also served alone), whisper-medium whole
                 (prefill of 8 x 1,500 frames + 1 token, 16 decode steps,
                 twice bit for bit), each with decode == forward on one
                 float32 period at full width.
     train    -- (last, the serving phases freed) training on one card:
                 llama3-8b at full width (d 4,096, 32 / 8 heads, d_ff
                 14,336, vocab 128,256, bf16, remat on) cut to 8 of its 32
                 layers (the whole model's AdamW state exceeds the card),
                 random weights from seed 0; TokenStream(seed 0) batches of
                 1 x 4,096 tokens; AdamW lr 3e-4, warmup 1, 6 steps through
                 Trainer.fit. Checks: (a) every loss and grad_norm finite,
                 the last loss below the first; (b) two more runs of the
                 first 2 steps give the same losses and the same bits in
                 every parameter and moment leaf (an integer digest of each
                 leaf on the card); (c) autograd's directional derivative
                 of loss_fn against a central difference on 1 float32
                 layer at full width, 512 tokens; (d) at llama3-8b's smoke
                 config 20 straight steps == 10, a save, a fresh Trainer
                 and 10 more, bit for bit. Printed: step ms, tokens/s,
                 model FLOPs and their share of the bf16 peak, the AdamW
                 update's ms, torch calls from Python a step, the card's
                 busy share of a step, peak memory, the checkpoint's bytes
                 and save / restore seconds. (e) sharded train (16c,
                 launch/steps on DTensor): llama3-8b at full width cut to
                 2 of 32 layers, TokenStream batches of 2 x 1,024, 3
                 AdamW steps, first on one rank over the whole model,
                 freed, then 4 ranks spawned on the one card, a (data 2,
                 model 2) mesh over gloo (FSDP, TP and SP), the same
                 weights and batches: the ranks' losses equal, the first
                 step's within 1e-2 relative of the one rank's; step ms,
                 each rank's peak memory, one step's collectives by kind
                 (costs.StepCounter), the host-staged all-gathers; times
                 of 4 ranks sharing one card, not of a 4-card
                 deployment. With --train-only also (f): the remat
                 policies "nothing" and "dots" side by side on the
                 8-layer cell, 3 steps each, equal losses, step ms and
                 peak memory. No kernel of the three lies on these
                 paths: their launch counts are read (0 each).
     Each path's kernel launch counters are zeroed just before it and read
     just after; every kernel the path runs must show launches.
  4. kernels  -- each kernel against its plain PyTorch version on the card
                 at the main path's shapes plus edge cases, then timed with
                 CUDA events beside the plain version and a PyTorch
                 yardstick (library_ms), with its roofline bound, and as
                 their kernels' device time in a profiler trace; K1 on the
                 exact route also without row sharing, bit for bit; K1 / K2
                 with the predicate program against the mask route (bit for
                 bit) and the plain version. Then K1 on the pre-filter
                 plan's gathered rows and K1 / K2 over a chunk of the paged
                 frame pools, with and without a program.
  5. result   -- one JSON line of kernels, the card's name and power limit,
                 and the contract line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import inspect
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "smoke"

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline denominators.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
INT8_OPS = 1979e12         # int8 tensor-core rate

KERNEL_META = {
    "ivf_scan_topk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ivf_scan.cu",
        replaces="src/repro/kernels/ivf_scan.py:129"),
    "sq_scan_topk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sq_scan.cu",
        replaces="src/repro/kernels/sq_scan.py:131"),
    "kmeans_assign": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:56"),
}
# each kernel's CUDA kernels (and K1's memset of its limits), by name, for
# its device time in a trace
K1_KERNELS = ("pair_list", "ivf_scan_pass1", "topk_merge_pass2", "Memset")
K2_KERNELS = ("pair_list", "sq_scan_pass1", "topk_merge_pass2")
K3_KERNELS = ("row_sqnorms", "kmeans_assign_tiles", "kmeans_assign_groups")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_info():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}  count={count}  torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"nvidia-smi: {card}")
    return name, count, card


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    for name, s in secs.items():
        log(f"build {name}: {s:.1f} s")
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "ptxas" in line:
                log(f"  {line.strip()}")
    log(f"phase build: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters=10, reps=1):
    """Mean time per fn() over `iters` back-to-back runs after one
    warm-up, between CUDA events; with reps > 1 the median of that many
    such windows (a wrapper's time at small batches is its host work, and
    the shared host's stalls would otherwise land in one window)."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def kernel_device_ms(fn, kernels, iters=10):
    """Mean device time per fn() of the CUDA kernels whose names contain
    one of `kernels`, from a torch.profiler trace: kernel time without the
    wrapper's host work. None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if any(k in e.key for k in kernels))
    return us / iters / 1e3 if us > 0 else None


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def topk_tol(queries, v2_max):
    from repro_torch.testing import score_tol
    return score_tol(queries.detach().cpu().numpy(), v2_max)


def compare(ref, got, tol, what):
    import torch
    from repro_torch.testing import compare_topk
    torch.cuda.synchronize()
    err, ok, bad = compare_topk(ref[0].cpu().numpy(), ref[1].cpu().numpy(),
                                got[0].cpu().numpy(), got[1].cpu().numpy(),
                                tol)
    log(f"  {what}: max_abs_err={err:.3e} ids_equal={ok} bad_rows={bad}")
    return err, ok


# ---------------------------------------------------------------------------
# phase 4: each kernel against its plain version, timed
# ---------------------------------------------------------------------------


def scan_work(part_ids, qsel, valid, n_q):
    """What a scan's inputs need, counted from this run's data: (probed
    partitions that some query selects, their valid rows, valid rows summed
    over the selected (query, partition) pairs). The kernels skip
    unselected pairs and read payload for valid rows only (with a
    predicate, pass valid & keep: payload is read for kept rows only)."""
    import torch
    rows_per = valid[part_ids.long()].sum(1).to(torch.float64)       # [n]
    if qsel is None:
        return part_ids.shape[0], float(rows_per.sum()), \
            n_q * float(rows_per.sum())
    sel = qsel.any(0)
    pair_rows = float((qsel.to(torch.float64) @ rows_per).sum())
    return int(sel.sum()), float(rows_per[sel].sum()), pair_rows


def _attr_bytes(part_ids, qsel, valid, n_q, keep, n_attr):
    """(payload mask, attrs bytes) of a filtered scan: a predicate program
    reads the n_attr float32 attributes of every valid row of the selected
    partitions, and payload only for the rows it keeps."""
    if keep is None:
        return valid, 0.0
    rows_valid = scan_work(part_ids, qsel, valid, n_q)[1]
    return valid & keep, rows_valid * 4.0 * n_attr


def k1_bound(part_ids, qsel, valid, n_q, d, p_max, k_out, keep=None,
             n_attr=0):
    """(bound seconds by bytes, by operations) of ivf_scan_topk (l2): the
    selected partitions' valid rows (f32) and valid bytes, the probe list,
    queries and selection mask read once, the k_out ids gathered and the
    outputs written once; 2d flops per valid row of each selected pair plus
    2d per valid row for ||v||^2. With a predicate program (`keep`, its row
    mask): the valid rows' attrs, and payload and flops for kept rows."""
    n = part_ids.shape[0]
    ok, attr_b = _attr_bytes(part_ids, qsel, valid, n_q, keep, n_attr)
    parts, rows, pair_rows = scan_work(part_ids, qsel, ok, n_q)
    parts = scan_work(part_ids, qsel, valid, n_q)[0]
    b = (rows * 4 * d + attr_b + parts * p_max + n * 4 + n_q * 4 * d
         + (n_q * n if qsel is not None else 0) + n_q * k_out * (4 + 8))
    o = 2.0 * d * (pair_rows + rows)
    return b / HBM_BYTES_PER_S, o / F32_FLOPS


def k2_bound(part_ids, qsel, valid, n_q, d, p_max, k_out, keep=None,
             n_attr=0):
    """(bound seconds by bytes, by operations) of sq_scan_folded on the
    norms route: the selected partitions' valid rows' codes and norms,
    valid bytes, the probe list, the folded queries (int8 [2Q, d], alpha,
    beta), lo/scale and the selection mask read once, outputs written once;
    2 * 2d int8 operations per valid row of each selected pair (two
    folded terms). With a predicate program: as k1_bound."""
    n = part_ids.shape[0]
    ok, attr_b = _attr_bytes(part_ids, qsel, valid, n_q, keep, n_attr)
    parts, rows, pair_rows = scan_work(part_ids, qsel, ok, n_q)
    parts = scan_work(part_ids, qsel, valid, n_q)[0]
    b = (rows * (d + 4) + attr_b + parts * p_max + n * 4
         + n_q * (2 * d + 12) + 2 * d * 4
         + (n_q * n if qsel is not None else 0) + n_q * k_out * 8)
    o = 2.0 * (2 * d) * pair_rows
    return b / HBM_BYTES_PER_S, o / INT8_OPS


def k3_bound(rows, k, d):
    """(bound seconds by bytes, by operations) of kmeans_assign: the batch,
    centroids and penalty read once, assignments and costs written once;
    2d flops per (row, centroid) pair."""
    b = ((rows + k) * d * 4 + k * 4 + rows * 8) / HBM_BYTES_PER_S
    o = 2.0 * rows * k * d / F32_FLOPS
    return b, o


def refuse_below_bound(row, what):
    """A trace's device time below the row's own bound cannot be a
    measurement (the trace lost or merged kernels): the reading is kept as
    device_ms_refused and device_ms becomes None, "not measured". Walks
    the row's nested rows."""
    for key, sub in list(row.items()):
        if isinstance(sub, dict):
            refuse_below_bound(sub, f"{what} {key}")
    t = row.get("device_ms")
    if t is not None and "bound_ms" in row and t < row["bound_ms"]:
        log(f"  {what}: device time {t:.4f} ms lies below its bound "
            f"{row['bound_ms']:.4f} ms: not measured")
        row["device_ms_refused"], row["device_ms"] = t, None


def bound_of(b, o):
    return dict(bound_ms=1e3 * max(b, o),
                bound_by="bytes" if b >= o else "operations")


def lib_scan_f32(q, vec, valid, part_ids, qsel, k_out, filt=None):
    """K1's function in one dense product + topk over every probed row:
    the yardstick (exactly K1's work on the exact route). `filt` (a
    compiled filter, attrs) masks the rows by the predicate, evaluated over
    the probed rows."""
    import torch
    from repro_torch.core.types import f32_matmul
    pid_l = part_ids.long()
    d, p_max = vec.shape[-1], vec.shape[1]
    pv = vec[pid_l].reshape(-1, d)
    s = torch.sum(pv * pv, -1)[None, :] - 2.0 * f32_matmul(q, pv.T)
    ok = valid[pid_l].reshape(1, -1)
    if filt is not None:
        ok = ok & filt[0](filt[1][pid_l]).reshape(1, -1)
    if qsel is not None:
        ok = ok & qsel.repeat_interleave(p_max, dim=1)
    s = s.masked_fill(~ok, float("inf"))
    return torch.topk(s, k_out, dim=1, largest=False)


def lib_scan_int8(q_i8, alpha, beta, codes, norms, valid, part_ids, qsel,
                  k_out, filt=None):
    """K2's function (norms route) as one dense product of the cast codes
    + topk: its yardstick."""
    import torch
    from repro_torch.core.types import f32_matmul
    pid_l = part_ids.long()
    d, p_max = codes.shape[-1], codes.shape[1]
    n_q = beta.shape[0]
    pc = codes[pid_l].reshape(-1, d).to(torch.float32)
    dots = f32_matmul(q_i8.to(torch.float32), pc.T)
    s = norms[pid_l].reshape(1, -1) - 2.0 * (
        alpha[:n_q, None] * dots[:n_q] + alpha[n_q:, None] * dots[n_q:]
        + beta[:, None])
    ok = valid[pid_l].reshape(1, -1)
    if filt is not None:
        ok = ok & filt[0](filt[1][pid_l]).reshape(1, -1)
    if qsel is not None:
        ok = ok & qsel.repeat_interleave(p_max, dim=1)
    s = s.masked_fill(~ok, float("inf"))
    return torch.topk(s, k_out, dim=1, largest=False)


def same_bits(a, b):
    import torch
    torch.cuda.synchronize()
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# the predicates of the program-route checks: the hybrid phase's selective
# one, the post-filter one, and an And / Or tree with a `ne`
def program_preds():
    from repro_torch.core.hybrid import And, Or, Pred
    return [("attr1<0.0005", Pred(1, "<", 0.0005)),
            ("attr0==3", Pred(0, "==", 3)),
            ("tree", And((Pred(0, "!=", 2),
                          Or((Pred(1, "<", 0.3), Pred(0, ">=", 8))))))]


def route_times(prog, mask, plain, lib, kernels, bound):
    """Times of one program-route scan: through the wrapper (median of 3
    windows), its kernels' device time, the mask route as the executor
    ran it before (the whole-index keep mask, then the scan), the plain
    version and the library yardstick, beside the bound."""
    return dict(ms=cuda_ms(prog, reps=3),
                device_ms=kernel_device_ms(prog, kernels),
                mask_route_ms=cuda_ms(mask, reps=3),
                plain_ms=cuda_ms(plain, iters=2),
                library_ms=cuda_ms(lib, iters=2), **bound)


def check_program_route(idx, cases, res, timed):
    """K1 and K2 with the predicate program evaluated in the scan, at the
    main path's shapes (ANN Q=512: K1 k_out=100, K2 k_out=400 over the
    norms; exact Q=8: K1 k_out=100 with row sharing), for each of
    program_preds(): bit for bit against the mask route (the same kernel
    fed f(attrs) as its keep mask) and against the plain version (ids;
    K2's scores bit for bit). Timed when `timed`; the entries land in
    res[kernel]["program"]."""
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.hybrid import compile_filter
    from repro_torch.core.types import QuantStats
    from repro_torch.kernels import ivf_scan, sq_scan
    vec, valid, ids, attrs = idx["vectors"], idx["valid"], idx["ids"], \
        idx["attrs"]
    codes, norms, lo, scale = idx["codes"], idx["norms"], idx["lo"], \
        idx["scale"]
    kp, p_max, d = vec.shape
    n_attr = attrs.shape[-1]
    v2_max = float(torch.sum(vec * vec, dim=-1).max())
    stats = QuantStats(lo=lo, scale=scale)
    fails = []
    for kname in ("ivf_scan_topk", "sq_scan_topk"):
        res[kname].setdefault("program", [])
    for label, q, part_ids, qsel, k_out in cases:
        if label not in ("ann Q=512", "exact Q=8"):
            continue
        n_q = q.shape[0]
        tol = topk_tol(q, v2_max)
        q_i8, alpha, beta = quantize.fold_queries(stats, q)
        k_sq = min(4 * k_out, part_ids.shape[0] * p_max)
        for pname, pred in program_preds():
            f = compile_filter(pred)
            keep = f(attrs)
            k1 = (q, vec, valid, ids, part_ids, k_out)

            def k1_prog():
                return ivf_scan.ivf_scan_topk(*k1, qsel=qsel, attrs=attrs,
                                              program=f.program)

            def k1_mask():
                return ivf_scan.ivf_scan_topk(*k1, qsel=qsel, keep=f(attrs))
            got = k1_prog()
            same = same_bits(got, ivf_scan.ivf_scan_topk(*k1, qsel=qsel,
                                                         keep=keep))
            err, ok = compare(ivf_scan.ivf_scan_plain(
                *k1, qsel=qsel, attrs=attrs, program=f.program), got, tol,
                f"ivf_scan program {label} {pname}")
            log(f"  ivf_scan program {label} {pname}: bit for bit equal to "
                f"the mask route: {same}")
            r = res["ivf_scan_topk"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if not (same and ok):
                fails.append(f"ivf_scan {label} {pname}")
            if timed:
                e = route_times(
                    k1_prog, k1_mask, lambda: ivf_scan.ivf_scan_plain(
                        *k1, qsel=qsel, attrs=attrs, program=f.program),
                    lambda: lib_scan_f32(q, vec, valid, part_ids, qsel,
                                         k_out, filt=(f, attrs)),
                    K1_KERNELS, bound_of(*k1_bound(
                        part_ids, qsel, valid, n_q, d, p_max, k_out,
                        keep=keep, n_attr=n_attr)))
                e.update(shape=f"{label} k_out={k_out}", pred=pname,
                         max_abs_err=err, mask_bitwise=same)
                r["program"].append(e)
            if qsel is None:
                continue            # the int8 tier serves ANN plans only
            k2 = (q_i8, alpha, beta, lo, scale, codes, valid, None,
                  part_ids, k_sq)

            def k2_prog():
                return sq_scan.sq_scan_folded(*k2, qsel=qsel, norms=norms,
                                              attrs=attrs, program=f.program)

            def k2_mask():
                return sq_scan.sq_scan_folded(*k2, qsel=qsel, norms=norms,
                                              keep=f(attrs))
            got = k2_prog()
            same = same_bits(got, sq_scan.sq_scan_folded(
                *k2, qsel=qsel, norms=norms, keep=keep))
            plain = sq_scan.sq_scan_plain(*k2, qsel=qsel, norms=norms,
                                          attrs=attrs, program=f.program)
            exact = same_bits(plain, got)
            err = float((plain[0] - got[0]).abs().max())
            log(f"  sq_scan program {label} {pname}: bit for bit equal to "
                f"the mask route: {same}, to the plain version: {exact}")
            r = res["sq_scan_topk"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if not (same and exact):
                fails.append(f"sq_scan {label} {pname}")
            if timed:
                e = route_times(
                    k2_prog, k2_mask, lambda: sq_scan.sq_scan_plain(
                        *k2, qsel=qsel, norms=norms, attrs=attrs,
                        program=f.program),
                    lambda: lib_scan_int8(q_i8, alpha, beta, codes, norms,
                                          valid, part_ids, qsel, k_sq,
                                          filt=(f, attrs)),
                    K2_KERNELS, bound_of(*k2_bound(
                        part_ids, qsel, valid, n_q, d, p_max, k_sq,
                        keep=keep, n_attr=n_attr)))
                e.update(shape=f"{label} k_out={k_sq}", pred=pname,
                         max_abs_err=err, mask_bitwise=same)
                r["program"].append(e)
    check(not fails, f"the program route disagrees: {fails}")
    if timed:
        for kname in ("ivf_scan_topk", "sq_scan_topk"):
            for e in res[kname]["program"]:
                log(f"  time {kname} program [{e['shape']} {e['pred']}]: "
                    f"kernel {e['ms']:.4f} ms, device "
                    f"{fmt_ms(e['device_ms'])}, mask route (mask + scan) "
                    f"{e['mask_route_ms']:.4f} ms, plain {e['plain_ms']:.4f}"
                    f" ms, library {e['library_ms']:.4f} ms, bound "
                    f"{e['bound_ms']:.4f} ms ({e['bound_by']})")


def check_kernels(idx, cases, batch, timed):
    """idx: dict of device tensors (vectors, valid, ids, codes, lo, scale,
    norms, centroids); cases: list of (label, queries, part_ids, qsel,
    k_out); batch: [s, d] rows for kmeans_assign. Every check and timing
    goes through the public wrappers the engine calls; each is held against
    the plain version of its whole function on the same inputs. Returns
    per-kernel summaries."""
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.types import QuantStats, f32_matmul
    from repro_torch.kernels import ivf_scan, kmeans_assign, sq_scan

    vec, valid, ids = idx["vectors"], idx["valid"], idx["ids"]
    codes, norms = idx["codes"], idx["norms"]
    lo, scale = idx["lo"], idx["scale"]
    kp, p_max, d = vec.shape
    v2_max = float(torch.sum(vec * vec, dim=-1).max())
    stats = QuantStats(lo=lo, scale=scale)
    res = {k: dict(max_abs_err=0.0, ids_equal=True) for k in KERNEL_META}

    def note(name, err, ok):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["ids_equal"] = res[name]["ids_equal"] and ok

    def sq_plain(q, part_ids, k_out, metric, qsel, keep, nrm):
        """sq_scan_topk's whole function in plain PyTorch: the query fold,
        then the plain scan, with the norms feeding the l2 score only."""
        q_i8, alpha, beta = quantize.fold_queries(stats, q)
        return sq_scan.sq_scan_plain(
            q_i8, alpha, beta, lo, scale, codes, valid, None, part_ids,
            k_out, metric, qsel, keep, nrm if metric == "l2" else None)

    g = torch.Generator(device=vec.device).manual_seed(1)
    keep = torch.rand(valid.shape, generator=g, device=vec.device) < 0.3
    none_kept = torch.zeros_like(valid)
    timing_case = cases[-1]
    for label, q, part_ids, qsel, k_out in cases:
        tol = topk_tol(q, v2_max)
        for metric in ("l2", "ip") if label == timing_case[0] else ("l2",):
            for kname, kmask in (("", None), (" keep", keep)):
                ref = ivf_scan.ivf_scan_plain(q, vec, valid, ids, part_ids,
                                              k_out, metric, qsel, kmask)
                got = ivf_scan.ivf_scan_topk(q, vec, valid, ids, part_ids,
                                             k_out, metric, qsel, kmask)
                note("ivf_scan_topk", *compare(
                    ref, got, tol, f"ivf_scan {label} {metric}{kname}"))
        k_sq = min(4 * k_out, part_ids.shape[0] * p_max)
        # ip with norms passed: the wrapper must drop them (l2 only)
        for metric, nrm in (("l2", norms), ("l2", None), ("ip", norms)):
            if label != timing_case[0] and (nrm is None or metric == "ip"):
                continue
            ref = sq_plain(q, part_ids, k_sq, metric, qsel, None, nrm)
            got = sq_scan.sq_scan_topk(q, codes, lo, scale, valid, None,
                                       part_ids, k_sq, metric, qsel, None,
                                       nrm)
            note("sq_scan_topk", *compare(
                ref, got, tol, f"sq_scan {label} {metric} "
                f"{'norms' if nrm is not None else 'decode'}"))

    # edge cases: every row masked, and k_out above the qualifying rows
    label, q, part_ids, qsel, k_out = cases[0]
    tol = topk_tol(q, v2_max)
    few = keep & (torch.rand(valid.shape, generator=g, device=vec.device)
                  < 0.02)
    for kname, kmask in (("all-masked", none_kept), ("k>rows", few)):
        kk = min(part_ids.shape[0] * p_max, 400)
        ref = ivf_scan.ivf_scan_plain(q, vec, valid, ids, part_ids, kk,
                                      "l2", qsel, kmask)
        got = ivf_scan.ivf_scan_topk(q, vec, valid, ids, part_ids, kk, "l2",
                                     qsel, kmask)
        note("ivf_scan_topk", *compare(ref, got, tol, f"ivf_scan {kname}"))
        ref = sq_plain(q, part_ids, kk, "l2", qsel, kmask, norms)
        got = sq_scan.sq_scan_topk(q, codes, lo, scale, valid, None,
                                   part_ids, kk, "l2", qsel, kmask, norms)
        note("sq_scan_topk", *compare(ref, got, tol, f"sq_scan {kname}"))

    # row sharing on the exact route must not change a bit: the default
    # query group against one query a block
    group = getattr(ivf_scan, "MAX_GROUP", None)
    for label, q, part_ids, qsel, k_out in cases:
        if qsel is not None or group is None:
            continue
        a = ivf_scan.ivf_scan_topk(q, vec, valid, ids, part_ids, k_out)
        ivf_scan.MAX_GROUP = 1
        try:
            b = ivf_scan.ivf_scan_topk(q, vec, valid, ids, part_ids, k_out)
        finally:
            ivf_scan.MAX_GROUP = group
        torch.cuda.synchronize()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        log(f"  ivf_scan {label}: row sharing bit-identical to one query a "
            f"block: {same}")
        note("ivf_scan_topk", 0.0, same)

    # kmeans_assign at the build's shape: unbalanced and balanced. The
    # plain side forms the penalty itself: counts * (lambda * scale /
    # target), lambda = bw, scale = 3, target = 100.
    cents = idx["centroids"]
    k = cents.shape[0]
    counts = torch.rand((k,), generator=g, device=vec.device) * 200
    for bw in (0.0, 1.0):
        pen = counts * (bw * 3.0 / 100)
        ref_a, ref_c = kmeans_assign.kmeans_assign_plain(batch, cents, pen)
        got_a, got_c = kmeans_assign.kmeans_assign(
            batch, cents, counts, balance_weight=bw, target_size=100,
            scale=3.0)
        torch.cuda.synchronize()
        x2 = torch.sum(batch * batch, dim=-1)
        ctol = 1e-5 * (x2 + float(torch.sum(cents * cents, -1).max()))
        err = float((ref_c - got_c).abs().max())
        # a different arg-min is fine only where the two centroids' exact
        # (float64) costs tie within the tolerance
        x64, c64, p64 = batch.double(), cents.double(), pen.double()

        def exact(a):
            return ((x64 - c64[a.long()]) ** 2).sum(-1) + p64[a.long()]
        ok = bool(((ref_c - got_c).abs() <= ctol).all()) and bool(
            ((exact(ref_a) - exact(got_a)).abs() <= ctol).all())
        log(f"  kmeans_assign bw={bw}: max_abs_err={err:.3e} ids_equal={ok} "
            f"differing_args={int((ref_a != got_a).sum())}")
        note("kmeans_assign", err, ok)

    for name, r in res.items():
        check(r["ids_equal"], f"{name} disagrees with its plain version")
    if "program" in inspect.signature(ivf_scan.ivf_scan_topk).parameters:
        check_program_route(idx, cases, res, timed)
    else:       # an older tree's src (--src): no predicate program route
        log("  no predicate program route in this src: not checked")
    if not timed:
        return res

    # -- kernel time at every main-path shape ---------------------------------
    # K2 is timed through sq_scan_folded (the kernel's own inputs, beside
    # the plain scan on the same folded queries); the fold is a few small
    # torch ops outside the kernel. Beside it, the device time of K2's own
    # kernels in a profiler trace: the gap is the wrapper's host work
    # (checks, allocations, ctypes), not kernel time.
    def lib_k1(q, part_ids, qsel, k_out):
        return lib_scan_f32(q, vec, valid, part_ids, qsel, k_out)

    for label, q, part_ids, qsel, k_out in cases:
        q_i8, alpha, beta = quantize.fold_queries(stats, q)
        n_q = q.shape[0]
        k_sq = min(4 * k_out, part_ids.shape[0] * p_max)

        def k1_call():
            return ivf_scan.ivf_scan_topk(q, vec, valid, ids, part_ids,
                                          k_out, "l2", qsel, None)
        t1 = cuda_ms(k1_call, reps=5)
        t1_dev = kernel_device_ms(k1_call, K1_KERNELS)
        t2 = cuda_ms(lambda: sq_scan.sq_scan_folded(
            q_i8, alpha, beta, lo, scale, codes, valid, None, part_ids,
            k_sq, "l2", qsel, None, norms), reps=5)
        t2_dev = kernel_device_ms(lambda: sq_scan.sq_scan_folded(
            q_i8, alpha, beta, lo, scale, codes, valid, None, part_ids,
            k_sq, "l2", qsel, None, norms), K2_KERNELS)
        b1 = 1e3 * max(k1_bound(part_ids, qsel, valid, n_q, d, p_max, k_out))
        b2 = 1e3 * max(k2_bound(part_ids, qsel, valid, n_q, d, p_max, k_sq))
        parts, rows, pair_rows = scan_work(part_ids, qsel, valid, n_q)
        log(f"  time {label} (n={part_ids.shape[0]}, selected partitions "
            f"{parts}, their valid rows {rows:.0f}, pair rows "
            f"{pair_rows:.0f}): ivf_scan {t1:.4f} ms, its kernels' device "
            f"time {fmt_ms(t1_dev)} (k_out={k_out}, bound {b1:.4f}), "
            f"sq_scan {t2:.4f} ms, its kernels' device time "
            f"{fmt_ms(t2_dev)} (k_out={k_sq}, bound {b2:.4f})")
        if label == timing_case[0]:
            res["ivf_scan_topk"]["device_ms"] = t1_dev
            res["sq_scan_topk"]["device_ms"] = t2_dev
        if qsel is None:
            # the exact route: K1 without row sharing (one query a block),
            # and the dense yardstick, which does exactly K1's work here
            ex = dict(shape=f"Q={n_q} n={part_ids.shape[0]} k_out={k_out}",
                      ms=t1, device_ms=t1_dev, bound_ms=b1,
                      plain_ms=cuda_ms(lambda: ivf_scan.ivf_scan_plain(
                          q, vec, valid, ids, part_ids, k_out), iters=3),
                      library_ms=cuda_ms(lambda: lib_k1(q, part_ids, None,
                                                        k_out), iters=3))
            group = getattr(ivf_scan, "MAX_GROUP", None)
            if group is not None:
                ivf_scan.MAX_GROUP = 1
                try:
                    ex["no_row_sharing_ms"] = cuda_ms(k1_call, reps=5)
                    ex["no_row_sharing_device_ms"] = kernel_device_ms(
                        k1_call, K1_KERNELS)
                finally:
                    ivf_scan.MAX_GROUP = group
            log(f"  time {label} ivf_scan: plain {ex['plain_ms']:.4f} ms, "
                f"library {ex['library_ms']:.4f} ms; without row sharing "
                f"{fmt_ms(ex.get('no_row_sharing_ms'))}, device "
                f"{fmt_ms(ex.get('no_row_sharing_device_ms'))}")
            res["ivf_scan_topk"]["exact"] = ex

    # -- timing at the largest main-path shape ------------------------------
    label, q, part_ids, qsel, k_out = timing_case
    n = part_ids.shape[0]
    n_q = q.shape[0]

    k1 = res["ivf_scan_topk"]
    k1["ms"] = cuda_ms(lambda: ivf_scan.ivf_scan_topk(
        q, vec, valid, ids, part_ids, k_out, "l2", qsel, None), reps=5)
    k1["plain_ms"] = cuda_ms(lambda: ivf_scan.ivf_scan_plain(
        q, vec, valid, ids, part_ids, k_out, "l2", qsel, None), iters=3)
    k1["library_ms"] = cuda_ms(lambda: lib_k1(q, part_ids, qsel, k_out),
                               iters=3)
    b1, o1 = k1_bound(part_ids, qsel, valid, n_q, d, p_max, k_out)
    k1["bound_ms"] = 1e3 * max(b1, o1)
    k1["bound_by"] = "bytes" if b1 >= o1 else "operations"
    k1["shape"] = f"Q={n_q} n={n} p_max={p_max} d={d} k_out={k_out}"

    q_i8, alpha, beta = quantize.fold_queries(stats, q)
    k_sq = min(4 * k_out, n * p_max)

    def lib_k2():
        return lib_scan_int8(q_i8, alpha, beta, codes, norms, valid,
                             part_ids, qsel, k_sq)

    k2 = res["sq_scan_topk"]
    k2["ms"] = cuda_ms(lambda: sq_scan.sq_scan_folded(
        q_i8, alpha, beta, lo, scale, codes, valid, None, part_ids, k_sq,
        "l2", qsel, None, norms), reps=5)
    k2["plain_ms"] = cuda_ms(lambda: sq_scan.sq_scan_plain(
        q_i8, alpha, beta, lo, scale, codes, valid, None, part_ids, k_sq,
        "l2", qsel, None, norms), iters=3)
    k2["library_ms"] = cuda_ms(lib_k2, iters=3)
    b2, o2 = k2_bound(part_ids, qsel, valid, n_q, d, p_max, k_sq)
    k2["bound_ms"] = 1e3 * max(b2, o2)
    k2["bound_by"] = "bytes" if b2 >= o2 else "operations"
    k2["shape"] = f"Q={n_q} n={n} p_max={p_max} d={d} k_out={k_sq}"

    # the build's final pass: balance_weight 0, so the penalty is zero
    pen0 = torch.zeros((k,), dtype=torch.float32, device=vec.device)
    s_rows = batch.shape[0]

    def lib_k3():
        dist = torch.sum(cents * cents, -1)[None, :] \
            - 2.0 * f32_matmul(batch, cents.T)
        return torch.argmin(dist, dim=1)

    # the build's last batch of 1M rows is ragged: 1,000,000 % 4096 = 576.
    # Each shape also as K3's kernels' device time in a profiler trace.
    for rows in (576, s_rows):
        xb = batch[:rows].contiguous()
        t_w = cuda_ms(lambda: kmeans_assign.kmeans_assign(xb, cents, pen0),
                      reps=5)
        t_dev = kernel_device_ms(
            lambda: kmeans_assign.kmeans_assign(xb, cents, pen0), K3_KERNELS)
        log(f"  time kmeans_assign [s={rows} k={k} d={d}]: kernel {t_w:.4f}"
            f" ms, its kernels' device time {fmt_ms(t_dev)}, bound "
            f"{1e3 * max(k3_bound(rows, k, d)):.4f} ms")
        if rows == s_rows:
            res["kmeans_assign"]["device_ms"] = t_dev
    k3 = res["kmeans_assign"]
    k3["ms"] = cuda_ms(lambda: kmeans_assign.kmeans_assign(batch, cents,
                                                           pen0), reps=5)
    k3["plain_ms"] = cuda_ms(lambda: kmeans_assign.kmeans_assign_plain(
        batch, cents, pen0))
    k3["library_ms"] = cuda_ms(lib_k3)
    b3, o3 = k3_bound(s_rows, k, d)
    k3["bound_ms"] = 1e3 * max(b3, o3)
    k3["bound_by"] = "bytes" if b3 >= o3 else "operations"
    k3["shape"] = f"s={s_rows} k={k} d={d}"
    for name, r in res.items():
        log(f"  time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def random_probe_cases(kp, device, gen, queries, n_probe=8):
    """(label, queries, part_ids, qsel, k_out) cases with a random probe
    union (quick mode has no clustering to probe)."""
    import torch
    cases = []
    for n_q in (1, 512):
        q = queries[:n_q]
        parts = torch.stack([torch.randperm(kp, generator=gen,
                                            device=device)[:n_probe]
                             for _ in range(n_q)])
        union = torch.unique(parts).to(torch.int32)
        qsel = (parts[:, :, None] == union[None, None, :].long()).any(1)
        cases.append((f"ann Q={n_q}", q, union, qsel, 100))
    cases.insert(1, ("exact Q=8", queries[:8],
                     torch.arange(kp, dtype=torch.int32, device=device),
                     None, 100))
    return cases


def quick():
    """Build, launch each kernel once at real widths against its plain
    version, stop."""
    import torch
    from repro_torch.core import quantize
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kp, p_max, d = 10000, 128, 128
    vec = torch.randn((kp, p_max, d), generator=g, device=dev) * 4
    valid = torch.rand((kp, p_max), generator=g, device=dev) < 0.9
    ids = torch.arange(kp * p_max, dtype=torch.int32,
                       device=dev).reshape(kp, p_max)
    stats = quantize.train(vec.reshape(-1, d))
    codes = quantize.encode(stats, vec)
    attrs = torch.stack([torch.randint(0, 10, (kp, p_max), generator=g,
                                       device=dev).float(),
                         torch.rand((kp, p_max), generator=g, device=dev)],
                        -1)
    idx = dict(vectors=vec, valid=valid, ids=ids, codes=codes, lo=stats.lo,
               scale=stats.scale, norms=quantize.row_norms(stats, codes),
               centroids=vec[:, 0, :].contiguous(), attrs=attrs)
    queries = vec[:512, 1, :] + 0.1 * torch.randn((512, d), generator=g,
                                                  device=dev)
    cases = random_probe_cases(kp, dev, g, queries)
    batch = vec[:32, :, :].reshape(-1, d)[:4096].contiguous()
    check_kernels(idx, cases, batch, timed=False)
    log("quick: every kernel built, launched and agreed with its plain "
        "version")


# ---------------------------------------------------------------------------
# phase 3: the main path at real size
# ---------------------------------------------------------------------------


class StepTimers:
    """Wall time (with a device sync) of named library functions while
    active, by wrapping them from outside: where build() and recover()
    spend their time, without instrumenting the engine."""

    def __init__(self, targets):
        self.targets = targets           # (owner, attribute name) pairs
        self.secs = {}
        self.events = []                 # (label, start, seconds) per call
        self._saved = []

    def __enter__(self):
        import torch
        for owner, name in self.targets:
            fn = getattr(owner, name)
            label = f"{getattr(owner, '__name__', owner)}.{name}"

            def timed(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    self.secs[_label] = self.secs.get(_label, 0.0) + dt
                    self.events.append((_label, t0, dt))
            self._saved.append((owner, name, fn))
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        return False

    def report(self, phase):
        for label, sec in self.secs.items():
            log(f"  {phase} step {label}: {sec:.2f} s")


def step_targets():
    from repro_torch.core import ivf, kmeans
    from repro_torch.storage.store import VectorStore
    return [(VectorStore, "all_rows"), (VectorStore, "attributes_for"),
            (VectorStore, "codes_for"), (VectorStore, "set_code_tier"),
            (VectorStore, "set_partitions"), (ivf, "build_index"),
            (kmeans.MiniBatchKMeans, "fit"),
            (kmeans.MiniBatchKMeans, "assign"), (ivf, "pack_partitions"),
            (ivf, "index_from_packed")]


def _rm_db(path: Path):
    for suffix in ("", "-wal", "-shm"):
        p = Path(str(path) + suffix)
        if p.exists():
            p.unlink()


def oracle_topk(Xg, x2, q, k):
    """Brute-force ground truth on the card (torch.topk is the oracle
    here, not the port): [Q, k] row ids by f32 distance."""
    import torch
    from repro_torch.core.types import f32_matmul
    out = []
    for s in range(0, q.shape[0], 64):
        qb = q[s:s + 64]
        d2 = x2[None, :] - 2.0 * f32_matmul(qb, Xg.T)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    return torch.cat(out)


def true_d2(Xg, q, ids):
    """float64 ||q - x||^2 for [Q, k] ids (-1 -> inf)."""
    import torch
    safe = ids.clamp(min=0).long()
    diff = Xg[safe].double() - q.double()[:, None, :]
    d2 = (diff * diff).sum(-1)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))


def recall(ids, gt):
    import numpy as np
    ids, gt = np.asarray(ids), np.asarray(gt)
    hits = sum(len(set(a[a >= 0].tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt))
    return hits / gt.size


def exact_recall(Xg, q, ids, gt, v2_max):
    """recall@k where a result outside the oracle's set counts as a match
    when its true distance lies within the tolerance of the oracle's k-th
    (a swap at the boundary between two tied scores). -> (recall, swaps)."""
    import numpy as np
    import torch
    dg = true_d2(Xg, q, gt)                        # [Q, k]
    dr = true_d2(Xg, q, ids)
    kth = dg.max(dim=1).values
    tol = torch.as_tensor(1e-5 * (torch.sum(q.double() ** 2, -1).cpu().numpy()
                                  + v2_max), device=q.device)
    hits = swaps = 0
    ids_np, gt_np = ids.cpu().numpy(), gt.cpu().numpy()
    ok = (dr <= (kth + tol)[:, None]).cpu().numpy()
    for qi in range(ids_np.shape[0]):
        g = set(gt_np[qi].tolist())
        for j, a in enumerate(ids_np[qi]):
            if a in g:
                hits += 1
            elif a >= 0 and ok[qi, j]:
                hits += 1
                swaps += 1
    return hits / gt_np.size, swaps


def timed_query(eng, q, spec, reps=2):
    import torch
    res = None
    dt = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.query(q, spec)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
    return res, dt


def main_path():
    import numpy as np
    import torch
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q as QB
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.storage.engine import MicroNN

    t0 = time.perf_counter()
    ds = synthetic.make("sift", scale=1.0, with_gt=False, seed=0)
    X, queries = ds.X, ds.Q
    n, d = X.shape
    rng = np.random.default_rng(0)
    attrs = np.stack([rng.integers(0, 10, n).astype(np.float32),
                      rng.random(n).astype(np.float32)], axis=1)
    log(f"phase data: {time.perf_counter() - t0:.1f} s  X={X.shape} "
        f"queries={queries.shape}")
    WORK.mkdir(parents=True, exist_ok=True)
    db = WORK / "sift1m.db"
    _rm_db(db)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # counts cover the main path only
    out = {}
    t0 = time.perf_counter()
    eng = MicroNN(dim=d, n_attr=2, path=str(db), quantize="int8",
                  rerank_factor=4)
    ids = np.arange(n, dtype=np.int64)
    for s in range(0, n, 100_000):
        eng.upsert(ids[s:s + 100_000], X[s:s + 100_000],
                   attrs[s:s + 100_000])
    out["ingest_s"] = time.perf_counter() - t0
    log(f"phase ingest: {out['ingest_s']:.1f} s")
    t0 = time.perf_counter()
    with StepTimers(step_targets()) as tm:
        eng.build()
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    idx = eng.index
    log(f"phase build: {out['build_s']:.1f} s  k={idx.k} p_max={idx.p_max} "
        f"live={idx.num_live()}")
    tm.report("build")

    # -- queries ------------------------------------------------------------
    Xg = torch.from_numpy(X).cuda()
    x2 = torch.sum(Xg * Xg, dim=1)
    v2_max = float(x2.max())
    qg = torch.from_numpy(queries).cuda()
    gt = oracle_topk(Xg, x2, qg, 100)
    rec = {}
    lat = {}
    for n_q in (1, 32, 512):
        q = queries[:n_q]
        n_q = len(q)
        for tier, spec in (("int8", QB.knn(k=100, n_probe=8)),
                           ("f32", QB.knn(k=100, n_probe=8).quantized(False))):
            rs, ms = timed_query(eng, q, spec)
            ids_np, sc = rs.to_numpy()
            check(ids_np.shape == (n_q, 100), f"{tier} result shape")
            check(np.isfinite(sc[ids_np >= 0]).all(), f"{tier} scores")
            lat[f"{tier}_Q{n_q}_ms"] = ms
            if n_q == len(queries):
                rec[tier] = recall(ids_np, gt.cpu().numpy())
    log(f"recall@100 n_probe=8 Q={len(queries)}: int8(rf=4)={rec['int8']:.4f} "
        f"f32={rec['f32']:.4f}")
    check(abs(rec["int8"] - rec["f32"]) <= 0.01,
          "int8 recall is not within 0.01 of f32")
    n_ex = 8
    rs, ms = timed_query(eng, queries[:n_ex], QB.exact(k=100))
    lat[f"exact_Q{n_ex}_ms"] = ms
    ex_ids = torch.as_tensor(rs.to_numpy()[0]).cuda()
    r_ex, swaps = exact_recall(Xg, qg[:n_ex], ex_ids, gt[:n_ex], v2_max)
    log(f"exact recall@100 Q={n_ex}: {r_ex:.4f} (boundary swaps within "
        f"tolerance: {swaps})")
    check(r_ex == 1.0, "exact recall@100 is not 1.000")
    spec_pf = QB.knn(k=100, n_probe=8).where(Pred(0, "==", 3)).postfilter()
    # the same spec on the mask route too (an opaque callable: the engine
    # evaluates the whole-index keep mask and the scan reads it)
    rs, same, qs, qs_m = program_vs_mask(eng, queries[:32], spec_pf)
    lat["postfilter_Q32_ms"], ms = qs[1], qs[1]
    lat["postfilter_mask_route_Q32_ms"], ms_m = qs_m[1], qs_m[1]
    pf_ids = rs.to_numpy()[0]
    got = pf_ids[pf_ids >= 0]
    check(got.size > 0, "post-filter query returned nothing")
    check((attrs[got, 0] == 3).all(), "post-filter result breaks predicate")
    log(f"post-filter: {got.size} hits, all satisfy attr0 == 3; 30 runs "
        f"each, alternating: program route {fmt_q(qs)}, mask route "
        f"{fmt_q(qs_m)}; ids and scores bit for bit equal: {same}")
    check(same, "the post-filter program route differs from the mask "
          "route")
    for k_, v_ in lat.items():
        log(f"latency {k_}: {v_:.3f}")

    # the hybrid path is read on its own: counts so far belong to main
    main_counts = ops.launch_counts()
    out["hybrid"] = hybrid_phase(eng, queries, attrs, Xg, x2, qg, v2_max,
                                 pf_ids)
    out["serving"] = serving_phase(eng, dict(X=X, queries=queries, Xg=Xg,
                                             x2=x2))
    ops.reset_launch_counts()

    # -- writes: upserts visible at once, a delete gone at once --------------
    new_ids = np.arange(n, n + 8, dtype=np.int64)
    new_vecs = (rng.normal(size=(8, d)) * 4 + 40).astype(np.float32)
    eng.upsert(new_ids, new_vecs, np.zeros((8, 2), np.float32))
    rs = eng.query(new_vecs, QB.knn(k=10, n_probe=8))
    check((rs.to_numpy()[0][:, 0] == new_ids).all(),
          "an upserted row is not its own nearest neighbour")
    victim = int(gt[0, 0])
    eng.delete(np.array([victim]))
    rs = eng.query(X[victim:victim + 1], QB.knn(k=10, n_probe=8))
    check(victim not in set(rs.to_numpy()[0][0].tolist()),
          "a deleted row is still returned")
    log(f"writes: 8 upserts found at rank 0, deleted id {victim} gone")
    main_counts = {k_: c + main_counts[k_]
                   for k_, c in ops.launch_counts().items()}
    # the sharded ranks count their own launches, in their own processes
    out["sharded"] = sharded_phase(eng, dict(queries=queries))
    out["maintenance"] = maintenance_phase(
        eng, dict(X=X, queries=queries, Xg=Xg, qg=qg, v2_max=v2_max,
                  new_ids=new_ids, new_vecs=new_vecs, victim=victim))
    ops.reset_launch_counts()

    # -- recover into a second engine ----------------------------------------
    t0 = time.perf_counter()
    eng2 = MicroNN(dim=d, n_attr=2, path=str(db), quantize="int8",
                   rerank_factor=4)
    with StepTimers(step_targets()) as tm:
        eng2.recover()
    out["recover_s"] = time.perf_counter() - t0
    tm.report("recover")
    spec = QB.knn(k=100, n_probe=8)
    a = eng.query(queries[:32], spec)
    b = eng2.query(queries[:32], spec)
    from repro_torch.testing import compare_topk, score_tol
    err, same, bad = compare_topk(a.to_numpy()[1], a.to_numpy()[0],
                                  b.to_numpy()[1], b.to_numpy()[0],
                                  score_tol(queries[:32], v2_max) * 2)
    log(f"recover: {out['recover_s']:.1f} s, same ids={same} "
        f"(max score diff {err:.3e})")
    check(same, "the recovered engine answers differently")

    counts = {k_: c + main_counts[k_]
              for k_, c in ops.launch_counts().items()}
    torch.cuda.synchronize()
    out["launches"] = counts
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"launches on the main path: {counts}")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched on the main path")
    log(f"peak device memory: {out['peak_mem_bytes'] / 2**30:.2f} GiB  "
        f"p_max={idx.p_max} k={idx.k}")
    out.update(recall=rec, exact_recall=r_ex, swaps=swaps, latency_ms=lat,
               p_max=idx.p_max, k=idx.k)
    ctx = dict(eng=eng, eng2=eng2, db=db, X=X, attrs=attrs, queries=queries,
               Xg=Xg, x2=x2, qg=qg, gt=gt, v2_max=v2_max)
    return ctx, out


def quartiles(xs):
    """(lower quartile, median, upper quartile) of a sample."""
    import statistics
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


def program_vs_mask(eng, q, spec, reps=30):
    """The spec on the program route and on the mask route (mask_route),
    alternately `reps` times each through MicroNN.query: (program result,
    whether the mask route's ids and scores equal it bit for bit, program
    ms quartiles, mask-route ms quartiles). Host-clock latencies of ~3 ms
    spread by tenths of a ms, so one run of each would not order them."""
    import numpy as np
    spec_m = mask_route(spec)
    rs, ms_p = timed_query(eng, q, spec, reps=1)
    rs_m, ms_m = timed_query(eng, q, spec_m, reps=1)
    same = all(np.array_equal(a, b) for a, b in zip(rs.to_numpy(),
                                                    rs_m.to_numpy()))
    tp, tm = [], []
    for _ in range(reps):
        tp.append(timed_query(eng, q, spec, reps=1)[1])
        tm.append(timed_query(eng, q, spec_m, reps=1)[1])
    return rs, same, quartiles(tp), quartiles(tm)


def fmt_q(qs):
    return f"{qs[1]:.3f} ms (quartiles {qs[0]:.3f} / {qs[2]:.3f})"


def mask_route(spec):
    """The same spec with its predicate as an opaque callable: the engine
    then evaluates the keep mask over the whole index before the scan (the
    route an opaque filter takes), a check of the program route only."""
    import dataclasses
    from repro_torch.core.hybrid import compile_filter
    f = compile_filter(spec.predicate)
    return dataclasses.replace(spec, predicate=lambda a: f(a),
                               hybrid="post")


def filtered_oracle(Xg, x2, q, keep, k):
    """Brute-force top-k ids over the rows where `keep` (host bool) holds,
    on the card: the pre-filter plan's ground truth."""
    import numpy as np
    import torch
    from repro_torch.core.types import f32_matmul
    sel = torch.from_numpy(np.nonzero(keep)[0]).cuda()
    d2 = x2[sel][None, :] - 2.0 * f32_matmul(q, Xg[sel].T)
    return sel[torch.topk(d2, min(k, sel.numel()), dim=1,
                          largest=False).indices]


def hybrid_phase(eng, queries, attrs, Xg, x2, qg, v2_max, pf_ids):
    """The optimizer on the resident 1M engine: a selective predicate
    (about 500 rows) resolves to the pre-filter plan, whose K1 scan over
    the gathered rows must reach recall@100 = 1.000 against a filtered
    brute force; a broad one resolves to the post-filter plan and returns
    the explicit post-filter query's ids."""
    import numpy as np
    import torch
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = {}
    sel_pred = Pred(1, "<", 0.0005)
    dec = eng.optimizer.choose(eng.index, sel_pred, 8)
    n_ok = int((attrs[:, 1] < 0.0005).sum())
    log(f"hybrid: attr1 < 0.0005 holds on {n_ok} rows; decision "
        f"{dec.plan}, f_filters={dec.f_filters:.6g}, f_ivf={dec.f_ivf:.6g}, "
        f"cap={dec.prefilter_cap}")
    check(dec.plan == "pre", "the selective predicate did not resolve to "
          "the pre-filter plan")
    spec = QB.knn(k=100, n_probe=8).where(sel_pred)
    rs, ms = timed_query(eng, queries[:32], spec)
    ids = rs.to_numpy()[0]
    got = ids[ids >= 0]
    check(ids.shape == (32, 100) and got.size > 0, "pre-filter result shape")
    check((attrs[got, 1] < 0.0005).all(),
          "a pre-filter hit breaks the predicate")
    gt = filtered_oracle(Xg, x2, qg[:32], attrs[:, 1] < 0.0005, 100)
    r_pre, swaps = exact_recall(Xg, qg[:32],
                                torch.as_tensor(ids).cuda(), gt, v2_max)
    log(f"hybrid pre-filter Q=32: {ms:.3f} ms, recall@100 {r_pre:.4f} "
        f"(boundary swaps within tolerance: {swaps})")
    check(r_pre == 1.0, "pre-filter recall@100 is not 1.000")
    broad = Pred(0, "==", 3)
    dec_b = eng.optimizer.choose(eng.index, broad, 8)
    log(f"hybrid: attr0 == 3 decision {dec_b.plan}, "
        f"f_filters={dec_b.f_filters:.6g}, f_ivf={dec_b.f_ivf:.6g}")
    check(dec_b.plan == "post", "the broad predicate did not resolve to "
          "the post-filter plan")
    spec_auto = QB.knn(k=100, n_probe=8).where(broad)
    rs_b, same, qs_b, qs_m = program_vs_mask(eng, queries[:32], spec_auto)
    ms_b, ms_m = qs_b[1], qs_m[1]
    check(np.array_equal(rs_b.to_numpy()[0], pf_ids),
          "auto did not return the explicit post-filter query's ids")
    counts = ops.launch_counts()
    log(f"hybrid post-filter (auto) Q=32, 30 runs each, alternating: "
        f"program route {fmt_q(qs_b)}, ids equal to the explicit "
        f"post-filter query; mask route {fmt_q(qs_m)}, ids and scores bit "
        f"for bit equal: {same}; launches on the hybrid path: {counts}")
    check(same, "the auto->post program route differs from the mask route")
    check(counts["ivf_scan_topk"] > 0,
          "ivf_scan_topk was not launched on the pre-filter path")
    out.update(decision=dec.plan, f_filters=dec.f_filters, f_ivf=dec.f_ivf,
               cap=dec.prefilter_cap, qualifying_rows=n_ok,
               recall=r_pre, swaps=swaps, pre_Q32_ms=ms, post_Q32_ms=ms_b,
               post_mask_route_Q32_ms=ms_m, launches=counts,
               seconds=time.perf_counter() - t0)
    log(f"phase hybrid: {out['seconds']:.2f} s")
    return out


# nvidia-smi's name and power limit of the card, printed beside every
# serving number (set by run())
CARD = ""
SERVE_THREADS, SERVE_PER = 32, 16       # 512 single-row callers
PAGED_SERVE_PER = 4   # paged: 32 x 4 (a Q=32 paged batch is SQLite-bound)
FLIGHT_PER = 8        # 32 x 8 = 256 captured front-door queries
C1_QUERIES = 40_000   # above the 32,768 a K1 / K2 launch takes
OFF_PAIRS, OFF_PER = 20, 100


def scan_launches():
    from repro_torch.kernels import ops
    c = ops.launch_counts()
    return c["ivf_scan_topk"] + c["sq_scan_topk"]


def serve_load(eng, qs, spec, n_threads, per, **fd_kw):
    """`n_threads` caller threads, released together at a barrier, each
    submit `per` single-row queries through one FrontDoor and wait for
    each answer -> (answers in query order as numpy pairs, seconds, the
    front door's stats())."""
    import threading
    from repro_torch.serving import FrontDoor
    out = [None] * (n_threads * per)
    errs = []
    gate = threading.Barrier(n_threads + 1)
    with FrontDoor(eng, **fd_kw) as fd:
        def caller(t):
            gate.wait()
            try:
                for j in range(per):
                    i = t * per + j
                    out[i] = fd.query(qs[i], spec, timeout=600).to_numpy()
            except BaseException as e:  # noqa: BLE001 -- checked below
                errs.append(e)
        ths = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
        for th in ths:
            th.start()
        gate.wait()
        t0 = time.perf_counter()
        for th in ths:
            th.join()
        dt = time.perf_counter() - t0
        st = fd.stats()
    check(not errs, f"front-door callers failed: {errs[:1]}")
    return out, dt, st


def serve_compare(label, eng, qs, spec, n_threads, per):
    """The same single-row queries solo on one thread, then through the
    front door from `n_threads` threads (window 2 ms, max_batch_rows
    512): every answer equal to its solo one bit for bit; both rates."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [eng.query(q, spec).to_numpy() for q in qs]
    dt_solo = time.perf_counter() - t0
    got, dt, st = serve_load(eng, qs, spec, n_threads, per, window_s=0.002,
                             max_batch_rows=512)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(got, solo))
    n = len(qs)
    log(f"serving {label}: {n_threads} threads x {per} single-row queries "
        f"through the front door: {n / dt:.1f} queries/s ({dt:.3f} s); "
        f"batches {st['batches']}, coalesced {st['coalesced']}, solo "
        f"{st['solo']}, occupancy {st['batch_occupancy']:.2f}; queue wait "
        f"p50 {st['queue_wait_p50_ms']:.3f} / p99 "
        f"{st['queue_wait_p99_ms']:.3f} ms, total p50 "
        f"{st['total_p50_ms']:.3f} / p99 {st['total_p99_ms']:.3f} ms; the "
        f"same {n} queries solo on one thread: {n / dt_solo:.1f} queries/s "
        f"({dt_solo:.3f} s); coalesced == solo bit for bit: {same} [{CARD}]")
    check(same, f"serving {label}: a coalesced answer differs from its "
          f"solo query()")
    return dict(qps=n / dt, solo_qps=n / dt_solo, seconds=dt,
                solo_seconds=dt_solo, stats=st)


def check_trace(label, eng, q, spec, stages, paged=False):
    """explain() on one route: the reference's stages in order, span times
    summing to at most total_ms, the scan span's launches equal to the
    K1 / K2 launch delta, and (paged) the fault span equal to the stats()
    deltas."""
    s0 = eng.stats() if paged else None
    l0 = scan_launches()
    tr = eng.explain(q, spec)
    l1 = scan_launches()
    check(tr.span_names == stages,
          f"trace {label}: stages {tr.span_names}, expected {stages}")
    span_ms = sum(s.dur_ms for s in tr.spans.values())
    check(span_ms <= tr.total_ms,
          f"trace {label}: spans {span_ms:.3f} ms > total {tr.total_ms:.3f}")
    check(tr.counter("scan", "launches") == l1 - l0,
          f"trace {label}: scan launches {tr.counter('scan', 'launches')} "
          f"!= launch delta {l1 - l0}")
    extra = ""
    if paged:
        s1 = eng.stats()
        for key in ("hits", "misses", "bytes_read"):
            check(tr.counter("pager_fault", key) == s1[key] - s0[key],
                  f"trace {label}: pager_fault {key} differs from stats()")
        extra = (f", fault hits {tr.counter('pager_fault', 'hits')} misses "
                 f"{tr.counter('pager_fault', 'misses')} bytes_read "
                 f"{tr.counter('pager_fault', 'bytes_read')} (== stats())")
    spans = ", ".join(f"{s.name} {s.dur_ms:.3f}" for s in tr.spans.values())
    log(f"trace {label} Q={tr.n_queries}: {spans} ms; total "
        f"{tr.total_ms:.3f} ms; scan launches {l1 - l0} (== launch delta)"
        f"{extra} [{CARD}]")
    return dict(total_ms=tr.total_ms, spans={s.name: s.dur_ms for s in
                                             tr.spans.values()},
                launches=l1 - l0)


def tracing_off_cost(eng, queries):
    """OFF_PAIRS pairs of windows of OFF_PER untraced Q=1 int8 queries, one
    window under trace.set_enabled(True) and one under False, the order
    alternating: the median of the pair ratios (on / off) must be at most
    1.03."""
    import torch
    from repro_torch.core.query import Q as QB
    from repro_torch.obs import trace as obs_trace
    spec = QB.knn(k=100, n_probe=8)
    qs = [queries[i % len(queries)][None] for i in range(OFF_PER)]

    def window(on):
        obs_trace.set_enabled(on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in qs:
            eng.query(q, spec).to_numpy()
        return (time.perf_counter() - t0) * 1e3 / OFF_PER
    ratios, on_ms, off_ms = [], [], []
    try:
        window(True)
        window(False)
        for p in range(OFF_PAIRS):
            if p % 2 == 0:
                a = window(True)
                b = window(False)
            else:
                b = window(False)
                a = window(True)
            on_ms.append(a)
            off_ms.append(b)
            ratios.append(a / b)
    finally:
        obs_trace.set_enabled(True)
    qr = quartiles(ratios)
    log(f"tracing off: {OFF_PAIRS} pairs of {OFF_PER} untraced int8 Q=1 "
        f"queries; per query enabled {fmt_q(quartiles(on_ms))}, disabled "
        f"{fmt_q(quartiles(off_ms))}; ratio enabled / disabled median "
        f"{qr[1]:.4f} (quartiles {qr[0]:.4f} / {qr[2]:.4f}) [{CARD}]")
    check(qr[1] <= 1.03, f"tracing hooks cost {qr[1]:.4f}x on untraced "
          f"queries (bound 1.03)")
    return dict(ratio_quartiles=qr, on_ms=quartiles(on_ms),
                off_ms=quartiles(off_ms))


def flight_check(label, eng, qs, spec, per):
    """Capture 32 x `per` front-door queries with the flight recorder,
    then replay() the file on the same engine: a bit-identical report."""
    from repro_torch.obs import recorder as obs_recorder
    path = WORK / f"flight-{label}.db"
    _rm_db(path)
    with obs_recorder.recording(str(path)) as rec:
        serve_load(eng, qs, spec, SERVE_THREADS, per, window_s=0.002,
                   max_batch_rows=512)
        n_rec = rec.recorded
    t0 = time.perf_counter()
    rep = obs_recorder.replay(str(path), engine=eng)
    dt = time.perf_counter() - t0
    log(f"flight {label}: {n_rec} records captured ({len(qs)} front-door "
        f"admissions + solo-run engine queries), replayed {rep.replayed} "
        f"in {dt:.2f} s: matched {rep.matched}, self-checked "
        f"{rep.self_checked}, mismatches {len(rep.mismatches)} [{CARD}]")
    check(rep.ok and rep.replayed == n_rec and rep.self_checked == len(qs),
          f"flight {label}: replay diverged ({rep.to_dict()})")
    return dict(records=n_rec, replayed=rep.replayed, seconds=dt)


def c1_check(eng, ctx):
    """C1: one ANN batch of C1_QUERIES queries (bucket 65,536, above the
    65,535 grid rows of a launch) equals the concatenation of its
    32,768 + rest runs bit for bit; its recall@100; and a spec whose
    k_scan exceeds MAX_SCAN_K is refused by name."""
    import numpy as np
    import torch
    from repro_torch.core import executor
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import common
    rng = np.random.default_rng(11)
    base = ctx["queries"]
    q = (base[rng.integers(0, len(base), C1_QUERIES)]
         + rng.normal(size=(C1_QUERIES, base.shape[1]))).astype(np.float32)
    spec = QB.knn(k=100, n_probe=8)
    cut = common.MAX_QUERIES_PER_LAUNCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = eng.query(q, spec).to_numpy()
    dt = time.perf_counter() - t0
    head = eng.query(q[:cut], spec).to_numpy()
    tail = eng.query(q[cut:], spec).to_numpy()
    same = all(np.array_equal(w, np.concatenate([h, t]))
               for w, h, t in zip(whole, head, tail))
    gt = oracle_topk(ctx["Xg"], ctx["x2"], torch.from_numpy(q).cuda(), 100)
    r = recall(whole[0], gt.cpu().numpy())
    torch.cuda.empty_cache()
    log(f"C1: Q={C1_QUERIES} int8 ANN in {dt * 1e3:.1f} ms, equal to its "
        f"{cut} + {C1_QUERIES - cut} slices bit for bit: {same}; "
        f"recall@100 {r:.4f} [{CARD}]")
    check(same, "the 40,000-query batch differs from its two slices")
    k_big = executor.MAX_SCAN_K // eng.config.rerank_factor + 1
    try:
        eng.query(q[:2], QB.knn(k=k_big, n_probe=8))
        refused = ""
    except ValueError as e:
        refused = str(e)
    log(f"C1: k={k_big} on the int8 tier refused: {refused!r}")
    check("exceeds MAX_SCAN_K" in refused,
          "an oversize k_scan was not refused by name")
    return dict(ms=dt * 1e3, recall=r)


def daemon_writes_http(eng, ctx):
    """The front door with the maintenance daemon while a writer upserts
    64 rows in 8 sessions: each write visible to the next front-door
    query; /healthz, /metrics, /traces and /events scraped in 3 rounds
    during the load, each round's answers equal to the same queries'
    answers without a scrape (taken under the engine's write mutex, which
    holds the daemon and the writer still and which neither queries nor
    scrapes take). The rows are deleted afterwards."""
    import threading
    import urllib.request
    import numpy as np
    from repro_torch.core.query import Q as QB
    from repro_torch.obs.http import ExpositionServer
    from repro_torch.serving import FrontDoor
    n, d = ctx["X"].shape
    rng = np.random.default_rng(7)
    new_ids = np.arange(n + 1000, n + 1064, dtype=np.int64)
    new_vecs = (rng.normal(size=(64, d)) * 4 - 40).astype(np.float32)
    knn10 = QB.knn(k=10, n_probe=8)
    knn = QB.knn(k=100, n_probe=8)
    q32 = ctx["queries"][:32]
    steps0 = eng.scheduler.daemon_steps
    srv = ExpositionServer.for_target(eng).start()
    rounds = []
    t0 = time.perf_counter()
    try:
        with FrontDoor(eng, window_s=0.002, max_batch_rows=512,
                       maintenance=True) as fd:
            for s in range(8):
                lo = 8 * s
                with eng.session() as w:
                    w.upsert(new_ids[lo:lo + 8], new_vecs[lo:lo + 8],
                             np.zeros((8, 2), np.float32))
                rs = fd.query(new_vecs[lo:lo + 8], knn10,
                              timeout=600).to_numpy()
                check((rs[0][:, 0] == new_ids[lo:lo + 8]).all(),
                      f"session {s}: a write is not visible to the next "
                      f"query")
                if s not in (1, 4, 7):
                    continue
                pages = {}

                def scrape():
                    for path in ("/healthz", "/metrics", "/traces",
                                 "/events"):
                        with urllib.request.urlopen(srv.url + path,
                                                    timeout=120) as r:
                            pages[path] = (r.status, len(r.read()))
                with eng.lock:
                    quiet = fd.query(q32, knn, timeout=600).to_numpy()
                    th = threading.Thread(target=scrape)
                    th.start()
                    during = fd.query(q32, knn, timeout=600).to_numpy()
                    th.join(300)
                check(len(pages) == 4 and all(c == 200 and b > 0 for c, b
                                              in pages.values()),
                      f"scrape round {len(rounds)}: {pages}")
                same = all(np.array_equal(a, b)
                           for a, b in zip(quiet, during))
                check(same, "answers taken during a scrape differ")
                rounds.append(pages)
            st = fd.stats()
    finally:
        srv.stop()
    dt = time.perf_counter() - t0
    steps = eng.scheduler.daemon_steps - steps0
    check(eng.scheduler.daemon_errors == 0,
          f"daemon error: {eng.scheduler.last_daemon_error!r}")
    eng.delete(new_ids)
    log(f"daemon + writes + HTTP: 8 sessions of 8 upserts each visible to "
        f"the next query; {steps} daemon quanta in {dt:.2f} s; 3 scrape "
        f"rounds of /healthz /metrics /traces /events (bytes "
        f"{[{p: b for p, (_, b) in r.items()} for r in rounds]}), answers "
        f"during each equal to those without; front door batches "
        f"{st['batches']}, solo {st['solo']} [{CARD}]")
    return dict(seconds=dt, daemon_steps=steps, scrape_rounds=len(rounds))


def serving_phase(eng, ctx):
    """The serving layer on the resident 1M int8 engine (after the hybrid
    checks, before the writes): the front door (512 single-row callers on
    32 threads, coalesced == solo bit for bit) on both tiers, explain() on
    every resident route, the cost of the tracing hooks on untraced Q=1,
    a flight-recorder capture replayed bit for bit, C1 (a 40,000-query
    batch, MAX_SCAN_K), then the daemon + writes + HTTP scrapes."""
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    queries = ctx["queries"]
    n = SERVE_THREADS * SERVE_PER
    knn = QB.knn(k=100, n_probe=8)
    out = {"int8": serve_compare("resident int8", eng, queries[:n], knn,
                                 SERVE_THREADS, SERVE_PER),
           "f32": serve_compare("resident f32", eng, queries[:n],
                                knn.quantized(False), SERVE_THREADS,
                                SERVE_PER)}
    q4 = queries[:4]
    ann = ("plan", "probe", "scan", "merge")
    ann_sq = ("plan", "probe", "scan", "rerank", "merge")
    out["traces"] = {
        "int8": check_trace("resident int8", eng, q4, knn, ann_sq),
        "f32": check_trace("resident f32", eng, q4, knn.quantized(False),
                           ann),
        "exact": check_trace("exact", eng, q4, QB.exact(k=100), ann),
        "prefilter": check_trace("pre-filter (auto)", eng, q4,
                                 knn.where(Pred(1, "<", 0.0005)), ann),
        "postfilter": check_trace("post-filter", eng, q4,
                                  knn.where(Pred(0, "==", 3)).postfilter(),
                                  ann_sq)}
    out["tracing_off"] = tracing_off_cost(eng, queries)
    out["flight"] = flight_check("resident", eng,
                                 queries[:SERVE_THREADS * FLIGHT_PER], knn,
                                 FLIGHT_PER)
    out["c1"] = c1_check(eng, ctx)
    out["daemon_http"] = daemon_writes_http(eng, ctx)
    counts = ops.launch_counts()
    log(f"launches on the serving path: {counts}")
    for name in ("ivf_scan_topk", "sq_scan_topk"):
        check(counts[name] > 0, f"{name} was not launched on the serving "
              f"path")
    out.update(launches=counts, seconds=time.perf_counter() - t_phase)
    log(f"phase serving: {out['seconds']:.1f} s")
    return out


def paged_serving(pag, ctx):
    """The paged half of the serving phase, on the 10 MiB int8 pool: the
    front door (32 threads x PAGED_SERVE_PER callers; coalesced == solo
    bit for bit), explain() with the fault span reconciled against
    stats(), and a flight capture replayed bit for bit."""
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    queries = ctx["queries"]
    knn = QB.knn(k=100, n_probe=8)
    n = SERVE_THREADS * PAGED_SERVE_PER
    out = {"int8": serve_compare("paged int8", pag, queries[:n], knn,
                                 SERVE_THREADS, PAGED_SERVE_PER)}
    out["trace"] = check_trace(
        "paged int8", pag, queries[100:104], knn,
        ("plan", "probe", "pager_fault", "scan", "rerank", "merge"),
        paged=True)
    out["flight"] = flight_check("paged", pag, queries[:n], knn,
                                 PAGED_SERVE_PER)
    counts = ops.launch_counts()
    log(f"launches on the paged serving path: {counts}")
    check(counts["sq_scan_topk"] > 0,
          "sq_scan_topk was not launched on the paged serving path")
    out.update(launches=counts, seconds=time.perf_counter() - t0)
    log(f"phase paged serving: {out['seconds']:.1f} s")
    return out


# the maintenance phase's time budget, from which its step count follows
MAINT_BUDGET_S = 60.0


def maintenance_targets():
    from repro_torch.core import maintenance
    from repro_torch.core.monitor import IndexMonitor
    from repro_torch.storage.scheduler import MaintenanceScheduler
    from repro_torch.storage.store import VectorStore
    return [(MaintenanceScheduler, "step"), (IndexMonitor, "work_queue"),
            (maintenance, "plan_split"), (maintenance, "plan_merge"),
            (maintenance, "plan_local_recluster"),
            (maintenance, "apply_plan"), (maintenance, "flush_delta"),
            (maintenance, "repack_partition"),
            (VectorStore, "apply_repair"), (VectorStore, "partitions_for"),
            (VectorStore, "codes_for"), (VectorStore, "set_code_tier"),
            (VectorStore, "set_maintenance_state")]


# step-timer labels by the part of a maintenance step they belong to
MAINT_PARTS = {"work_queue": ("IndexMonitor.work_queue",),
               "plan": ("maintenance.plan_split", "maintenance.plan_merge",
                        "maintenance.plan_local_recluster"),
               "device_apply": ("maintenance.apply_plan",
                                "maintenance.flush_delta",
                                "maintenance.repack_partition"),
               "sqlite": ("VectorStore.apply_repair",
                          "VectorStore.partitions_for",
                          "VectorStore.codes_for",
                          "VectorStore.set_code_tier",
                          "VectorStore.set_maintenance_state")}


def each_action_steps(eng):
    """One step of every other action on the 1M engine, after the drain
    (whose steps are all splits: 1,514 lead the queue): the queue's first
    merge and its flush of the writes' delta (durable), then a local
    recluster of the most drifted partition and a repack of the one with
    the most tombstones (neither is queued: the build leaves no drift and
    one delete no tombstone share near the bar). Each goes through the
    scheduler's callback (MicroNN._execute_work_item), timed by part, and
    must report a step. -> per-action rows."""
    import torch
    from repro_torch.core.monitor import WorkItem
    queue = eng.monitor.work_queue(eng.index)
    picks = {}
    for it in queue:
        if it.action in ("merge", "flush"):
            picks.setdefault(it.action, it)
    check(set(picks) == {"merge", "flush"},
          f"the queue holds no merge or no flush: {sorted(picks)}")
    out = []
    for action in ("merge", "flush", "recluster", "repack"):
        idx = eng.index
        counts = idx.counts.cpu().numpy()
        if action == "recluster":
            p = int(torch.argmax(idx.drift[:idx.k]))
            picks[action] = WorkItem("recluster", (p,), int(counts[p]), 1.0)
        elif action == "repack":
            dead = ((idx.ids != -1) & ~idx.valid).sum(-1)
            p = int(torch.argmax(dead))
            picks[action] = WorkItem("repack", (p,), int(counts[p]), 3.0)
        item = picks[action]
        p_max0, drift0 = idx.p_max, float(idx.drift.max())
        dead0 = int(((idx.ids != -1) & ~idx.valid).sum())
        with StepTimers(maintenance_targets()) as tm:
            t0 = time.perf_counter()
            rep_ = eng._execute_work_item(item,
                                          eng.scheduler.max_rows_per_step)
            torch.cuda.synchronize()
            sdt = time.perf_counter() - t0
        check(rep_ is not None, f"the {action} step planned to a no-op")
        parts = {name: sum(dt for lab, _, dt in tm.events
                           if lab.endswith(labels))
                 for name, labels in MAINT_PARTS.items()}
        idx = eng.index
        row = dict(action=action, pids=list(rep_.pids), rows=rep_.rows,
                   bytes_written=rep_.bytes_written, seconds=sdt,
                   p_max=[p_max0, idx.p_max], **parts)
        out.append(row)
        log(f"  maint {action} {list(item.pids)} rows {rep_.rows}: {sdt:.3f}"
            f" s (plan {parts['plan']:.3f}, device apply "
            f"{parts['device_apply']:.3f}, sqlite {parts['sqlite']:.3f}); "
            f"p_max {p_max0} -> {idx.p_max}, delta live "
            f"{int(idx.delta.valid.sum())}, max drift {drift0:.4f} -> "
            f"{float(idx.drift.max()):.4f}, tombstones {dead0} -> "
            f"{int(((idx.ids != -1) & ~idx.valid).sum())}")
    check(int(eng.index.delta.valid.sum()) == 0,
          "the flush step left rows in the delta")
    return out


def maintenance_phase(eng, ctx):
    """Incremental maintenance on the main path's 1M engine, after the
    writes and before recover (so recover and the paged phase read the
    repaired file): the monitor's verdict and work queue, then
    maintain(until_idle=True, max_steps=S) with S sized from one measured
    work_queue call to fit MAINT_BUDGET_S, each step split into work_queue,
    plan, device apply and SQLite, then one step of each other action
    (each_action_steps). Then, as hard checks: exact recall@100
    = 1.000 on 8 oracle queries, ANN recall@100 at n_probe 8 over the 512
    queries within 0.01 of its value before, the upserts still found at
    once and the deleted row still gone."""
    import collections
    import torch
    from repro_torch.core import maintenance
    from repro_torch.core import monitor as monitor_mod
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    queries, qg, Xg = ctx["queries"], ctx["qg"], ctx["Xg"]
    new_ids, new_vecs, victim = ctx["new_ids"], ctx["new_vecs"], \
        ctx["victim"]
    # the oracle over the live rows: the victim gone, the upserts in (row
    # index == asset id)
    Xl = torch.cat([Xg, torch.from_numpy(new_vecs).cuda()])
    x2l = torch.sum(Xl * Xl, dim=1)
    x2l[victim] = float("inf")
    gt = oracle_topk(Xl, x2l, qg, 100)
    gt_np = gt.cpu().numpy()
    knn = QB.knn(k=100, n_probe=8)
    r_before = recall(eng.query(queries, knn).to_numpy()[0], gt_np)
    health = eng.monitor.check(eng.index)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items = eng.monitor.work_queue(eng.index)
    torch.cuda.synchronize()
    wq_s = time.perf_counter() - t0
    by_action = dict(collections.Counter(it.action for it in items))
    # where a work_queue call goes: the blocked centroid spacing (device)
    # and the merge loop's partner choices (host), in a second call
    with StepTimers([(monitor_mod, "centroid_spacing"),
                     (maintenance, "choose_merge_partner")]) as wq_tm:
        eng.monitor.work_queue(eng.index)
    wq_parts = {lab.rsplit(".", 1)[-1]: sec
                for lab, sec in wq_tm.secs.items()}
    n_partner = sum(1 for e in wq_tm.events
                    if e[0].endswith("choose_merge_partner"))
    log(f"maintenance: monitor verdict {health.action} (growth "
        f"{health.growth:.4f}, tombstones {health.tombstone_fraction:.2e}, "
        f"delta pressure {health.delta_pressure:.4f}); work queue "
        f"{len(items)} items {by_action}; one work_queue call "
        f"{wq_s:.3f} s at k={eng.index.k}: centroid_spacing "
        f"{wq_parts.get('centroid_spacing', 0.0):.3f} s, "
        f"{n_partner} choose_merge_partner calls "
        f"{wq_parts.get('choose_merge_partner', 0.0):.3f} s (timed one "
        f"by one, in a second call)")
    # every step polls the queue afresh (one work_queue call), plans,
    # applies on the device and commits to SQLite: budget ~2 work_queue
    # calls + 0.3 s a step
    steps = int(max(4, min(64, MAINT_BUDGET_S / (2 * wq_s + 0.3))))
    log(f"maintenance: S = {steps} steps (MAINT_BUDGET_S {MAINT_BUDGET_S} "
        f"s / (2 x work_queue {wq_s:.3f} s + 0.3 s), within [4, 64])")
    t0 = time.perf_counter()
    with StepTimers(maintenance_targets()) as tm:
        reports = eng.maintain(until_idle=True, max_steps=steps)
    drain_s = time.perf_counter() - t0
    rows = []
    step_events = [e for e in tm.events
                   if e[0] == "MaintenanceScheduler.step"]
    for i, ((_, st0, sdt), rep_) in enumerate(zip(step_events, reports)):
        parts = {name: sum(dt for lab, t, dt in tm.events
                           if lab.endswith(labels) and st0 <= t <= st0 + sdt)
                 for name, labels in MAINT_PARTS.items()}
        rows.append(dict(action=rep_.action, pids=list(rep_.pids),
                         rows=rep_.rows, bytes_written=rep_.bytes_written,
                         seconds=sdt, **parts))
        log(f"  maint step {i}: {rep_.action} {rep_.pids} rows {rep_.rows}"
            f": {sdt:.3f} s (work_queue {parts['work_queue']:.3f}, plan "
            f"{parts['plan']:.3f}, device apply {parts['device_apply']:.3f}"
            f", sqlite {parts['sqlite']:.3f})")
    tm.report("maintenance")
    done = collections.Counter(r.action for r in reports)
    log(f"maintenance: {len(reports)} steps in {drain_s:.2f} s {dict(done)}"
        f"; k={eng.index.k} p_max={eng.index.p_max}; scheduler "
        f"{eng.scheduler.stats()}")
    check(len(reports) > 0, "maintenance ran no step")
    each = each_action_steps(eng)
    # -- checks on the repaired index -----------------------------------------
    n_ex = 8
    ex = torch.as_tensor(eng.query(queries[:n_ex], QB.exact(k=100))
                         .to_numpy()[0]).cuda()
    r_ex, swaps = exact_recall(Xl, qg[:n_ex], ex, gt[:n_ex], ctx["v2_max"])
    r_after = recall(eng.query(queries, knn).to_numpy()[0], gt_np)
    log(f"maintenance: exact recall@100 Q={n_ex} {r_ex:.4f} (swaps "
        f"{swaps}); ANN recall@100 n_probe 8 Q={len(queries)}: before "
        f"{r_before:.4f}, after {r_after:.4f}")
    check(r_ex == 1.0, "exact recall@100 after maintenance is not 1.000")
    check(abs(r_after - r_before) <= 0.01, "ANN recall moved by more than "
          "0.01 through maintenance")
    rs = eng.query(new_vecs, QB.knn(k=10, n_probe=8)).to_numpy()[0]
    check((rs[:, 0] == new_ids).all(), "an upserted row is not found at "
          "rank 0 after maintenance")
    rs = eng.query(ctx["X"][victim:victim + 1], QB.knn(k=10, n_probe=8))
    check(victim not in set(rs.to_numpy()[0][0].tolist()),
          "the deleted row came back after maintenance")
    counts = ops.launch_counts()
    out = dict(verdict=health.action, queue=by_action,
               work_queue_s=wq_s, work_queue_parts=wq_parts,
               merge_partner_calls=n_partner, k=eng.index.k,
               max_steps=steps,
               steps=rows, drain_s=drain_s, each_action=each,
               recall_before=r_before,
               recall_after=r_after, exact_recall=r_ex, launches=counts,
               seconds=time.perf_counter() - t_phase)
    log(f"phase maintenance: {out['seconds']:.1f} s; launches (its check "
        f"queries) {counts}")
    return out


PAGED_BUDGET_MB = 10


def paged_phase(ctx):
    """The disk-resident mode on the main path's file, after recover: an
    int8 pool and an f32 pool of PAGED_BUDGET_MB each answer like the
    recovered resident engine (eng2), ids equal and scores bit for bit;
    paged exact on the int8 pool; the pool's bytes stay within the
    budget. The resident answers are taken before the counters are
    zeroed, so the counts are the paged path's own."""
    import numpy as np
    import torch
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    from repro_torch.storage.engine import MicroNN
    t_phase = time.perf_counter()
    eng2, queries, db = ctx["eng2"], ctx["queries"], ctx["db"]
    d = queries.shape[1]
    budget = PAGED_BUDGET_MB * 2 ** 20
    knn = QB.knn(k=100, n_probe=8)
    knn_f32 = knn.quantized(False)
    ref = {("int8", nq): eng2.query(queries[:nq], knn).to_numpy()
           for nq in (1, 32, 512)}
    ref.update({("f32", nq): eng2.query(queries[:nq], knn_f32).to_numpy()
                for nq in (1, 32)})
    torch.cuda.synchronize()
    out = {"batches": []}
    ops.reset_launch_counts()
    pools = {}
    for tier, quant, specq, sizes in (("int8", "int8", knn, (1, 32, 512)),
                                      ("f32", None, knn_f32, (1, 32))):
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pag = MicroNN(dim=d, n_attr=2, path=str(db), quantize=quant,
                      rerank_factor=4, memory_budget_mb=PAGED_BUDGET_MB)
        pag.recover()
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() - mem0
        c = pag.index.cache
        log(f"paged {tier}: recover {rec_s:.2f} s; pool {c.capacity} frames "
            f"of {c.frame_bytes} B (p_max {c.p_max}) of {pag.index.k} "
            f"partitions, {c.resident_bytes} B resident of a {budget} B "
            f"budget; device memory the engine holds {held} B")
        check(c.resident_bytes <= budget, "the frame pool exceeds its budget")
        out[tier] = dict(recover_s=rec_s, frames=c.capacity,
                         frame_bytes=c.frame_bytes, p_max=c.p_max,
                         resident_bytes=c.resident_bytes,
                         device_bytes_held=held)
        for nq in sizes:
            for rep in ("cold", "warm"):
                # the pool's counters (MicroNN.stats() adds the
                # scheduler's queue depth: a work_queue call each)
                s0 = pag.index.cache.stats()
                # int8 Q=512 seats no working set (warm = cold): its warm
                # batch is the one the fault path's steps are timed on
                timed_steps = tier == "int8" and nq == 512 and rep == "warm"
                tm = StepTimers(paged_fault_targets() if timed_steps
                                else [])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with tm:
                    rs = pag.query(queries[:nq], specq)
                    ids, sc = rs.to_numpy()
                ms = (time.perf_counter() - t0) * 1e3
                if timed_steps:
                    log(f"paged int8 Q=512 with step timers: {ms:.2f} ms")
                    tm.report("paged int8 Q=512")
                s1 = pag.index.cache.stats()
                row = dict(tier=tier, Q=nq, rep=rep, ms=ms, **{
                    k_: s1[k_] - s0[k_] for k_ in
                    ("hits", "misses", "evictions", "bytes_read",
                     "bytes_staged")}, resident_bytes=s1["resident_bytes"])
                out["batches"].append(row)
                log(f"paged {tier} Q={nq} {rep}: {ms:.2f} ms, hits "
                    f"{row['hits']}, misses {row['misses']}, evictions "
                    f"{row['evictions']}, bytes read {row['bytes_read']} "
                    f"(+{row['bytes_staged']} staged), resident "
                    f"{row['resident_bytes']} B")
                check(s1["resident_bytes"] <= budget,
                      "the frame pool exceeds its budget")
                r_ids, r_sc = ref[(tier, nq)]
                check(np.array_equal(ids, r_ids),
                      f"paged {tier} Q={nq}: ids differ from resident")
                check(np.array_equal(sc, r_sc),
                      f"paged {tier} Q={nq}: scores differ from resident "
                      f"(max {np.abs(sc - r_sc).max():.3e})")
        log(f"paged {tier}: ids and scores equal to the resident engine's, "
            f"bit for bit, at Q={sizes}")
        pools[tier] = pag
    # paged exact on the int8 pool: a full-probe code scan + rerank
    pag = pools["int8"]
    t0 = time.perf_counter()
    rs = pag.query(queries[:8], QB.exact(k=100))
    ex_ids = rs.to_numpy()[0]
    ms = (time.perf_counter() - t0) * 1e3
    r_ex, _ = exact_recall(ctx["Xg"], ctx["qg"][:8],
                           torch.as_tensor(ex_ids).cuda(), ctx["gt"][:8],
                           ctx["v2_max"])
    r_ann = recall(ref[("int8", 512)][0][:8], ctx["gt"][:8].cpu().numpy())
    log(f"paged exact (int8 pool) Q=8: {ms:.1f} ms, recall@100 {r_ex:.4f} "
        f"(resident int8 n_probe 8 on the same queries: {r_ann:.4f}); "
        f"pool stats {pag.index.cache.stats()}")
    check(r_ex >= r_ann, "paged exact recall is below the n_probe-8 recall")
    counts = ops.launch_counts()
    log(f"launches on the paged path: {counts}")
    for name in ("ivf_scan_topk", "sq_scan_topk"):
        check(counts[name] > 0, f"{name} was not launched on the paged path")
    out.update(exact_Q8_ms=ms, exact_recall=r_ex, ann_recall_same_q=r_ann,
               launches=counts)
    out["serving"] = paged_serving(pag, ctx)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase paged: {out['seconds']:.1f} s")
    return out, pools


PAGED_BUILD_ROWS = 100_000


def paged_build_phase(ctx):
    """A paged build (int8, PAGED_BUDGET_MB) of the first PAGED_BUILD_ROWS
    rows into a fresh file: streamed from SQLite, the final assignment
    through K3. Cut to 100,000 rows only to bound the SQLite time (its
    k-means samples scan the table once per iteration); d stays 128."""
    import numpy as np
    import torch
    from repro_torch.core import executor, ivf, kmeans, quantize
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    from repro_torch.storage.engine import MicroNN
    from repro_torch.storage.store import VectorStore
    t_phase = time.perf_counter()
    n = PAGED_BUILD_ROWS
    X, attrs, queries = ctx["X"], ctx["attrs"], ctx["queries"]
    db = WORK / "paged100k.db"
    _rm_db(db)
    t0 = time.perf_counter()
    pb = MicroNN(dim=X.shape[1], n_attr=2, path=str(db), quantize="int8",
                 rerank_factor=4, memory_budget_mb=PAGED_BUDGET_MB)
    pb.upsert(np.arange(n), X[:n], attrs[:n])
    ingest_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with StepTimers([(quantize, "train_from_store"),
                     (VectorStore, "set_code_tier_streaming"),
                     (VectorStore, "sample"),
                     (kmeans.MiniBatchKMeans, "fit"),
                     (kmeans.MiniBatchKMeans, "assign"),
                     (VectorStore, "reassign_partitions")]) as tm:
        pb.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"paged build {n} rows: ingest {ingest_s:.1f} s, build {build_s:.1f}"
        f" s, k={pb.index.k} p_max={pb.index.p_max}; launches on the paged "
        f"build: {counts}")
    tm.report("paged build")
    check(counts["kmeans_assign"] > 0,
          "kmeans_assign was not launched on the paged build")
    # quality: recall against a brute force over the same rows, held to
    # the resident in-memory build of those rows (the same configuration)
    gt = oracle_topk(ctx["Xg"][:n], ctx["x2"][:n], ctx["qg"][:32],
                     100).cpu().numpy()
    knn = QB.knn(k=100, n_probe=8)
    r = recall(pb.query(queries[:32], knn).to_numpy()[0], gt)
    ref = ivf.build_index(X[:n], np.arange(n, dtype=np.int32), attrs[:n],
                          cfg=pb.config, device=pb.device)
    r_ref = recall(executor.run(ref, queries[:32], knn).to_numpy()[0], gt)
    log(f"paged build: recall@100 n_probe 8 Q=32 over the {n} rows: "
        f"{r:.4f} (resident in-memory build of the same rows: {r_ref:.4f})")
    check(r >= r_ref - 0.02, "the paged build's recall@100 is more than "
          "0.02 below the resident build's")
    log(f"phase paged build: {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=n, ingest_s=ingest_s, build_s=build_s,
                kmeans_assign_s=tm.secs.get("MiniBatchKMeans.assign"),
                steps=dict(tm.secs), recall=r, resident_recall=r_ref,
                launches=counts, k=int(pb.index.k)), pb


REBUILD_NEW_ROWS = 800       # 0.78 of the default delta: a flush verdict


def rebuild_phase(ctx, pb):
    """Whole-index maintenance on the paged build's 100,000-row file (cut
    from 1M: a rebuild rewrites every row's partition in SQLite, minutes
    at 1M): REBUILD_NEW_ROWS upserts, then maintain() with no `force` must
    act on the monitor's verdict (delta pressure: "flush"); then
    maintain(force="rebuild") on the paged engine and on the same file
    opened resident, each of which must launch K3 (its counts read per
    path) and keep every row, with recall@100 against the oracle of those
    rows within 0.02 of a resident in-memory build of the same rows (the
    paged build phase's criterion; the phase's queries lie near the 1M
    set, so their neighbours among these rows are far and recall is
    low for every build)."""
    import numpy as np
    import torch
    from repro_torch.core import executor, ivf
    from repro_torch.core.query import Q as QB
    from repro_torch.kernels import ops
    from repro_torch.storage.engine import MicroNN
    t_phase = time.perf_counter()
    X, attrs, queries = ctx["X"], ctx["attrs"], ctx["queries"]
    n, m = PAGED_BUILD_ROWS, REBUILD_NEW_ROWS
    knn = QB.knn(k=100, n_probe=8)
    out = {}
    for mode in ("paged", "resident"):
        if mode == "resident":
            db = pb.store.path
            pb.close()
            pb = MicroNN(dim=X.shape[1], n_attr=2, path=db, quantize="int8",
                         rerank_factor=4)
            pb.recover()
        lo, hi = n + (m if mode == "resident" else 0), \
            n + (2 * m if mode == "resident" else m)
        pb.upsert(np.arange(lo, hi), X[lo:hi], attrs[lo:hi])
        verdict = pb.monitor.check(pb.index).action if mode == "resident" \
            else None
        got = pb.maintain()
        log(f"rebuild {mode}: {m} upserts, then maintain() -> {got} "
            f"(delta {pb.index.delta.count} of {pb.index.delta.capacity}"
            + (f"; monitor verdict {verdict}" if verdict else "") + ")")
        check(got == "flush", f"{mode}: maintain() did not take the "
              f"delta-pressure flush")
        check(verdict in (None, got), f"{mode}: maintain() did not act on "
              f"the monitor's verdict")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        check(pb.maintain(force="rebuild") == "rebuild",
              f"{mode}: the forced rebuild did not run")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(counts["kmeans_assign"] > 0, f"kmeans_assign was not "
              f"launched on the {mode} rebuild")
        check(pb.index.num_live() == hi, f"{mode} rebuild lost rows")
        gt = oracle_topk(ctx["Xg"][:hi], ctx["x2"][:hi], ctx["qg"][:32],
                         100).cpu().numpy()
        r = recall(pb.query(queries[:32], knn).to_numpy()[0], gt)
        ref = ivf.build_index(X[:hi], np.arange(hi, dtype=np.int32),
                              attrs[:hi], cfg=pb.config, device=pb.device)
        r_ref = recall(executor.run(ref, queries[:32], knn).to_numpy()[0],
                       gt)
        del ref
        log(f"rebuild {mode}: {secs:.1f} s, k={pb.index.k}, {hi} rows; "
            f"recall@100 n_probe 8 Q=32 {r:.4f} (resident in-memory build "
            f"of the same rows: {r_ref:.4f}); launches {counts}")
        check(r >= r_ref - 0.02, f"{mode} rebuild: recall@100 more than "
              f"0.02 below an in-memory build of the same rows")
        out[mode] = dict(rebuild_s=secs, k=int(pb.index.k), rows=hi,
                         recall=r, resident_build_recall=r_ref,
                         launches=counts)
    db = pb.store.path
    pb.close()
    _rm_db(Path(db))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase rebuild: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the fleet: many tenants on one frame pool
# ---------------------------------------------------------------------------

FLEET_TENANTS = 16
FLEET_ROWS = 25_000          # per tenant: the SIFT row (d = 128)
FLEET_CALLS = 800            # Zipf(1.6) over tenant ranks, 4 rows a call
FLEET_BATCH = 4
FLEET_ZIPF_S = 1.6
FLEET_BACKLOG_ROWS = 900     # 0.88 of the default delta: a flush each
FLEET_REOPEN_LIVE = 4        # the second fleet's max_live: it must spill


def _copy_db(src: Path, dst: Path):
    for suffix in ("", "-wal", "-shm"):
        p = Path(str(src) + suffix)
        if p.exists():
            shutil.copy(p, str(dst) + suffix)


def _fleet_drive(query_fn, tenants, schedule, probes, sample_fn=None):
    """The fixed workload through `query_fn(tenant, q)`: (seconds, answers,
    budget samples at every 16th call)."""
    import torch
    answers, samples = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, r in enumerate(schedule):
        answers.append(query_fn(tenants[r], probes[i]).to_numpy())
        if sample_fn is not None and i % 16 == 0:
            samples.append(sample_fn())
    return time.perf_counter() - t0, answers, samples


def _same_answers(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def fleet_phase():
    """Many tenants, one frame pool (benchmarks/bench_fleet.py's
    configuration at the SIFT row's width): FLEET_TENANTS tenants of
    FLEET_ROWS x 128 rows (data/synthetic's mixture, seed = tenant index,
    2 attributes), int8 with rerank_factor 4, each built once by the paged
    build and copied byte for byte into two arms: one Fleet at budget B
    (the smallest whole MiB that seats one tenant's partitions and not all
    of them) and FLEET_TENANTS solo paged engines at B / FLEET_TENANTS
    each. The same Zipf(1.6) sequence of FLEET_CALLS calls of 4 rows
    (Q.knn(k=10, n_probe=8)) runs through both: every answer equal bit for
    bit, the fleet's resident bytes <= B at every 16th call. Then a second
    Fleet over the same root with max_live=4 (spills and reopens) answers
    the same; upserts into 2 tenants and fleet.maintain() step both through
    the deficit round robin; health() and /healthz; a flight capture
    through the fleet replayed bit for bit."""
    import numpy as np
    import torch
    import urllib.request
    from repro_torch.core.query import Q as QB
    from repro_torch.data import synthetic
    from repro_torch.fleet import Fleet, compute_frame_bytes
    from repro_torch.kernels import ops
    from repro_torch.obs import recorder as obs_recorder
    from repro_torch.obs.http import ExpositionServer
    from repro_torch.storage.engine import MicroNN
    t_phase = time.perf_counter()
    T, n, d = FLEET_TENANTS, FLEET_ROWS, 128
    tenants = [f"user{t}" for t in range(T)]
    work = WORK / "fleet"
    shutil.rmtree(work, ignore_errors=True)
    for sub in ("src", "fleet", "naive"):
        (work / sub).mkdir(parents=True)
    knn = QB.knn(k=10, n_probe=8)
    ops.reset_launch_counts()

    # -- one paged build per tenant ----------------------------------------
    t0 = time.perf_counter()
    probes_by_tenant, k_by, pmax_by = {}, {}, {}
    for t, name in enumerate(tenants):
        ds = synthetic.make("sift", scale=n / 1e6, seed=t, with_gt=False)
        rng = np.random.default_rng(t)
        attrs = np.stack([rng.integers(0, 10, n).astype(np.float32),
                          rng.random(n).astype(np.float32)], axis=1)
        eng = MicroNN(dim=d, n_attr=2, path=str(work / "src" / f"{name}.db"),
                      quantize="int8", rerank_factor=4,
                      memory_budget_mb=PAGED_BUDGET_MB)
        eng.upsert(np.arange(n), ds.X, attrs)
        eng.build()
        k_by[name], pmax_by[name] = eng.index.k, eng.index.cache.p_max
        eng.store.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        eng.close()
        probes_by_tenant[name] = ds.Q
    build_s = time.perf_counter() - t0
    k0, p_max = k_by[tenants[0]], max(pmax_by.values())
    fb = compute_frame_bytes(p_max, d, "int8", 2)
    budget_mb = -(-(k0 * fb) // 2 ** 20)
    log(f"fleet: {T} tenants of {n} x {d} built (paged) in {build_s:.1f} s;"
        f" k {min(k_by.values())}-{max(k_by.values())} (k0 {k0}), p_max "
        f"{min(pmax_by.values())}-{p_max}; frame {fb} B -> budget B = "
        f"{budget_mb} MiB")
    sched_rng = np.random.default_rng(11)
    p = np.arange(1, T + 1, dtype=np.float64) ** -FLEET_ZIPF_S
    schedule = sched_rng.choice(T, size=FLEET_CALLS, p=p / p.sum())
    cursor = {name: 0 for name in tenants}
    probes = []
    for r in schedule:
        name = tenants[r]
        qs = probes_by_tenant[name]
        i = cursor[name] % (len(qs) - FLEET_BATCH)
        cursor[name] += FLEET_BATCH
        probes.append(qs[i:i + FLEET_BATCH])
    out = dict(tenants=T, rows=n, calls=FLEET_CALLS, budget_mb=budget_mb,
               k0=k0, p_max=p_max, build_s=build_s,
               calls_by_tenant=np.bincount(schedule, minlength=T).tolist())

    # -- the fleet arm: ONE pool at budget B -------------------------------
    for name in tenants:
        _copy_db(work / "src" / f"{name}.db", work / "fleet" / f"{name}.db")
        _copy_db(work / "src" / f"{name}.db", work / "naive" / f"{name}.db")
    fleet = Fleet(str(work / "fleet"), dim=d, n_attr=2, budget_mb=budget_mb,
                  max_live=T, quantize="int8", rerank_factor=4)
    for name in tenants:
        fleet.get(name)
    cap = fleet.pool.capacity
    log(f"fleet: pool {cap} frames of {fleet.pool.frame_bytes} B (p_max "
        f"{fleet.pool.p_max}); one tenant has {k0} partitions, all {T} "
        f"{sum(k_by.values())}")
    check(k0 <= cap < T * k0, f"budget premise broken: {k0} <= {cap} < "
          f"{T * k0} does not hold")
    budget = fleet.pool.budget_bytes
    wall_f, ans_f, samples = _fleet_drive(
        lambda t, q: fleet.query(t, q, knn), tenants, schedule, probes,
        sample_fn=lambda: fleet.pool.resident_bytes)
    check(max(samples) <= budget, f"fleet resident bytes {max(samples)} "
          f"exceed the budget {budget}")
    miss_f = sum(fleet.get(t).index.cache.misses for t in tenants)
    frames = {t: v["resident_frames"]
              for t, v in fleet.pool.stats()["tenants"].items()}
    fleet.close()

    # -- the naive arm: T private pools at B / T ---------------------------
    solos = {}
    for name in tenants:
        eng = MicroNN(dim=d, n_attr=2, path=str(work / "naive" /
                                                f"{name}.db"),
                      quantize="int8", rerank_factor=4,
                      memory_budget_mb=budget_mb / T)
        eng.recover()
        solos[name] = eng
    wall_n, ans_n, _ = _fleet_drive(
        lambda t, q: solos[t].query(q, knn), tenants, schedule, probes)
    miss_n = sum(e.index.cache.misses for e in solos.values())
    for eng in solos.values():
        eng.close()
    same = _same_answers(ans_f, ans_n)
    qps_f, qps_n = FLEET_CALLS / wall_f, FLEET_CALLS / wall_n
    log(f"fleet arm: {qps_f:.2f} calls/s ({wall_f:.2f} s), {miss_f} misses;"
        f" naive arm: {qps_n:.2f} calls/s ({wall_n:.2f} s), {miss_n} misses;"
        f" ratio {qps_f / qps_n:.4f}; budget samples max {max(samples)} of "
        f"{budget} B ({len(samples)} samples); every call equal bit for bit:"
        f" {same}")
    log(f"fleet arm frames per tenant at the end: {frames}")
    check(same, "a fleet answer differs from its solo engine's")
    out.update(qps_fleet=qps_f, qps_naive=qps_n, ratio=qps_f / qps_n,
               misses_fleet=miss_f, misses_naive=miss_n, frames=frames,
               capacity=cap, budget_bytes=budget,
               max_resident_bytes=max(samples))

    # -- spill and reopen: a second Fleet, max_live=4 ----------------------
    fleet = Fleet(str(work / "fleet"), dim=d, n_attr=2, budget_mb=budget_mb,
                  max_live=FLEET_REOPEN_LIVE, quantize="int8",
                  rerank_factor=4)
    n_re = FLEET_CALLS // 4
    _, ans_r, _ = _fleet_drive(lambda t, q: fleet.query(t, q, knn), tenants,
                               schedule[:n_re], probes[:n_re])
    st = fleet.stats()
    log(f"fleet reopen (max_live {FLEET_REOPEN_LIVE}): {n_re} calls, {st['tenant_opens']} "
        f"opens, {st['tenant_spills']} spills, answers equal to the first "
        f"fleet's: {_same_answers(ans_r, ans_f[:n_re])}")
    check(_same_answers(ans_r, ans_f[:n_re]),
          "the reopened fleet answers differently")
    check(st["tenant_spills"] > 0, "the second fleet spilled no tenant")
    out["reopen"] = dict(calls=n_re, opens=st["tenant_opens"],
                         spills=st["tenant_spills"])

    # -- health() and /healthz ---------------------------------------------
    for name in tenants:
        fleet.set_slo(name, p99_ms=600_000.0, target=0.5)
    fleet.set_slo(tenants[0], p99_ms=1e-6, target=0.99)
    h = fleet.health()
    check(set(h) == {"schema", "status", "tenants", "degraded", "pool",
                     "daemon_alive", "live_tenants", "noisy_neighbors",
                     "manifest"}, f"health() keys {sorted(h)}")
    check(h["degraded"] == [tenants[0]] and h["status"] == "degraded",
          f"health() verdicts {h['degraded']} {h['status']}")
    check(h["manifest"] == {"orphans": [], "missing": []},
          f"manifest drift {h['manifest']}")
    check(0.0 < h["pool"]["pressure"] <= 1.0, "pool pressure")
    srv = ExpositionServer.for_target(fleet).start()
    try:
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            doc = json.loads(r.read())
    finally:
        srv.stop()
    check(doc["schema"] == 1 and doc["degraded"] == [tenants[0]]
          and set(doc["tenants"]) == set(tenants), "/healthz document")
    log(f"fleet health: status {h['status']}, degraded {h['degraded']}, "
        f"pressure {h['pool']['pressure']:.4f}, noisy neighbours "
        f"{h['noisy_neighbors'][:2]}; {tenants[0]}: "
        f"{h['tenants'][tenants[0]]}; /healthz served the same verdicts")
    out["health"] = dict(status=h["status"], degraded=h["degraded"],
                         pressure=h["pool"]["pressure"],
                         hot_tenant=h["tenants"][tenants[0]])

    # -- a flight capture through the fleet, replayed ----------------------
    cap_path = str(work / "flight.db")
    with obs_recorder.recording(cap_path):
        for i in range(32):
            fleet.query(tenants[schedule[i]], probes[i], knn)
    rep = obs_recorder.replay(cap_path, fleet=fleet)
    log(f"fleet flight: {rep.replayed} replayed, {rep.matched} matched, "
        f"{rep.events} tenant touches, mismatches {len(rep.mismatches)}")
    check(rep.ok and rep.replayed == 32 and rep.events == 32,
          "the fleet capture does not replay bit for bit")

    # -- deficit round robin over two backlogged tenants -------------------
    # the two tenants alone are live: a drain steps through their whole
    # queues (a paged build leaves ~160 splits and merges at k = 250)
    backlogged = [tenants[1], tenants[T - 1]]
    for name in fleet.live_tenants():
        if name not in backlogged:
            fleet.close(name=name)
    for j, name in enumerate(backlogged):
        eng = fleet.get(name)
        rng = np.random.default_rng(100 + j)
        m = FLEET_BACKLOG_ROWS
        eng.upsert(np.arange(n, n + m),
                   probes_by_tenant[name][rng.integers(
                       0, len(probes_by_tenant[name]), m)]
                   + rng.normal(size=(m, d)).astype(np.float32),
                   np.zeros((m, 2), np.float32))
    depth = {t: fleet.get(t).stats()["scheduler_depth"] for t in backlogged}
    steps0 = {t: fleet.get(t).scheduler.daemon_steps for t in backlogged}
    t0 = time.perf_counter()
    first = fleet.maintain(until_idle=False)
    one_round = {t: fleet.get(t).scheduler.daemon_steps - steps0[t]
                 for t in backlogged}
    total = first + fleet.maintain()
    drain_s = time.perf_counter() - t0
    left = {t: fleet.get(t).stats()["scheduler_depth"] for t in backlogged}
    log(f"fleet DRR: queue depth before {depth}; one round stepped "
        f"{one_round}; drained in {total} steps, {drain_s:.2f} s; depth "
        f"after {left}; delta rows after "
        f"{ {t: fleet.get(t).index.delta.count for t in backlogged} }")
    check(all(v >= 1 for v in one_round.values()),
          "a backlogged tenant did not step in the first round")
    check(all(v == 0 for v in left.values()), "maintain() did not drain")
    out["drr"] = dict(depth=depth, first_round=one_round, steps=total,
                      drain_s=drain_s)

    fleet.close()
    counts = ops.launch_counts()
    log(f"launches on the fleet path: {counts}")
    for name in ("sq_scan_topk", "kmeans_assign"):
        check(counts[name] > 0, f"{name} was not launched on the fleet path")
    shutil.rmtree(work, ignore_errors=True)
    out.update(launches=counts, seconds=time.perf_counter() - t_phase)
    log(f"phase fleet: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the sharded index: 4 ranks on one card
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4
SHARDED_TIMEOUT_S = 300


def sharded_rank(rank, world, rdv, index, queries, out_dir):
    """One rank of the sharded phase (spawned): the index arrives by CUDA
    IPC (torch.multiprocessing shares the parent's device tensors), its
    quarter is sliced by shard_index, then distributed_query runs with each
    merge on a gloo group, launches counted from zero; rank 0 then runs
    executor.run on the whole index and compares."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import executor, topk
    from repro_torch.core.query import Q as QB
    from repro_torch.distributed import distributed_query, shard_index
    from repro_torch.kernels import build, ops
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=rdv, world_size=world,
                            rank=rank)
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    t0 = time.perf_counter()
    shard = shard_index(index, mesh, device="cuda")
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    build.load("ivf_scan")      # the library loads outside the timed passes
    q = torch.as_tensor(queries, device="cuda")
    spec = QB.knn(k=100, n_probe=8)
    cap = min(shard.k, q.shape[0] * spec.n_probe)
    res = dict(rank=rank, shard_k=shard.k, shard_s=shard_s,
               ready_at=time.time(), merges={})
    # one untimed, uncounted pass: first-call costs (the library product's
    # handles, the group's first exchanges) stay out of the timed passes
    distributed_query(shard, q, spec, mesh, local_cap=cap)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    answers = {}
    for merge in ("tournament", "allgather"):
        topk.reset_host_staging()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        rs = distributed_query(shard, q, spec, mesh, local_cap=cap,
                               merge=merge)
        answers[merge] = rs.to_numpy()
        wall = time.perf_counter() - t0
        staged = topk.host_staging()
        res["merges"][merge] = dict(
            wall_ms=wall * 1e3, staged_calls=staged["calls"],
            staged_bytes=staged["bytes"], staged_ms=staged["seconds"] * 1e3)
    res["launches"] = ops.launch_counts()
    # K1's device time on this rank, from a trace of one more pass, whose
    # scan inputs are kept for rank 0's kernel row
    seen = {}
    fused = executor.fused_scan

    def capture(*args, **kw):
        seen.update(args=args, kw=kw)
        return fused(*args, **kw)
    executor.fused_scan = capture
    try:
        res["k1_device_ms"] = kernel_device_ms(
            lambda: distributed_query(shard, q, spec, mesh, local_cap=cap),
            K1_KERNELS, iters=2)
    finally:
        executor.fused_scan = fused
    if rank == 0:
        ref = executor.run(index, queries, spec.quantized(False))
        r_ids, r_sc = ref.to_numpy()
        cd = executor._centroid_scores(index.centroids, index.counts,
                                       index.config.metric,
                                       q).sort(dim=-1).values
        gap = ((cd[:, spec.n_probe] - cd[:, spec.n_probe - 1]).abs()
               <= 1e-6 * cd[:, spec.n_probe - 1].abs()).cpu().numpy()
        for merge, (ids, sc) in answers.items():
            rows = np.nonzero((ids != r_ids).any(1)
                              | (sc.view(np.int32)
                                 != r_sc.view(np.int32)).any(1))[0]
            res["merges"][merge].update(
                ids_equal=bool(np.array_equal(ids, r_ids)),
                scores_bitwise=bool(np.array_equal(sc.view(np.int32),
                                                   r_sc.view(np.int32))),
                differing_rows=rows.tolist(),
                boundary_ties=[int(r) for r in rows if gap[r]],
                # diagnosis only: ids in another order among bit-equal
                # scores (a tie-order difference)
                score_ties=[int(r) for r in rows if np.array_equal(
                    sc[r].view(np.int32), r_sc[r].view(np.int32))],
                max_abs_err=float(np.abs(sc - r_sc)[ids >= 0].max()))
        res["k1_row"] = sharded_k1_row(index, seen)
    with open(out_dir / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_k1_row(index, seen):
    """K1 on rank 0's partitions at the sharded pass's own scan inputs
    (`seen`: the fused_scan call of one pass), against its plain version,
    then timed beside it, the library yardstick and the bound."""
    import torch
    from repro_torch.kernels import ivf_scan
    q, vec, valid, ids, part_ids, k_out = seen["args"]
    qsel, metric = seen["kw"]["qsel"], seen["kw"]["metric"]
    args = (q, vec, valid, ids, part_ids, k_out, metric, qsel, None)
    v2_max = float(torch.sum(index.vectors ** 2, -1).max())
    err, ok = compare(ivf_scan.ivf_scan_plain(*args),
                      ivf_scan.ivf_scan_topk(*args), topk_tol(q, v2_max),
                      f"ivf_scan sharded rank 0 Q={q.shape[0]}")
    kern = lambda: ivf_scan.ivf_scan_topk(*args)  # noqa: E731
    n_q, d, p_max = q.shape[0], vec.shape[-1], vec.shape[1]
    return dict(
        shape=f"Q={n_q} n={part_ids.numel()} (rank 0 of "
              f"{SHARDED_RANKS}, {vec.shape[0]} partitions) p_max={p_max} "
              f"k_out={k_out}",
        max_abs_err=err, ids_equal=ok, ms=cuda_ms(kern, reps=5),
        device_ms=kernel_device_ms(kern, K1_KERNELS),
        plain_ms=cuda_ms(lambda: ivf_scan.ivf_scan_plain(*args), iters=3),
        library_ms=cuda_ms(lambda: lib_scan_f32(q, vec, valid, part_ids,
                                                qsel, k_out), iters=3),
        **bound_of(*k1_bound(part_ids, qsel, valid, n_q, d, p_max, k_out)))


def sharded_phase(eng, ctx):
    """The sharded index on a (data 1, model 4) mesh: 4 ranks spawned by
    torch.multiprocessing, all on the one card, on gloo (host-staged
    collectives); each gets the main path's resident index by CUDA IPC and
    slices its quarter (k = 10,000 partitions, the delta holding the 8
    upserted rows), runs distributed_query over the 512 queries with
    Q.knn(k=100, n_probe=8) with each merge; rank 0 holds both against
    executor.run on the whole index (f32): ids equal, scores bit for bit,
    a difference allowed only where the n-th and (n+1)-th centroid scores
    tie within 1e-6 relative (reported)."""
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    out_dir = WORK / "sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    idx = eng.index
    check(idx.k % SHARDED_RANKS == 0, f"k={idx.k} does not split over "
          f"{SHARDED_RANKS} ranks")
    torch.cuda.synchronize()
    t0 = time.time()
    pc = mp.start_processes(
        sharded_rank, args=(SHARDED_RANKS, f"file://{out_dir}/rdv", idx,
                            ctx["queries"], out_dir),
        nprocs=SHARDED_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while not pc.join(timeout=5):
            check(time.monotonic() < deadline, "the sharded ranks did not "
                  f"finish within {SHARDED_TIMEOUT_S} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
        torch.cuda.ipc_collect()    # the ranks' handles on the index
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SHARDED_RANKS)]
    ready_s = max(r["ready_at"] for r in ranks) - t0
    out = dict(ranks=SHARDED_RANKS, ready_s=ready_s, per_rank=[])
    for r in ranks:
        k1 = r["launches"]["ivf_scan_topk"]
        log(f"sharded rank {r['rank']}: {r['shard_k']} partitions, sliced "
            f"in {r['shard_s']:.3f} s; K1 launches {k1}, K1 device "
            f"{fmt_ms(r['k1_device_ms'])} per query pass; " + "; ".join(
                f"{m}: {v['wall_ms']:.1f} ms, host-staged collectives "
                f"{v['staged_calls']} calls / {v['staged_bytes']} B / "
                f"{v['staged_ms']:.2f} ms" for m, v in r["merges"].items()))
        check(k1 > 0, f"K1 was not launched on sharded rank {r['rank']}")
        out["per_rank"].append(dict(
            rank=r["rank"], launches=r["launches"],
            k1_device_ms=r["k1_device_ms"], merges=r["merges"]))
    for merge, v in ranks[0]["merges"].items():
        other = sorted(set(v["differing_rows"]) - set(v["boundary_ties"]))
        log(f"sharded {merge} vs executor.run on the whole index: ids equal "
            f"{v['ids_equal']}, scores bit for bit {v['scores_bitwise']}, "
            f"max |diff| {v['max_abs_err']:.3e}; rows differing "
            f"{v['differing_rows']} (probe-boundary ties "
            f"{v['boundary_ties']}; bit-equal scores in another id order "
            f"{v['score_ties']})")
        check(not other, f"sharded {merge}: rows {other} differ from "
              f"executor.run without a probe-boundary tie")
    row = out["k1_row"] = ranks[0]["k1_row"]
    log(f"  time ivf_scan_topk sharded [{row['shape']}]: kernel "
        f"{row['ms']:.4f} ms, device {fmt_ms(row['device_ms'])}, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    check(row["ids_equal"], "K1 disagrees with its plain version on the "
          "sharded route")
    out["launches"] = {k: sum(r["launches"][k] for r in ranks)
                       for k in ranks[0]["launches"]}
    log(f"launches on the sharded path (4 ranks): {out['launches']}; ranks "
        f"ready (spawn, CUDA IPC, rendezvous) in {ready_s:.1f} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase sharded: {out['seconds']:.1f} s")
    return out


def profile_batch(label, run):
    """Device busy share of one batch (`run()` runs it to the host), from
    a torch.profiler trace: device kernel time over host wall time. The
    trace holds device activity only: with CPU ops in it too, each
    kernel's time is also credited to the op that launched it, and the
    sum counts it twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in rows)
    top = sorted(rows, key=dev_us, reverse=True)[:6]
    if busy <= 0:
        log(f"profile {label}: no device time in the trace (busy share not "
            f"measured)")
        return
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}; top: "
        + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms" for e in top))


def profile_queries(eng, queries):
    """Device busy share of one query batch per tier (and of the exact
    batch), and of the Q=32 batch unfiltered, post-filtered on the program
    route and on the mask route (what the filtered batch adds on the
    card)."""
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q as QB
    int8 = QB.knn(k=100, n_probe=8)
    f32 = QB.knn(k=100, n_probe=8).quantized(False)
    post = int8.where(Pred(0, "==", 3)).postfilter()
    for tier, spec, n_q in (("int8", int8, 1), ("int8", int8, 512),
                            ("f32", f32, 1), ("f32", f32, 512),
                            ("exact", QB.exact(k=100), 8),
                            ("int8", int8, 32),
                            ("post-filter program", post, 32),
                            ("post-filter mask route", mask_route(post),
                             32)):
        profile_batch(f"{tier} Q={n_q}", lambda: eng.query(
            queries[:n_q], spec).to_numpy())


def paged_fault_targets():
    """The paged batch's steps: the fault path, the scans, the SQLite
    rerank. The step timers synchronise the device after each step and
    sum over both threads (the read-ahead thread's stage() overlaps the
    main thread's scans), so the steps can add up to more than the
    batch."""
    from repro_torch.core import executor
    from repro_torch.fleet.pool import FramePool
    from repro_torch.storage.pager import PartitionCache
    from repro_torch.storage.store import VectorStore
    return [(FramePool, "fault"), (FramePool, "stage"),
            (PartitionCache, "_fetch_blocks"),
            (VectorStore, "scan_partitions"), (FramePool, "_write_frames"),
            (executor, "fused_sq_scan"), (executor, "merge_topk"),
            (executor, "_rerank_from_store"), (VectorStore, "vectors_for"),
            (executor, "_merge_epilogue")]


def profile_paged(pools, queries):
    """The device busy share of one paged Q=32 batch on each pool (the
    fault path's steps are timed in the paged phase)."""
    from repro_torch.core.query import Q as QB
    knn = QB.knn(k=100, n_probe=8)
    for tier, pag in pools.items():
        spec = knn.quantized(tier == "int8")
        profile_batch(f"paged {tier} Q=32", lambda: pag.query(
            queries[:32], spec).to_numpy())


def kernel_cases_from_index(idx, queries):
    import torch
    from repro_torch.core import executor
    cases = []
    for n_q in (1, 32, 512):
        q = torch.from_numpy(queries[:n_q]).cuda()
        upart, qsel = executor._probe_union(idx.centroids, idx.counts,
                                            idx.config.metric, q, 8)
        cases.append((f"ann Q={n_q}", q, upart, qsel, 100))
    cases.insert(1, ("exact Q=8", torch.from_numpy(queries[:8]).cuda(),
                     torch.arange(idx.k, dtype=torch.int32,
                                  device=idx.device), None, 100))
    return cases


def timed_kernels(idx, queries):
    """Phase 4 over a built index: every kernel checked and timed at the
    main path's shapes."""
    t0 = time.perf_counter()
    batch = idx.vectors[idx.valid][:4096].contiguous()
    kidx = dict(vectors=idx.vectors, valid=idx.valid, ids=idx.ids,
                codes=idx.codes, lo=idx.qstats.lo, scale=idx.qstats.scale,
                norms=idx.code_norms, centroids=idx.centroids,
                attrs=idx.attrs)
    res = check_kernels(kidx, kernel_cases_from_index(idx, queries), batch,
                        timed=True)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    return res


def check_path_routes(res, ctx, pools):
    """Phase 4 on this slice's routes: K1 on the pre-filter plan's gathered
    rows (the exact route over virtual partitions), and K1 / K2 over the
    first chunk of a Q=512 probe union faulted into the paged pools (frame
    indices as the probe list, asset ids as the ids, the int8 pool's
    norms). Each against its plain version on the same inputs, then timed
    beside it with its bound. These launches are not counted on any
    path."""
    import torch
    from repro_torch.core import executor, quantize
    from repro_torch.core.hybrid import Pred, compile_filter
    from repro_torch.core.types import QuantStats
    from repro_torch.kernels import ivf_scan, sq_scan
    t0 = time.perf_counter()
    eng, qg, v2_max = ctx["eng"], ctx["qg"], ctx["v2_max"]
    idx = eng.index
    d = idx.dim
    f = compile_filter(Pred(1, "<", 0.0005))
    cap = eng.optimizer.choose(idx, Pred(1, "<", 0.0005), 8).prefilter_cap
    q = qg[:32]
    plan = executor.plan_prefilter(idx, q, 100, f, cap)
    sub_v, sub_ok, sub_i, vpart = executor.gather_rows(idx, plan.rows)
    k_out = min(100, sub_ok.numel())
    tol = topk_tol(q, v2_max)
    args = (q, sub_v, sub_ok, sub_i, vpart, k_out, "l2", None, None)
    err, ok = compare(ivf_scan.ivf_scan_plain(*args),
                      ivf_scan.ivf_scan_topk(*args), tol,
                      f"ivf_scan prefilter Q=32 cap={cap}")
    b, o = k1_bound(vpart, None, sub_ok, 32, d, idx.p_max, k_out)
    res["ivf_scan_topk"]["prefilter"] = dict(
        shape=f"Q=32 n={vpart.numel()} (cap {cap}) p_max={idx.p_max} "
              f"k_out={k_out}", max_abs_err=err, ids_equal=ok,
        ms=cuda_ms(lambda: ivf_scan.ivf_scan_topk(*args), reps=5),
        device_ms=kernel_device_ms(lambda: ivf_scan.ivf_scan_topk(*args),
                                   K1_KERNELS),
        plain_ms=cuda_ms(lambda: ivf_scan.ivf_scan_plain(*args), iters=3),
        library_ms=cuda_ms(lambda: lib_scan_f32(q, sub_v, sub_ok, vpart,
                                                None, k_out), iters=3),
        **bound_of(b, o))
    checks = [("ivf_scan_topk", err, ok)]
    q512 = qg[:512]
    qmask = torch.ones((q512.shape[0],), dtype=torch.bool,
                       device=q512.device)
    f_tree = compile_filter(program_preds()[2][1])
    for tier, kname in (("f32", "ivf_scan_topk"), ("int8", "sq_scan_topk")):
        pag = pools[tier]
        cache = pag.index.cache
        upart, qsel = executor._paged_probes(pag.index, q512, 8, qmask)
        pids = upart[:cache.capacity]
        frames = cache.fault(pids)
        try:
            fidx = torch.as_tensor(frames).cuda()
            cq = qsel[:, :len(pids)].contiguous()
            pool_attrs = cache.attrs_pool
            keep = f_tree(pool_attrs)
            if tier == "f32":
                k_out = 100
                args = (q512, cache.payload_pool, cache.valid_pool,
                        cache.ids_pool, fidx, k_out, "l2", cq)
                kw = {}
                scan, plain_fn = ivf_scan.ivf_scan_topk, \
                    ivf_scan.ivf_scan_plain
                lib = lambda f=None: lib_scan_f32(  # noqa: E731
                    q512, cache.payload_pool, cache.valid_pool, fidx, cq,
                    k_out, filt=f)
                bounds = lambda kp=None: k1_bound(  # noqa: E731
                    fidx, cq, cache.valid_pool, 512, d, cache.p_max, k_out,
                    keep=kp, n_attr=pool_attrs.shape[-1])
                kern_names = K1_KERNELS
            else:
                k_out = 400
                st = pag.index.qstats
                q_i8, alpha, beta = quantize.fold_queries(
                    QuantStats(lo=st.lo, scale=st.scale), q512)
                args = (q_i8, alpha, beta, st.lo, st.scale,
                        cache.payload_pool, cache.valid_pool, cache.ids_pool,
                        fidx, k_out, "l2", cq)
                kw = dict(norms=cache.norms_pool)
                scan, plain_fn = sq_scan.sq_scan_folded, \
                    sq_scan.sq_scan_plain
                lib = lambda f=None: lib_scan_int8(  # noqa: E731
                    q_i8, alpha, beta, cache.payload_pool, cache.norms_pool,
                    cache.valid_pool, fidx, cq, k_out, filt=f)
                bounds = lambda kp=None: k2_bound(  # noqa: E731
                    fidx, cq, cache.valid_pool, 512, d, cache.p_max, k_out,
                    keep=kp, n_attr=pool_attrs.shape[-1])
                kern_names = K2_KERNELS
            kern = lambda: scan(*args, **kw)  # noqa: E731
            plain = lambda: plain_fn(*args, **kw)  # noqa: E731
            pkw = dict(kw, attrs=pool_attrs, program=f_tree.program)
            ref, got = plain(), kern()
            pref, pgot = plain_fn(*args, **pkw), scan(*args, **pkw)
            mask_same = same_bits(pgot, scan(*args, keep=keep, **kw))
            if tier == "int8":
                same = same_bits(ref, got) and same_bits(pref, pgot)
                err = float((ref[0] - got[0]).abs().max())
                log(f"  sq_scan paged Q={q512.shape[0]}: bit for bit {same} "
                    f"(max_abs_err={err:.3e}); program route bit for bit "
                    f"equal to the mask route: {mask_same}")
                ok = same and mask_same
            else:
                tol = topk_tol(q512, v2_max)
                err, ok = compare(ref, got, tol,
                                  f"ivf_scan paged Q={q512.shape[0]}")
                err_p, ok_p = compare(pref, pgot, tol,
                                      f"ivf_scan paged program tree")
                log(f"  ivf_scan paged program route bit for bit equal to "
                    f"the mask route: {mask_same}")
                err, ok = max(err, err_p), ok and ok_p and mask_same
            shape = (f"Q={q512.shape[0]} frames={len(pids)} of "
                     f"{cache.capacity} p_max={cache.p_max} k_out={k_out}")
            res[kname]["paged"] = dict(
                shape=shape, max_abs_err=err, ids_equal=ok,
                ms=cuda_ms(kern, reps=5),
                device_ms=kernel_device_ms(kern, kern_names),
                plain_ms=cuda_ms(plain, iters=3),
                library_ms=cuda_ms(lib, iters=3), **bound_of(*bounds()))
            pk = lambda: scan(*args, **pkw)  # noqa: E731
            res[kname]["paged_program"] = dict(
                shape=shape, pred="tree", ms=cuda_ms(pk, reps=5),
                device_ms=kernel_device_ms(pk, kern_names),
                plain_ms=cuda_ms(lambda: plain_fn(*args, **pkw), iters=3),
                library_ms=cuda_ms(lambda: lib((f_tree, pool_attrs)),
                                   iters=3),
                mask_bitwise=mask_same, **bound_of(*bounds(keep)))
            checks.append((kname, err, ok))
        finally:
            cache.unpin(frames)
    for kname, err, ok in checks:
        r = res[kname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ids_equal"] = r["ids_equal"] and ok
        check(ok, f"{kname} disagrees with its plain version on this "
              f"slice's route")
    for kname in ("ivf_scan_topk", "sq_scan_topk"):
        for route in ("prefilter", "paged", "paged_program"):
            e = res[kname].get(route)
            if e:
                log(f"  time {kname} {route} [{e['shape']}]: kernel "
                    f"{e['ms']:.4f} ms, device {fmt_ms(e['device_ms'])}, "
                    f"plain {e['plain_ms']:.4f} ms, library "
                    f"{e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} "
                    f"ms ({e['bound_by']})")
    log(f"phase kernels (slice routes): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the lm phase: llama3-8b at full width serving with MicroNN retrieval
# ---------------------------------------------------------------------------

LM_ARCH = "llama3-8b"
LM_ENTRIES = 262_144         # datastore rows (a kNN-LM store holds 1e8+)
LM_CLUSTERS = 4_096          # components of the clustered mixture
LM_MINIBATCH = 16_384        # the build's k-means mini-batch (lm_datastore)
LM_PADDED_LIMIT = 24e9       # bytes of padded f32 tier the phase accepts
LM_SLOTS, LM_S_MAX = 8, 1024
LM_REQUESTS, LM_PROMPT, LM_NEW = 16, 32, 32
LM_REC_STEPS = 8             # RAG steps whose hidden states are recorded
LM_CHECK_LAYERS, LM_CHECK_PROMPT = 2, 64
LM_FRESH_TOKEN = 4242


def lm_log(msg):
    log(f"lm {msg}  [{CARD}]")


def lm_layout(counts, d, pad_to=8):
    """(k, p_max, largest, median, padded f32 bytes) of a partitioning."""
    import numpy as np
    counts = np.asarray(counts)
    largest = int(counts.max())
    p_max = max(pad_to, -(-largest // pad_to) * pad_to)
    return (len(counts), p_max, largest, float(np.median(counts)),
            len(counts) * p_max * d * 4)


def lm_datastore(cfg, dev):
    """The datastore at LM_ENTRIES x d_model, with the recipe of
    launch/serve.build_rag_datastore (~64 rows a partition, 20 k-means
    iterations, delta 256, a random next token per row and a spare id).
    The recipe's isotropic Gaussians show hubness at d = 4096 (averaged
    centroids have small norms and draw rows), so its padded [k, p_max, d]
    tier is projected first: the recipe's rows with its k-means
    (mini-batch 256), then the clustered mixture (data/synthetic.mixture,
    LM_CLUSTERS components) with it; the first under LM_PADDED_LIMIT is
    built, else the mixture with LM_MINIBATCH rows a k-means step (20 x
    16,384 = 1.25 passes over the rows, where 20 x 256 leaves most
    centroids a seed row or the mean of a few unrelated rows). The launch
    counts are zeroed after the projections, just before the build:
    from there on they count the lm path alone.
    -> (datastore, chosen rows on the host, summary)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import ivf, kmeans
    from repro_torch.core.rag import RagDatastore
    from repro_torch.core.types import IVFConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    d = cfg.d_model
    g = torch.Generator(device=dev).manual_seed(1)
    base = IVFConfig(dim=d, target_partition_size=64, kmeans_iters=20,
                     delta_capacity=256)
    candidates = [
        ("gaussian", lambda: torch.randn((LM_ENTRIES, d), generator=g,
                                         device=dev), base.minibatch_size),
        ("mixture", lambda: synthetic.mixture(LM_ENTRIES, d, LM_CLUSTERS,
                                              seed=1, device=dev),
         base.minibatch_size),
        ("mixture", None, LM_MINIBATCH)]
    out = dict(projections=[])
    X = None
    for i, (rows, make, mb) in enumerate(candidates):
        if make is not None:
            X = make().cpu().numpy()
        if i == len(candidates) - 1:
            break
        t0 = time.perf_counter()
        _, _, assign = kmeans.fit_in_memory(
            X, dataclasses.replace(base, minibatch_size=mb), device=dev)
        lay = lm_layout(np.bincount(assign, minlength=LM_ENTRIES // 64), d)
        out["projections"].append(dict(rows=rows, minibatch=mb, k=lay[0],
                                       p_max=lay[1], largest=lay[2],
                                       median=lay[3], padded_bytes=lay[4]))
        lm_log(f"datastore projection ({rows} rows, k-means mini-batch "
               f"{mb}): k={lay[0]} p_max={lay[1]} largest {lay[2]} median "
               f"{lay[3]:.0f} padded f32 tier {lay[4] / 1e9:.2f} GB "
               f"({time.perf_counter() - t0:.1f} s)")
        if lay[4] <= LM_PADDED_LIMIT:
            break
    torch.cuda.synchronize()
    ops.reset_launch_counts()          # the lm path starts here
    t0 = time.perf_counter()
    index = ivf.build_index(X, cfg=dataclasses.replace(base,
                                                       minibatch_size=mb),
                            device=dev)
    torch.cuda.synchronize()
    out["k3_launches"] = ops.launch_counts()["kmeans_assign"]
    rng = np.random.default_rng(1)
    ds = RagDatastore(index=index, next_token=torch.as_tensor(
        rng.integers(0, cfg.vocab_size, LM_ENTRIES + 1), dtype=torch.int32,
        device=dev))
    lay = lm_layout(index.counts.cpu().numpy(), d)
    out.update(rows=rows, minibatch=mb, build_s=time.perf_counter() - t0,
               k=index.k, p_max=index.p_max, largest=lay[2], median=lay[3],
               padded_bytes=index.k * index.p_max * d * 4)
    lm_log(f"datastore built from {rows} rows, k-means mini-batch {mb}: "
           f"{LM_ENTRIES} x {d} in {out['build_s']:.1f} s with "
           f"{out['k3_launches']} K3 launches; k={index.k} p_max="
           f"{index.p_max} largest {lay[2]} median {lay[3]:.0f} padded f32 "
           f"tier {out['padded_bytes'] / 1e9:.2f} GB")
    check(out["k3_launches"] > 0, "the datastore build launched no K3")
    check(out["padded_bytes"] <= LM_PADDED_LIMIT,
          f"the padded f32 tier ({out['padded_bytes']} B) exceeds "
          f"{LM_PADDED_LIMIT:.0f} B")
    return ds, X, out


def lm_int8_twin(index, rerank_factor=4):
    """The int8 tier over the same partitions: the quantizer trained on the
    stored rows, codes (zero on padding, as the build packs them) and
    norms beside the f32 tensors it shares (the rerank reads them)."""
    import dataclasses
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.types import DeltaStore
    qstats = quantize.train(index.vectors[index.valid])
    codes = torch.zeros(index.vectors.shape, dtype=torch.int8,
                        device=index.device)
    for a in range(0, index.k, 256):
        c = quantize.encode(qstats, index.vectors[a:a + 256])
        codes[a:a + 256] = torch.where(index.valid[a:a + 256, :, None], c,
                                       torch.zeros((), dtype=torch.int8,
                                                   device=c.device))
    return dataclasses.replace(
        index, codes=codes, qstats=qstats,
        code_norms=quantize.row_norms(qstats, codes),
        delta=DeltaStore.empty(index.delta.capacity, index.dim,
                               index.n_attr, quantized=True,
                               device=index.device),
        config=dataclasses.replace(index.config, quantize="int8",
                                   rerank_factor=rerank_factor))


def lm_serve(cfg, model, ds, prompts, slots=LM_SLOTS, s_max=LM_S_MAX,
             new=LM_NEW):
    """One ServeEngine (`slots` slots, `s_max`, RAG with the default
    RagConfig over `ds`, none when it is None) over the prompts,
    max_new_tokens `new` each: the requests, the hidden states and LM
    logits of the first LM_REC_STEPS RAG steps, and times (admission =
    token-by-token prefill; a step's time is step() without its
    admission)."""
    import torch
    from repro_torch.core.rag import RagConfig
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving import engine as engine_mod
    eng = ServeEngine(cfg, model, slots=slots, s_max=s_max, rag=ds,
                      rag_cfg=RagConfig())
    reqs = [Request(uid=i, prompt=list(map(int, p)), max_new_tokens=new)
            for i, p in enumerate(prompts)]
    admit = [0.0]
    rec = dict(hidden=[], logits=[], finite=True)
    plain_admit, plain_rag = eng._admit, engine_mod.rag_decode_logits

    def timed_admit():
        t0 = time.perf_counter()
        plain_admit()
        torch.cuda.synchronize()
        admit[0] += time.perf_counter() - t0

    def recording_rag(ds_, logits, hidden, rcfg, spec=None):
        out = plain_rag(ds_, logits, hidden, rcfg, spec=spec)
        if len(rec["hidden"]) < LM_REC_STEPS:
            rec["hidden"].append(hidden.float().clone())
            rec["logits"].append(logits.float().clone())
        rec["finite"] &= bool(torch.isfinite(logits).all()) and bool(
            torch.isfinite(out).all())
        return out

    eng._admit = timed_admit
    engine_mod.rag_decode_logits = recording_rag
    step_ms = []
    try:
        for r in reqs:
            eng.submit(r)
        t_all = time.perf_counter()
        while not all(r.done for r in reqs):
            check(len(step_ms) < 10 * len(reqs) * new,
                  "the engine does not finish its requests")
            a0, t0 = admit[0], time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t0 - (admit[0] - a0))
                           * 1e3)
        wall = time.perf_counter() - t_all
    finally:
        engine_mod.rag_decode_logits = plain_rag
        del eng._admit    # the wrapper's cycle would keep the model alive
    return eng, reqs, rec, dict(wall_s=wall, prefill_s=admit[0],
                                step_ms=step_ms)


def lm_decode_bound_ms(cfg, model, pos):
    """The least time of one decode step at batch LM_SLOTS and position
    `pos`, by bytes: every parameter read once but the embedding table
    (LM_SLOTS rows of it), the KV entries up to pos read and the new ones
    written. Also every parameter's bytes alone."""
    emb = model.embed.table
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = (cfg.num_layers * 2 * LM_SLOTS * (pos + 2) * cfg.num_kv_heads
          * cfg.head_dim * 2)
    need = params - emb.numel() * emb.element_size() \
        + LM_SLOTS * cfg.d_model * emb.element_size() + kv
    return 1e3 * need / HBM_BYTES_PER_S, 1e3 * params / HBM_BYTES_PER_S


class RouteLog:
    """Records every MoE layer's top-k expert indices (models.moe.route)
    while it is entered, in call order."""

    def __init__(self):
        self.idx = []

    def __enter__(self):
        from repro_torch.models import moe as moe_lib
        self._lib, self._plain = moe_lib, moe_lib.route

        def route(x, router, top_k):
            out = self._plain(x, router, top_k)
            self.idx.append(out[2])
            return out
        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        self._lib.route = self._plain


def decode_matches_forward(c2, dev, tok, frames=None, cache_check=False):
    """c2, a float32 config at full width: decode_step's logits at each
    position of tok [1, S] against forward's within 1e-3 x max |logit|
    (TF32 off). With frames (whisper) the first token goes in by the
    cache fill, as the reference's test does. With cache_check, prefill's
    cache against the step-by-step one (within 1e-3 x max |k, v|,
    positions equal); with experts, every layer's routes equal at every
    position. -> (summary, line)."""
    import torch
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model, prefill)
    from repro_torch.models.decode import fill_cache_from_forward
    t0 = time.perf_counter()
    m2 = init_model(c2, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    s = tok.shape[1]
    batch = {"tokens": tok} if frames is None \
        else {"tokens": tok, "frames": frames}
    with RouteLog() as fwd_routes:
        ref = forward(c2, m2, batch)[0][0]
    tol = 1e-3 * float(ref.abs().max())
    start = 0
    if frames is None:
        cache = init_cache(c2, 1, s, dtype=torch.float32, device=dev)
    else:
        cache = fill_cache_from_forward(
            c2, m2, {"tokens": tok[:, :1], "frames": frames}, s)
        start = 1
    err = 0.0
    with RouteLog() as dec_routes:
        for t in range(start, s):
            lg, _, cache = decode_step(c2, m2, cache, tok[:, t:t + 1], t)
            err = max(err, float((lg[0] - ref[t]).abs().max()))
    out = dict(layers=c2.num_layers, positions=s, max_logit_err=err,
               limit=tol)
    line = (f"decode == forward ({c2.num_layers} layers, float32, d "
            f"{c2.d_model}, vocab {c2.vocab_size}, {s} positions): max "
            f"|logit diff| {err:.3e} (limit {tol:.3e})")
    check(err <= tol, f"{c2.name}: decode_step differs from forward by "
          f"{err:.3e}")
    if fwd_routes.idx:
        n_layers = len(fwd_routes.idx)
        same = all(torch.equal(dec_routes.idx[t * n_layers + i][0, 0],
                               fwd_routes.idx[i][0, t])
                   for t in range(s) for i in range(n_layers))
        out["routes_equal"] = same
        line += f"; top-2 routes equal at every position and layer {same}"
        check(same, f"{c2.name}: decode routes differ from forward's")
    if cache_check:
        _, _, pc = prefill(c2, m2, batch, s)
        cerr, cmax, pos_eq = 0.0, 0.0, True
        for key in pc:
            pos_eq &= torch.equal(pc[key]["pos"], cache[key]["pos"])
            for kv in ("k", "v"):
                cerr = max(cerr, float((pc[key][kv] - cache[key][kv]).abs()
                                       .max()))
                cmax = max(cmax, float(cache[key][kv].abs().max()))
        out["cache_err"] = cerr
        line += (f"; prefill cache vs step-by-step max |diff| {cerr:.3e} of "
                 f"max |k,v| {cmax:.3e}, positions equal {pos_eq}")
        check(pos_eq and cerr <= 1e-3 * cmax,
              f"{c2.name}: prefill's cache differs from the step-by-step "
              f"cache by {cerr}")
    out["seconds"] = time.perf_counter() - t0
    del m2, cache
    torch.cuda.empty_cache()
    return out, line + f" ({out['seconds']:.1f} s)"


def lm_decode_matches_forward(cfg, dev):
    """dataclasses.replace(cfg, num_layers=2, dtype="float32") at full
    width: decode == forward over LM_CHECK_PROMPT TokenStream positions,
    and prefill's cache == the step-by-step cache."""
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenStream
    c2 = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS,
                             dtype="float32")
    tok = torch.as_tensor(next(TokenStream(
        vocab=cfg.vocab_size, batch=1, seq=LM_CHECK_PROMPT,
        seed=0).iter_from(0))["tokens"], device=dev)
    out, line = decode_matches_forward(c2, dev, tok, cache_check=True)
    lm_log(line)
    return out


def lm_scan_rows(ds, twin, Q, plain=True):
    """K1 (k_out 16) and K2 (k_out 64, rerank_factor 4) on the probes of
    Q at n_probe 8, each against its plain version on the same inputs,
    timed beside its bound and, with `plain`, the plain version and the
    library yardstick."""
    import torch
    from repro_torch.core import executor, quantize
    from repro_torch.kernels import ivf_scan, sq_scan
    idx = ds.index
    vec, valid, ids = idx.vectors, idx.valid, idx.ids
    d, p_max = idx.dim, idx.p_max
    v2_max = float(torch.sum(vec * vec, -1).max())
    part_ids, qsel = executor._probe_union(idx.centroids, idx.counts, "l2",
                                           Q, 8)
    n_q = Q.shape[0]
    scanned = scan_work(part_ids, qsel, valid, n_q)[2]
    shape = f"Q={n_q} n={part_ids.numel()} p_max={p_max} d={d}"
    args = (Q, vec, valid, ids, part_ids, 16, "l2", qsel, None)
    err, ok = compare(ivf_scan.ivf_scan_plain(*args),
                      ivf_scan.ivf_scan_topk(*args), topk_tol(Q, v2_max),
                      f"lm ivf_scan {shape} k_out=16")
    k1 = lambda: ivf_scan.ivf_scan_topk(*args)  # noqa: E731
    r1 = dict(shape=f"{shape} k_out=16", rows_scanned=scanned,
              max_abs_err=err, ids_equal=ok, ms=cuda_ms(k1, reps=5),
              device_ms=kernel_device_ms(k1, K1_KERNELS),
              **bound_of(*k1_bound(part_ids, qsel, valid, n_q, d, p_max,
                                   16)))
    st = twin.qstats
    q_i8, alpha, beta = quantize.fold_queries(st, Q)
    sargs = (q_i8, alpha, beta, st.lo, st.scale, twin.codes, valid, None,
             part_ids, 64, "l2", qsel, None, twin.code_norms)
    ref, got = sq_scan.sq_scan_plain(*sargs), sq_scan.sq_scan_folded(*sargs)
    same = same_bits(ref, got)
    err2 = float((ref[0] - got[0]).abs().max())
    log(f"  lm sq_scan {shape} k_out=64: bit for bit {same} "
        f"(max_abs_err={err2:.3e})")
    k2 = lambda: sq_scan.sq_scan_folded(*sargs)  # noqa: E731
    r2 = dict(shape=f"{shape} k_out=64", rows_scanned=scanned,
              max_abs_err=err2, ids_equal=same, ms=cuda_ms(k2, reps=5),
              device_ms=kernel_device_ms(k2, K2_KERNELS),
              **bound_of(*k2_bound(part_ids, qsel, valid, n_q, d, p_max,
                                   64)))
    if plain:
        r1.update(
            plain_ms=cuda_ms(lambda: ivf_scan.ivf_scan_plain(*args),
                             iters=3),
            library_ms=cuda_ms(lambda: lib_scan_f32(Q, vec, valid, part_ids,
                                                    qsel, 16), iters=3))
        r2.update(
            plain_ms=cuda_ms(lambda: sq_scan.sq_scan_plain(*sargs), iters=3),
            library_ms=cuda_ms(lambda: lib_scan_int8(
                q_i8, alpha, beta, twin.codes, twin.code_norms, valid,
                part_ids, qsel, 64), iters=3))
    return r1, r2


def lm_kernel_rows(ds, twin, Q8, H8, rows, build_rows):
    """K1, K2 and K3 at the RAG shapes, each against its plain version on
    the same inputs, then timed beside it, the library yardstick and the
    bound. K1 Q=8, n_probe 8, k_out 16 and K2 the same queries, k_out 64,
    on Q8: stored rows with noise, queries from the store's own
    distribution; the same two on H8, one served decode step's hidden
    states (off the store's distribution: their probes reach partitions of
    few rows), as each row's `decode_probe`. K3 the build's final pass,
    s = 4,096 rows against the k centroids, and at the build's batch of
    `build_rows` rows (`build_batch`)."""
    import torch
    from repro_torch.core.types import f32_matmul
    from repro_torch.kernels import kmeans_assign
    rows_out = {}
    rows_out["ivf_scan_topk"], rows_out["sq_scan_topk"] = lm_scan_rows(
        ds, twin, Q8)
    dec = lm_scan_rows(ds, twin, H8, plain=False)
    rows_out["ivf_scan_topk"]["decode_probe"] = dec[0]
    rows_out["sq_scan_topk"]["decode_probe"] = dec[1]

    cents = ds.index.centroids
    k, d = cents.shape
    batch = torch.as_tensor(rows[:4096], device=cents.device)
    s = batch.shape[0]
    pen0 = torch.zeros((k,), dtype=torch.float32, device=cents.device)
    ra, rc = kmeans_assign.kmeans_assign_plain(batch, cents, pen0)
    ga, gc = kmeans_assign.kmeans_assign(batch, cents, pen0)
    torch.cuda.synchronize()
    ctol = 1e-5 * (torch.sum(batch * batch, -1)
                   + float(torch.sum(cents * cents, -1).max()))
    x64, c64 = batch.double(), cents.double()

    def exact(a):
        return ((x64 - c64[a.long()]) ** 2).sum(-1)
    ok3 = bool(((rc - gc).abs() <= ctol).all()) and bool(
        ((exact(ra) - exact(ga)).abs() <= ctol).all())
    err3 = float((rc - gc).abs().max())
    log(f"  lm kmeans_assign s={s} k={k} d={d}: max_abs_err={err3:.3e} "
        f"ids_equal={ok3} differing_args={int((ra != ga).sum())}")
    # the build's final pass streams batches of max(minibatch, 4096) rows
    # (kmeans.fit_in_memory)
    big = torch.as_tensor(rows[:build_rows], device=cents.device)
    k3 = lambda: kmeans_assign.kmeans_assign(batch, cents, pen0)  # noqa
    rows_out["kmeans_assign"] = dict(
        shape=f"s={s} k={k} d={d}", max_abs_err=err3, ids_equal=ok3,
        ms=cuda_ms(k3, reps=5), device_ms=kernel_device_ms(k3, K3_KERNELS),
        plain_ms=cuda_ms(lambda: kmeans_assign.kmeans_assign_plain(
            batch, cents, pen0), iters=3),
        library_ms=cuda_ms(lambda: torch.argmin(
            torch.sum(cents * cents, -1)[None, :]
            - 2.0 * f32_matmul(batch, cents.T), dim=1), iters=3),
        **bound_of(*k3_bound(s, k, d)),
        build_batch=dict(
            rows=big.shape[0], device_ms=kernel_device_ms(
                lambda: kmeans_assign.kmeans_assign(big, cents, pen0),
                K3_KERNELS, iters=3),
            **bound_of(*k3_bound(big.shape[0], k, d))))
    for name, r in rows_out.items():
        refuse_below_bound(r, f"lm {name}")
        lm_log(f"time {name} RAG shape [{r['shape']}]: kernel "
               f"{r['ms']:.4f} ms, device {fmt_ms(r['device_ms'])}, plain "
               f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
               f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        check(r["ids_equal"], f"{name} disagrees with its plain version at "
              f"the RAG shape")
        if "decode_probe" in r:
            e = r["decode_probe"]
            lm_log(f"time {name} on a decode step's hidden states "
                   f"[{e['shape']}, {e['rows_scanned']:.0f} rows scanned "
                   f"vs {r['rows_scanned']:.0f} for stored rows]: kernel "
                   f"{e['ms']:.4f} ms, device {fmt_ms(e['device_ms'])}, "
                   f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
            check(e["ids_equal"], f"{name} disagrees with its plain version "
                  f"on the decode step's hidden states")
    return rows_out


def lm_witness(X, H, exact, k1_ids, index, rcfg, chunk=16_384):
    """An independent brute force on the host (numpy, float64) over the
    stored rows X (row i is id i) for the recorded hidden states H: it
    holds Q.exact's neighbours, and so the recall of the served probes,
    to an answer that shares no code with the port. Also what the decode
    probes scan and how far H lies from the store."""
    import numpy as np
    from repro_torch.core import executor
    t0 = time.perf_counter()
    h = H.detach().cpu().numpy().astype(np.float64)
    scores = np.empty((X.shape[0], h.shape[0]))
    x2 = np.empty(X.shape[0])
    for a in range(0, X.shape[0], chunk):
        xc = X[a:a + chunk].astype(np.float64)
        x2[a:a + chunk] = (xc * xc).sum(1)
        scores[a:a + chunk] = x2[a:a + chunk, None] - 2.0 * (xc @ h.T)
    top = np.argsort(scores, axis=0, kind="stable")[:rcfg.k].T   # [Q, k]
    nn_dist = np.sqrt(np.maximum(
        scores[top[:, 0], np.arange(h.shape[0])] + (h * h).sum(1), 0.0))
    part_ids, qsel = executor._probe_union(index.centroids, index.counts,
                                           "l2", H, rcfg.n_probe)
    pairs = scan_work(part_ids, qsel, index.valid, H.shape[0])[2]
    w = dict(exact_vs_witness=_recall(exact, top),
             k1_vs_witness=_recall(k1_ids, top),
             rows_scanned_per_query=pairs / H.shape[0],
             mean_norm_hidden=float(np.linalg.norm(h, axis=1).mean()),
             mean_norm_stored=float(np.sqrt(x2).mean()),
             mean_nn_dist=float(nn_dist.mean()),
             seconds=time.perf_counter() - t0)
    lm_log(f"witness (numpy float64 brute force over the {X.shape[0]} "
           f"stored rows, {w['seconds']:.1f} s): Q.exact's top-{rcfg.k} "
           f"against it {w['exact_vs_witness']:.4f}, K1 at n_probe "
           f"{rcfg.n_probe} against it {w['k1_vs_witness']:.4f}; the decode "
           f"probes scan {w['rows_scanned_per_query']:.1f} rows a query "
           f"(the store has {X.shape[0] / index.k:.1f} a partition); mean "
           f"|h| {w['mean_norm_hidden']:.2f}, mean |x| "
           f"{w['mean_norm_stored']:.2f}, mean distance to the nearest "
           f"stored row {w['mean_nn_dist']:.2f}")
    check(w["exact_vs_witness"] >= 0.99, "Q.exact disagrees with the "
          "brute force on the recorded hidden states")
    return w


def _recall(got, want):
    import numpy as np
    return float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / len(b)
                          for a, b in zip(got, want)]))


def lm_phase():
    """The LM serving path (ROADMAP Queue A 16a-i) on the card; see the
    module docstring. -> (summary, kernel rows at the RAG shapes)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import delta, executor
    from repro_torch.core.query import Q as QB
    from repro_torch.core.rag import (RagConfig, RagDatastore, interpolate,
                                      knn_logits, rag_decode_logits)
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ivf_scan, ops
    from repro_torch.models import init_model
    from repro_torch.testing import compare_topk
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(LM_ARCH).config
    lm_log(f"config {cfg.name}: {cfg.num_layers} layers, d_model "
           f"{cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} KV), "
           f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
           f"{cfg.vocab_size}, {cfg.dtype}, rope theta {cfg.rope_theta}, "
           f"{cfg.param_count()} parameters")
    out = {}

    # -- the datastore (K3 in its build; the launch counts are zeroed just
    # before it) and its int8 twin ------------------------------------------
    ds, X, out["datastore"] = lm_datastore(cfg, dev)
    t0 = time.perf_counter()
    twin = lm_int8_twin(ds.index)
    torch.cuda.synchronize()
    out["twin_s"] = time.perf_counter() - t0
    lm_log(f"int8 twin (rerank_factor 4) over the same partitions in "
           f"{out['twin_s']:.1f} s")

    # -- the model ----------------------------------------------------------
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    lm_log(f"init: {n_params} random parameters (seed 0) in "
           f"{out['init_s']:.1f} s")

    # -- serving: 16 requests, twice -----------------------------------------
    prompts = next(TokenStream(vocab=cfg.vocab_size, batch=LM_REQUESTS,
                               seq=LM_PROMPT, seed=0).iter_from(0)
                   )["tokens"][:, :LM_PROMPT]
    eng, reqs, rec, tm = lm_serve(cfg, model, ds, prompts)
    toks = [r.out for r in reqs]
    check(all(r.done and len(r.out) == LM_NEW for r in reqs),
          "a request did not finish with its tokens")
    check(all(0 <= t < cfg.vocab_size for o in toks for t in o),
          "a token lies outside the vocabulary")
    check(rec["finite"], "a logit row is not finite")
    n_tok = sum(len(o) for o in toks)
    sm = np.asarray(tm["step_ms"])
    mean_pos = LM_PROMPT - 1 + LM_NEW / 2
    need_ms, params_ms = lm_decode_bound_ms(cfg, model, int(mean_pos))
    out["serving"] = dict(
        requests=len(reqs), tokens=n_tok, wall_s=tm["wall_s"],
        prefill_s=tm["prefill_s"], steps=len(sm),
        step_ms_p50=float(np.percentile(sm, 50)),
        step_ms_p99=float(np.percentile(sm, 99)),
        tokens_per_s=n_tok / tm["wall_s"], bound_ms=need_ms,
        params_bound_ms=params_ms)
    lm_log(f"served {len(reqs)} requests ({LM_SLOTS} slots, s_max "
           f"{LM_S_MAX}, RAG k=16 n_probe=8 lam=0.25): {n_tok} tokens in "
           f"{tm['wall_s']:.2f} s ({n_tok / tm['wall_s']:.2f} tokens/s), "
           f"token-by-token prefill {tm['prefill_s']:.2f} s; decode step "
           f"with RAG p50 {out['serving']['step_ms_p50']:.3f} ms p99 "
           f"{out['serving']['step_ms_p99']:.3f} ms over {len(sm)} steps")
    del eng
    torch.cuda.empty_cache()
    eng2, reqs2, _, _ = lm_serve(cfg, model, ds, prompts)
    same = [r.out for r in reqs2] == toks
    lm_log(f"second engine, same requests and weights: tokens equal bit "
           f"for bit {same}")
    check(same, "greedy decode is not deterministic across two engines")
    # the engine's decode on its own cache, without and with RAG in turns
    # (host clock around work ending in a synchronize), then one decode
    # step's device time in a trace: the card's busy share of the step
    tok8 = torch.as_tensor(eng2.slot_tok, device=dev)
    pos = [LM_PROMPT + LM_NEW]

    def decode(with_rag):
        lg, hid, _ = eng2._decode(eng2.params, eng2.cache, tok8, pos[0])
        if with_rag:
            rag_decode_logits(ds, lg, hid, rcfg)
        pos[0] += 1
    rcfg = RagConfig()
    times = {False: [], True: []}
    for i in range(32):
        for with_rag in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(with_rag)
            torch.cuda.synchronize()
            times[with_rag].append((time.perf_counter() - t0) * 1e3)
    busy = kernel_device_ms(lambda: decode(False), ("",), iters=3)
    sv = out["serving"]
    for with_rag, key in ((False, "decode"), (True, "decode_rag")):
        sv[f"{key}_ms_p50"] = float(np.percentile(times[with_rag], 50))
        sv[f"{key}_ms_p99"] = float(np.percentile(times[with_rag], 99))
    sv["decode_device_ms"] = busy
    lm_log(f"decode step in turns (32 each): without RAG p50 "
           f"{sv['decode_ms_p50']:.3f} ms p99 {sv['decode_ms_p99']:.3f} ms,"
           f" with RAG p50 {sv['decode_rag_ms_p50']:.3f} ms p99 "
           f"{sv['decode_rag_ms_p99']:.3f} ms; the card busy "
           f"{fmt_ms(busy)} of a step without RAG (torch.profiler); byte "
           f"bound {need_ms:.3f} ms (weights but the embedding table + KV "
           f"at pos {mean_pos:.0f}; all {n_params} parameters alone "
           f"{params_ms:.3f} ms at 3.35e12 B/s)")
    del eng2
    torch.cuda.empty_cache()

    # -- the same 64 rows on the int8 twin (K2), and a fresh upsert --------
    H = torch.cat(rec["hidden"])                       # [64, d] float32
    L = rec["logits"][0]                                # [8, vocab]
    spec = rcfg.spec()
    res_twin = executor.run(twin, H, spec)
    n_new = ds.next_token.shape[0] - 1                  # the spare id
    idx2 = delta.upsert(ds.index, H[:1], torch.tensor([n_new],
                                                      dtype=torch.int32),
                        torch.zeros((1, ds.index.n_attr)))
    nt = ds.next_token.clone()
    nt[n_new] = LM_FRESH_TOKEN
    ds2 = RagDatastore(index=idx2, next_token=nt)
    before = int(torch.argmax(rag_decode_logits(
        ds, L[:1], H[:1], dataclasses.replace(rcfg, lam=0.9))))
    fresh = int(torch.argmax(rag_decode_logits(
        ds2, L[:1], H[:1], dataclasses.replace(rcfg, lam=0.9))))
    launches = ops.launch_counts()
    out["launches"] = launches
    live = (delta.delta_live(ds.index), delta.delta_live(idx2))
    lm_log(f"freshness: upserted one recorded hidden state as id {n_new} "
           f"with next token {LM_FRESH_TOKEN}: argmax at lam 0.9 {before} "
           f"before, {fresh} after; delta_live {live[0]} -> {live[1]}")
    check(fresh == LM_FRESH_TOKEN, "the upserted row does not decide the "
          "next token at lam 0.9")
    check(live == (0, 1), f"delta_live {live} after one upsert")
    lm_log(f"launches on the lm path: {launches}")
    for name in ("ivf_scan_topk", "sq_scan_topk", "kmeans_assign"):
        check(launches[name] > 0, f"{name} was not launched on the lm path")

    # -- retrieval on K1 against the plain scan, recall, lam -> 0 ------------
    v2_max = float(torch.sum(ds.index.vectors ** 2, -1).max())
    tol = topk_tol(H, v2_max)
    k1_res = executor.run(ds.index, H, spec)
    k1_logp = knn_logits(ds, H, cfg.vocab_size, rcfg)
    again = knn_logits(ds, H, cfg.vocab_size, rcfg)
    kernel = ivf_scan.ivf_scan_topk
    ivf_scan.ivf_scan_topk = ivf_scan.ivf_scan_plain    # the plain route
    try:
        pl_res = executor.run(ds.index, H, spec)
        pl_logp = knn_logits(ds, H, cfg.vocab_size, rcfg)
    finally:
        ivf_scan.ivf_scan_topk = kernel
    ki, ks = k1_res.to_numpy()
    pi, ps = pl_res.to_numpy()
    err, ok, bad = compare_topk(ps, pi, ks, ki, tol)
    lp_same = torch.equal(k1_logp, pl_logp)
    lm_log(f"retrieval of {H.shape[0]} recorded rows, K1 vs the plain scan "
           f"through executor.run: ids equal {ok} (rows differing {bad}), "
           f"max |score diff| {err:.3e}; knn_logits of the two routes bit "
           f"for bit {lp_same} (max |diff| "
           f"{float((k1_logp - pl_logp).abs().max()):.3e}); two K1 runs bit "
           f"for bit {torch.equal(k1_logp, again)}")
    check(ok, "K1 retrieval differs from the plain scan")
    check(lp_same, "knn_logits differ between the K1 and the plain route")
    check(torch.equal(k1_logp, again), "knn_logits differ between two runs")
    exact = executor.run(ds.index, H, QB.exact(k=rcfg.k)).to_numpy()[0]
    out["recall_f32"] = _recall(ki, exact)
    out["recall_int8"] = _recall(res_twin.to_numpy()[0], exact)
    out["witness"] = lm_witness(X, H, exact, ki, ds.index, rcfg)
    # the same store for queries from its own distribution: 64 stored rows
    # with noise (the hidden states of a random-weight model lie far from
    # every stored row, where an IVF probe by centroid distance misses)
    g = torch.Generator(device=dev).manual_seed(2)
    pick = torch.randint(0, X.shape[0], (H.shape[0],), generator=g,
                         device=dev)
    Hs = torch.as_tensor(X, device=dev)[pick] + 0.1 * torch.randn(
        H.shape, generator=g, device=dev)
    ex_s = executor.run(ds.index, Hs, QB.exact(k=rcfg.k)).to_numpy()[0]
    own = pick.cpu().numpy()                # row i of X is asset id i
    for tier, index in (("f32", ds.index), ("int8", twin)):
        got = executor.run(index, Hs, spec).to_numpy()[0]
        out[f"recall_{tier}_stored"] = _recall(got, ex_s)
        out[f"self_hit_{tier}"] = float(np.mean(got[:, 0] == own))
    lm_log(f"recall@16 at n_probe 8 against Q.exact on the same store: the "
           f"recorded hidden states f32 (K1) {out['recall_f32']:.4f}, int8 "
           f"twin (K2 + rerank) {out['recall_int8']:.4f}; stored rows + "
           f"noise f32 {out['recall_f32_stored']:.4f}, int8 "
           f"{out['recall_int8_stored']:.4f} (the row itself first: f32 "
           f"{out['self_hit_f32']:.4f}, int8 {out['self_hit_int8']:.4f})")
    check(min(out["self_hit_f32"], out["self_hit_int8"]) >= 0.9,
          "a stored row perturbed by noise does not find itself")
    # lam -> 0 as tests/test_serving.py holds it: a uniform kNN term
    # (a retrieved one-hot term moves a token's log-probability by about
    # lam / p_lm, which at a 128,256 vocabulary exceeds 1e-4)
    lsm = torch.log_softmax(L, -1)
    uni = torch.full_like(L, -float(np.log(cfg.vocab_size)))
    lam0 = float((interpolate(L, uni, 1e-9) - lsm).abs().max())
    lam0_knn = float((interpolate(L, knn_logits(ds, H[:8], cfg.vocab_size,
                                                rcfg), 1e-9) - lsm).abs()
                     .max())
    lm_log(f"lam -> 0: interpolate(lam=1e-9) with a uniform kNN term vs "
           f"log_softmax max |diff| {lam0:.3e} (limit 1e-4); with the "
           f"retrieved term {lam0_knn:.3e}")
    check(lam0 <= 1e-4, "interpolate at lam 1e-9 is not the LM")

    out["k1_step_device_ms"] = kernel_device_ms(
        lambda: knn_logits(ds, H[:8], cfg.vocab_size, rcfg), K1_KERNELS)
    lm_log(f"K1 device time per decode step (Q={LM_SLOTS}, torch.profiler):"
           f" {fmt_ms(out['k1_step_device_ms'])}")

    rows = lm_kernel_rows(ds, twin, Hs[:8], H[:8], X,
                          max(out["datastore"]["minibatch"], 4096))
    k3 = rows["kmeans_assign"]
    lm_log(f"datastore build {out['datastore']['build_s']:.1f} s with "
           f"{out['datastore']['k3_launches']} K3 launches; K3 "
           f"device time per launch [{k3['shape']}] "
           f"{fmt_ms(k3['device_ms'])}, at the build's batch of "
           f"{k3['build_batch']['rows']} rows "
           f"{fmt_ms(k3['build_batch']['device_ms'])}")
    del model, ds2, idx2
    torch.cuda.empty_cache()
    out["decode_vs_forward"] = lm_decode_matches_forward(cfg, dev)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.perf_counter() - t_phase
    lm_log(f"peak device memory {out['peak_gib']:.2f} GiB")
    lm_log(f"phase lm: {out['seconds']:.1f} s")
    return out, rows, dict(ds=ds, twin=twin, X=X)


# ---------------------------------------------------------------------------
# the lm_families phase: phi3.5-moe at full width serving with retrieval,
# then recurrentgemma-2b, xlstm-350m and whisper-medium whole
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe"
MOE_LAYERS = 8               # of 32: the whole model (83.8 GB) exceeds 80 GB
MOE_TOKEN_SEED = 3           # the datastore's next tokens over 32,064
FAM_ARCHS = ("recurrentgemma-2b", "xlstm-350m", "whisper-medium")
FAM_SLOTS, FAM_S_MAX, FAM_PROMPT, FAM_NEW = 8, 256, 32, 16
FAM_ALONE = (0, 5)           # recurrentgemma requests served alone too
# decode == forward in float32 on one whole period at full width:
# (layers, encoder layers, positions)
FAM_CHECK = {"phi3.5-moe": (2, 0, 64), "recurrentgemma-2b": (3, 0, 64),
             "xlstm-350m": (8, 0, 256), "whisper-medium": (2, 2, 16)}


def fam_log(msg):
    log(f"lm_families {msg}  [{CARD}]")


def fam_mem(step):
    import torch
    fam_log(f"memory after {step}: {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB allocated, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")


class ExpertLoad:
    """While entered, each MoE layer's kept choices per expert and its
    dropped choices, summed on the device (no wait) over every dispatch
    (models.moe._dispatch), keyed by the layer's router."""

    def __init__(self, model):
        self.layer = {id(l.moe.router): i for i, l in enumerate(model.layers)
                      if l.moe is not None}
        self.kept, self.drops = {}, {}

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from repro_torch.models import moe as moe_lib
        self._lib, self._plain = moe_lib, moe_lib._dispatch

        def dispatch(xt, router, top_k, cap):
            out = self._plain(xt, router, top_k, cap)
            i, e = self.layer[id(router)], router.shape[1]
            slot, keep = out[1], out[2]
            kept = (F.one_hot(torch.div(slot, cap, rounding_mode="floor"), e)
                    * keep[..., None]).sum((0, 1))
            self.kept[i] = self.kept.get(i, 0) + kept
            self.drops[i] = self.drops.get(i, 0) + (~keep).sum()
            return out
        moe_lib._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self._lib._dispatch = self._plain


def host_ops(fn):
    """torch functions and tensor methods that one fn() calls from Python
    (torch.overrides.TorchFunctionMode): the host's op count."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def moe_decode_bound_ms(cfg, model, pos, active):
    """The least time of one decode step at batch LM_SLOTS and position
    `pos`, by bytes, counting only the experts the step's tokens chose
    (`active`: distinct experts a layer): every other parameter read once
    but the embedding table (LM_SLOTS rows of it), the KV entries up to pos
    read and the new ones written. Also the bound with all experts read
    (what the dense [E, C] dispatch reads)."""
    emb = model.embed.table
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    layer = model.layers[0].moe
    expert = sum(w[0].numel() * w.element_size()
                 for w in (layer.wi, layer.wg, layer.wo))
    idle = sum(cfg.n_experts - a for a in active) * expert
    kv = (cfg.num_layers * 2 * LM_SLOTS * (pos + 2) * cfg.num_kv_heads
          * cfg.head_dim * 2)
    all_bytes = params - emb.numel() * emb.element_size() \
        + LM_SLOTS * cfg.d_model * emb.element_size() + kv
    return 1e3 * (all_bytes - idle) / HBM_BYTES_PER_S, \
        1e3 * all_bytes / HBM_BYTES_PER_S


def moe_split_ms(model, cfg, h):
    """Device ms of one decode step's MoE work at batch LM_SLOTS, from a
    profiler trace of layer 0 on the rows h [LM_SLOTS, 1, d] (bf16), times
    the layer count: routing + dispatch + combine, and the expert
    products."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import einsum
    p = model.layers[0].moe
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, round(1 * k / e * cfg.capacity_factor)))
    rows = h.reshape(LM_SLOTS, 1, -1)
    d = moe_lib._dispatch(rows, p.router, k, cap)
    xe = d[0].reshape(LM_SLOTS, 1, e, cap, -1)

    def experts():
        hh = einsum("bgecd,edf->bgecf", xe, p.wi)
        hh = F.silu(einsum("bgecd,edf->bgecf", xe, p.wg)) * hh
        return einsum("bgecf,efd->bgecd", hh, p.wo)
    ye = experts().reshape(LM_SLOTS, e * cap, -1)

    def routing():
        x = moe_lib._dispatch(rows, p.router, k, cap)
        return moe_lib._combine(ye, x[1], x[2], x[3], x[4], 1, k)
    r = kernel_device_ms(routing, ("",), iters=10)
    x = kernel_device_ms(experts, ("",), iters=10)
    n = cfg.num_layers
    return (None if r is None else r * n), (None if x is None else x * n)


def moe_serving(store, dev):
    """The lm_moe path: phi3.5-moe (MOE_LAYERS layers at full width,
    random weights from seed 0) serving LM_REQUESTS requests with the lm
    phase's datastore and its int8 twin, twice; then the checks and the
    times. -> (summary, K1 / K2 rows on the decode step's hidden
    states)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import executor
    from repro_torch.core.query import Q as QB
    from repro_torch.core.rag import (RagConfig, RagDatastore, knn_logits,
                                      rag_decode_logits)
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import init_model
    full = get_arch(MOE_ARCH).config
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    out = {}
    fam_log(f"config {full.name}: d_model {cfg.d_model}, {cfg.num_heads} "
            f"heads ({cfg.num_kv_heads} KV), head_dim {cfg.head_dim}, "
            f"{cfg.n_experts} experts top-{cfg.top_k}, SwiGLU d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; REDUCED to "
            f"{MOE_LAYERS} of its {full.num_layers} layers: "
            f"{full.param_count() / 1e9:.2f} B parameters whole "
            f"({2 * full.param_count() / 1e9:.1f} GB in bf16) exceed the "
            f"card's 80 GB before any datastore; {MOE_LAYERS} layers hold "
            f"{cfg.param_count() / 1e9:.2f} B "
            f"({2 * cfg.param_count() / 1e9:.1f} GB)")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    fam_log(f"init: {n_params} random parameters (seed 0) in "
            f"{time.perf_counter() - t0:.1f} s")
    fam_mem("phi3.5-moe init")
    ds0, twin = store["ds"], store["twin"]
    rng = np.random.default_rng(MOE_TOKEN_SEED)
    ds = RagDatastore(index=ds0.index, next_token=torch.as_tensor(
        rng.integers(0, cfg.vocab_size, ds0.next_token.shape[0]),
        dtype=torch.int32, device=dev))
    fam_log(f"datastore: the lm phase's {ds.index.k} partitions of "
            f"{ds.index.dim}-wide rows and its int8 twin; next tokens "
            f"redrawn over {cfg.vocab_size} (numpy seed {MOE_TOKEN_SEED})")
    prompts = next(TokenStream(vocab=cfg.vocab_size, batch=LM_REQUESTS,
                               seq=LM_PROMPT, seed=0).iter_from(0)
                   )["tokens"][:, :LM_PROMPT]

    # -- the path: served twice, then the recall checks on both tiers ------
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng, reqs, rec, tm = lm_serve(cfg, model, ds, prompts)
    toks = [r.out for r in reqs]
    del eng
    with ExpertLoad(model) as load:
        eng2, reqs2, _, _ = lm_serve(cfg, model, ds, prompts)
    same = [r.out for r in reqs2] == toks
    H = torch.cat(rec["hidden"])                       # [64, d] float32
    rcfg = RagConfig()
    spec = rcfg.spec()
    exact = executor.run(ds.index, H, QB.exact(k=rcfg.k)).to_numpy()[0]
    k1_ids = executor.run(ds.index, H, spec).to_numpy()[0]
    int8_ids = executor.run(twin, H, spec).to_numpy()[0]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["launches"] = launches
    fam_log(f"launches on the lm_moe path: {launches}")
    n_tok = sum(len(o) for o in toks)
    check(all(r.done and len(r.out) == LM_NEW for r in reqs),
          "a phi3.5-moe request did not finish with its tokens")
    check(all(0 <= t < cfg.vocab_size for o in toks for t in o),
          "a phi3.5-moe token lies outside the vocabulary")
    check(rec["finite"], "a phi3.5-moe logit row is not finite")
    check(same, "phi3.5-moe: greedy decode differs across two engines")
    check(launches["ivf_scan_topk"] > 0, "K1 was not launched on lm_moe")
    check(launches["sq_scan_topk"] > 0, "K2 was not launched on lm_moe")
    kept = {i: load.kept[i].cpu().tolist() for i in sorted(load.kept)}
    drops = {i: int(load.drops[i]) for i in sorted(load.drops)}
    sm = np.asarray(tm["step_ms"])
    out["serving"] = dict(
        requests=len(reqs), tokens=n_tok, wall_s=tm["wall_s"],
        prefill_s=tm["prefill_s"], steps=len(sm),
        step_ms_p50=float(np.percentile(sm, 50)),
        step_ms_p99=float(np.percentile(sm, 99)),
        tokens_per_s=n_tok / tm["wall_s"], tokens_equal=same,
        expert_tokens=kept, drops=drops)
    fam_log(f"served {len(reqs)} requests ({LM_SLOTS} slots, s_max "
            f"{LM_S_MAX}, RAG k=16 n_probe=8 lam=0.25): {n_tok} tokens in "
            f"{tm['wall_s']:.2f} s ({n_tok / tm['wall_s']:.2f} tokens/s), "
            f"token-by-token prefill {tm['prefill_s']:.2f} s; decode step "
            f"with RAG p50 {out['serving']['step_ms_p50']:.3f} ms p99 "
            f"{out['serving']['step_ms_p99']:.3f} ms over {len(sm)} steps; "
            f"second engine's tokens equal bit for bit {same}")
    for i in kept:
        fam_log(f"layer {i}: choices kept per expert over the second run "
                f"{kept[i]} (sum {sum(kept[i])}), dropped {drops[i]}")
    check(all(v == 0 for v in drops.values()),
          "phi3.5-moe dropped expert choices in decode")
    fam_mem("phi3.5-moe serving")

    # -- the recorded hidden states: Q.exact, recall of both tiers ----------
    out["recall_f32"] = _recall(k1_ids, exact)
    out["recall_int8"] = _recall(int8_ids, exact)
    out["witness"] = lm_witness(store["X"], H, exact, k1_ids, ds.index, rcfg)
    X = store["X"]
    g = torch.Generator(device=dev).manual_seed(2)
    pick = torch.randint(0, X.shape[0], (H.shape[0],), generator=g,
                         device=dev)
    Hs = torch.as_tensor(X, device=dev)[pick] + 0.1 * torch.randn(
        H.shape, generator=g, device=dev)
    ex_s = executor.run(ds.index, Hs, QB.exact(k=rcfg.k)).to_numpy()[0]
    for tier, index in (("f32", ds.index), ("int8", twin)):
        got = executor.run(index, Hs, spec).to_numpy()[0]
        out[f"recall_{tier}_stored"] = _recall(got, ex_s)
    fam_log(f"recall@16 at n_probe 8 against Q.exact: phi3.5-moe's "
            f"recorded hidden states f32 (K1) {out['recall_f32']:.4f}, int8 "
            f"(K2 + rerank) {out['recall_int8']:.4f}; stored rows + noise "
            f"f32 {out['recall_f32_stored']:.4f}, int8 "
            f"{out['recall_int8_stored']:.4f}")

    # -- decode times, the card's busy time, the byte bound, the MoE split --
    tok8 = torch.as_tensor(eng2.slot_tok, device=dev)
    pos = [LM_PROMPT + LM_NEW]

    def decode(with_rag):
        lg, hid, _ = eng2._decode(eng2.params, eng2.cache, tok8, pos[0])
        if with_rag:
            rag_decode_logits(ds, lg, hid, rcfg)
        pos[0] += 1
    times = {False: [], True: []}
    for _ in range(32):
        for with_rag in (False, True):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decode(with_rag)
            torch.cuda.synchronize()
            times[with_rag].append((time.perf_counter() - t1) * 1e3)
    busy = kernel_device_ms(lambda: decode(False), ("",), iters=3)
    n_ops = host_ops(lambda: decode(False))
    with RouteLog() as step_routes:
        decode(False)
    active = [int(torch.unique(r).numel()) for r in step_routes.idx]
    mean_pos = LM_PROMPT - 1 + LM_NEW / 2
    need_ms, all_ms = moe_decode_bound_ms(cfg, model, int(mean_pos), active)
    route_ms, expert_ms = moe_split_ms(model, cfg,
                                       H[:LM_SLOTS].to(torch.bfloat16))
    sv = out["serving"]
    for with_rag, key in ((False, "decode"), (True, "decode_rag")):
        sv[f"{key}_ms_p50"] = float(np.percentile(times[with_rag], 50))
        sv[f"{key}_ms_p99"] = float(np.percentile(times[with_rag], 99))
    sv.update(decode_device_ms=busy, host_ops=n_ops, active_experts=active,
              bound_ms=need_ms, all_experts_bound_ms=all_ms,
              moe_route_dispatch_combine_ms=route_ms,
              moe_expert_ms=expert_ms)
    fam_log(f"decode step in turns (32 each): without RAG p50 "
            f"{sv['decode_ms_p50']:.3f} ms p99 {sv['decode_ms_p99']:.3f} ms, "
            f"with RAG p50 {sv['decode_rag_ms_p50']:.3f} ms p99 "
            f"{sv['decode_rag_ms_p99']:.3f} ms; {n_ops} torch calls from "
            f"the host a step; the card busy {fmt_ms(busy)} of a step "
            f"without RAG (torch.profiler); byte bound {need_ms:.3f} ms "
            f"counting the experts this step's 8 tokens chose ({active} "
            f"distinct of {cfg.n_experts} a layer; up to 16 of 16 for 8 "
            f"tokens x top-2), {all_ms:.3f} ms with all {cfg.n_experts} "
            f"experts (what the [E, C] dispatch reads), at 3.35e12 B/s")
    fam_log(f"MoE device time a step ({cfg.num_layers} layers x layer 0's "
            f"work at batch {LM_SLOTS}, torch.profiler): routing + dispatch "
            f"+ combine {fmt_ms(route_ms)}, expert products "
            f"{fmt_ms(expert_ms)}")
    out["k1_step_device_ms"] = kernel_device_ms(
        lambda: knn_logits(ds, H[:LM_SLOTS], cfg.vocab_size, rcfg),
        K1_KERNELS)
    fam_log(f"K1 device time per decode step (Q={LM_SLOTS}, torch.profiler):"
            f" {fmt_ms(out['k1_step_device_ms'])}")
    del eng2
    rows = dict(zip(("ivf_scan_topk", "sq_scan_topk"),
                    lm_scan_rows(ds, twin, H[:LM_SLOTS])))
    for name, r in rows.items():
        refuse_below_bound(r, f"lm_moe {name}")
        fam_log(f"time {name} on phi3.5-moe's decode hidden states "
                f"[{r['shape']}, {r['rows_scanned']:.0f} rows scanned]: "
                f"kernel {r['ms']:.4f} ms, device {fmt_ms(r['device_ms'])}, "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        check(r["ids_equal"], f"{name} disagrees with its plain version on "
              f"phi3.5-moe's hidden states")
    del model, ds
    torch.cuda.empty_cache()
    return out, rows


def family_prompts(vocab):
    from repro_torch.data.tokens import TokenStream
    return next(TokenStream(vocab=vocab, batch=FAM_SLOTS, seq=FAM_PROMPT,
                            seed=0).iter_from(0))["tokens"][:, :FAM_PROMPT]


def state_bytes(cache, slots):
    return sum(t.numel() * t.element_size() for c in cache.values()
               for t in c.values()) / slots


def family_engine(name, cfg, model, dev):
    """recurrentgemma / xlstm: a ServeEngine of FAM_SLOTS slots, s_max
    FAM_S_MAX, over FAM_SLOTS TokenStream prompts of FAM_PROMPT tokens,
    FAM_NEW new tokens each, twice (bit for bit); recurrentgemma's
    requests FAM_ALONE also alone."""
    import numpy as np
    import torch
    prompts = family_prompts(cfg.vocab_size)
    eng, reqs, _, tm = lm_serve(cfg, model, None, prompts, slots=FAM_SLOTS,
                                s_max=FAM_S_MAX, new=FAM_NEW)
    toks = [r.out for r in reqs]
    per_slot = state_bytes(eng.cache, FAM_SLOTS)
    del eng
    eng2, reqs2, _, tm2 = lm_serve(cfg, model, None, prompts,
                                   slots=FAM_SLOTS, s_max=FAM_S_MAX,
                                   new=FAM_NEW)
    del eng2
    same = [r.out for r in reqs2] == toks
    check(all(r.done and len(r.out) == FAM_NEW for r in reqs),
          f"{name}: a request did not finish")
    check(all(0 <= t < cfg.vocab_size for o in toks for t in o),
          f"{name}: a token lies outside the vocabulary")
    check(same, f"{name}: greedy decode differs across two engines")
    sm = np.asarray(tm["step_ms"])
    n_tok = sum(len(o) for o in toks)
    out = dict(tokens=n_tok, wall_s=tm["wall_s"], prefill_s=tm["prefill_s"],
               step_ms_p50=float(np.percentile(sm, 50)),
               step_ms_p99=float(np.percentile(sm, 99)),
               tokens_per_s=n_tok / tm["wall_s"], state_bytes_per_slot=per_slot,
               tokens_equal=same, second_wall_s=tm2["wall_s"])
    line = (f"{name}: served {len(reqs)} requests ({FAM_SLOTS} slots, s_max "
            f"{FAM_S_MAX}): {n_tok} tokens in {tm['wall_s']:.2f} s "
            f"({out['tokens_per_s']:.2f} tokens/s), token-by-token prefill "
            f"{tm['prefill_s']:.2f} s, decode step p50 "
            f"{out['step_ms_p50']:.3f} ms p99 {out['step_ms_p99']:.3f} ms; "
            f"state {per_slot / 2**20:.2f} MiB a slot; second engine equal "
            f"bit for bit {same}")
    if cfg.tail_kinds:
        alone = {}
        for i in FAM_ALONE:
            e1, r1, _, _ = lm_serve(cfg, model, None, prompts[i:i + 1],
                                    slots=FAM_SLOTS, s_max=FAM_S_MAX,
                                    new=FAM_NEW)
            alone[i] = r1[0].out == toks[i]
            del e1
        out["alone_equal"] = alone
        line += (f"; tail {cfg.tail_kinds}: requests {list(alone)} served "
                 f"alone give their batched tokens {alone}")
        check(all(alone.values()), f"{name}: a request served alone "
              f"differs from the batch (slot isolation)")
    torch.cuda.synchronize()
    return out, line


def whisper_serve(cfg, model, dev):
    """whisper: configs.inputs frames [FAM_SLOTS, enc_seq, d] (normal x
    0.1 from a torch.Generator) and one token a row, prefill, then FAM_NEW
    greedy decode_steps, twice (bit for bit)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.inputs import input_specs, materialize
    from repro_torch.models import decode_step, prefill
    batch = materialize(input_specs(cfg, ShapeConfig(
        "whisper_prefill", "prefill", 1, FAM_SLOTS)), seed=0, device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, cache = prefill(cfg, model, batch, FAM_S_MAX)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        torch.cuda.empty_cache()       # the encoder's score blocks
        toks, step_ms = [], []
        for t in range(1, FAM_NEW + 1):
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, cache = decode_step(cfg, model, cache, tok, t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()), "whisper: a logit is not "
              "finite")
        runs.append((torch.cat(toks, 1).cpu(), pre_s, step_ms,
                     state_bytes(cache, FAM_SLOTS)))
        del cache
    same = torch.equal(runs[0][0], runs[1][0])
    check(same, "whisper: greedy decode differs across two runs")
    sm = np.asarray(runs[0][2])
    out = dict(prefill_s=runs[0][1], step_ms_p50=float(np.percentile(sm, 50)),
               step_ms_p99=float(np.percentile(sm, 99)),
               state_bytes_per_slot=runs[0][3], tokens_equal=same)
    return out, (f"whisper-medium: prefill of {FAM_SLOTS} x "
                 f"{cfg.enc_seq} frames + 1 token {runs[0][1]:.2f} s (second "
                 f"{runs[1][1]:.2f} s), {FAM_NEW} decode steps p50 "
                 f"{out['step_ms_p50']:.3f} ms p99 {out['step_ms_p99']:.3f} "
                 f"ms; cache {runs[0][3] / 2**20:.2f} MiB a slot (self-attention"
                 f" ring of {FAM_S_MAX} + the encoder's K/V); tokens equal "
                 f"bit for bit {same}")


def family_check(name, cfg, dev):
    """decode == forward on FAM_CHECK's float32 period at full width."""
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenStream
    layers, enc, s = FAM_CHECK[name]
    over = dict(num_layers=layers, dtype="float32")
    if enc:
        over["encoder_layers"] = enc
    if cfg.n_experts:          # the forward drops nothing (tests/test_models)
        over["capacity_factor"] = float(cfg.n_experts)
    c2 = dataclasses.replace(cfg, **over)
    tok = torch.as_tensor(next(TokenStream(
        vocab=cfg.vocab_size, batch=1, seq=s, seed=0).iter_from(0))["tokens"],
        device=dev)
    frames = None
    if enc:
        g = torch.Generator(device=dev).manual_seed(1)
        frames = 0.1 * torch.randn((1, cfg.enc_seq, cfg.d_model),
                                   generator=g, device=dev)
    return decode_matches_forward(c2, dev, tok, frames,
                                  cache_check=bool(cfg.n_experts))


def lm_families_phase(store):
    """ROADMAP Queue A 16a-ii on the card; see the module docstring.
    -> (summary, K1 / K2 rows on phi3.5-moe's decode hidden states)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    out, rows = moe_serving(store, dev)
    store.clear()
    torch.cuda.empty_cache()
    out["peak_gib_moe"] = torch.cuda.max_memory_allocated() / 2 ** 30
    fam_mem("the lm_moe path (datastore freed)")
    out["phi_check"], line = family_check(MOE_ARCH, get_arch(MOE_ARCH).config,
                                          dev)
    fam_log(f"phi3.5-moe {line}")
    for name in FAM_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_arch(name).config
        model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        n = sum(p.numel() for p in model.parameters())
        fam_log(f"{name}: {cfg.num_layers} layers {cfg.layer_kinds()[:8]}..."
                f" d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
                f"{cfg.dtype}, {n} random parameters (seed 0), full width "
                f"and depth")
        if cfg.encoder_layers:
            res, line = whisper_serve(cfg, model, dev)
        else:
            res, line = family_engine(name, cfg, model, dev)
        fam_log(line)
        del model
        torch.cuda.empty_cache()
        res["check"], cline = family_check(name, cfg, dev)
        fam_log(f"{name} {cline}")
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["seconds"] = time.perf_counter() - t0
        fam_mem(f"{name} ({res['seconds']:.1f} s)")
        out[name] = res
    out["seconds"] = time.perf_counter() - t_phase
    fam_log(f"phase lm_families: {out['seconds']:.1f} s")
    return out, rows


# ---------------------------------------------------------------------------
# the train phase: llama3-8b at full width, 8 of 32 layers, trained on the
# card (loss_fn with gradients, AdamW, the trainer, checkpoint-resume)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3-8b"
TRAIN_LAYERS = 8             # of 32: the whole model's AdamW state (96 GB)
                             # exceeds the card
TRAIN_BATCH, TRAIN_SEQ = 1, 4096   # configs/base.py's train_4k sequence;
                                   # its global batch of 256 cut to 1
TRAIN_STEPS = 6
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=6)
TRAIN_REPEAT_STEPS = 2       # (b): two runs of the first steps, bit for bit
TRAIN_FD_LAYERS, TRAIN_FD_SEQ = 1, 512   # (c): float32, full width
TRAIN_FD_EPS = 3e-3          # step along the direction (each leaf's rms
                             # scales it): large enough that the float32
                             # loss's rounding over 2 eps stays small, small
                             # enough that the eps^2 term does
TRAIN_FD_TOL = 1e-2          # |fd - autograd| <= TOL x |autograd|
TRAIN_RESUME_STEPS = 20      # (d): at llama3-8b's smoke config
BF16_FLOPS = 989e12          # H100 SXM dense bfloat16 tensor-core rate


def train_log(msg):
    log(f"train {msg}  [{CARD}]")


def leaf_digest(t, chunk=1 << 26):
    """An exact digest of a tensor's bits, formed on the device: each 16-
    or 32-bit word times a weight from its position, summed in int64
    (wrapping, so the order of the sums cannot show)."""
    import torch
    words = t.detach().reshape(-1).view(
        torch.int16 if t.element_size() == 2 else torch.int32)
    h = 0
    for c0 in range(0, words.numel(), chunk):
        w = words[c0:c0 + chunk].long()
        pos = torch.arange(c0, c0 + w.numel(), device=w.device)
        h += int((w * (pos % 1_000_003 + 1)).sum())
    return h


def state_digests(params, state):
    out = {f"p/{n}": leaf_digest(p) for n, p in params.named_parameters()}
    for field in ("mu", "nu"):
        out.update({f"{field}/{n}": leaf_digest(t)
                    for n, t in getattr(state, field).items()})
    return out


def train_flops(cfg, model, tokens, seq):
    """(model FLOPs a step: 6 x the parameters in products x tokens + the
    causal attention's products, forward and backward; the same with the
    embedding table counted too (6 N T, the common shorthand); the work
    with remat's recompute of every layer's forward)."""
    n_all = sum(p.numel() for p in model.parameters())
    n_embed = model.embed.table.numel()
    n_layers = sum(p.numel() for p in model.layers.parameters())
    # QK^T and PV, 2 T^2 H hd each, half of it under the causal mask
    attn_fwd = cfg.num_layers * 2 * tokens * seq * cfg.num_heads \
        * cfg.head_dim
    model_flops = 6 * (n_all - n_embed) * tokens + 3 * attn_fwd
    return (model_flops, 6 * n_all * tokens + 3 * attn_fwd,
            model_flops + 2 * n_layers * tokens + attn_fwd)


def train_data(cfg, dev, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    import torch
    from repro_torch.data.tokens import TokenStream
    stream = TokenStream(vocab=cfg.vocab_size, batch=batch, seq=seq, seed=0)

    def data(start):
        for b in stream.iter_from(start):
            yield {"tokens": torch.as_tensor(b["tokens"], device=dev)}
    return data


def train_step_detail(cfg, params, state, batch, tcfg):
    """One more step of the trained model, read three ways: its kernels
    and the card's busy share (torch.profiler), the torch calls it makes
    from Python (host_ops), and the AdamW update alone (CUDA events, on
    the step's own gradients)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_step
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    # device activity only: a trace with CPU ops too credits each kernel's
    # time to its CPU op as well, which counts it twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) > 0]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    kernels = sum(e.count for e in rows)
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    n_ops = host_ops(lambda: step(params, state, batch))
    # the update alone, on this step's gradients
    total, _ = transformer.loss_fn(cfg, params, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(total,
                                                list(params.parameters()))))
    del total
    upd_ms = cuda_ms(lambda: optim.update(tcfg.opt, grads, state, params),
                     iters=3)
    del grads
    return dict(wall_ms=wall_ms, busy_ms=busy_ms if busy_ms > 0 else None,
                busy_share=busy_ms / wall_ms if busy_ms > 0 else None,
                kernels=kernels, host_ops=n_ops, update_ms=upd_ms,
                top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])


def train_fd_check(cfg, dev):
    """(c): autograd's directional derivative of loss_fn along a seeded
    random direction v (each leaf's draw scaled by the leaf's rms) against
    the central difference (L(w + eps v) - L(w - eps v)) / (2 eps), on
    TRAIN_FD_LAYERS float32 layers at full width, TRAIN_FD_SEQ tokens."""
    import dataclasses
    import torch
    from repro_torch.models import init_model, transformer
    c1 = dataclasses.replace(cfg, num_layers=TRAIN_FD_LAYERS,
                             dtype="float32")
    model = init_model(c1, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    batch = next(train_data(c1, dev, seq=TRAIN_FD_SEQ)(0))
    g = torch.Generator(device=dev).manual_seed(1)
    params = list(model.parameters())
    direction = []
    for p in params:
        v = torch.randn(p.shape, generator=g, device=dev)
        direction.append(v * p.detach().square().mean().sqrt().clamp(
            min=1e-3))
    total, _ = transformer.loss_fn(c1, model, batch)
    grads = torch.autograd.grad(total, params)
    ad = float(sum((gr.double() * v.double()).sum()
                   for gr, v in zip(grads, direction)))
    del grads, total
    losses = []
    with torch.no_grad():
        for sign in (1, -2):
            for p, v in zip(params, direction):
                p.add_(v * (sign * TRAIN_FD_EPS))
            losses.append(float(transformer.loss_fn(c1, model, batch)[0]
                                .double()))
    fd = (losses[0] - losses[1]) / (2 * TRAIN_FD_EPS)
    err = abs(fd - ad)
    del model, direction
    torch.cuda.empty_cache()
    return dict(autograd=ad, central_difference=fd, abs_err=err,
                rel_err=err / abs(ad), tol=TRAIN_FD_TOL, eps=TRAIN_FD_EPS)


def train_resume_check(dev):
    """(d): llama3-8b's smoke config on the card, TRAIN_RESUME_STEPS
    straight steps against half of them, a save, a fresh Trainer and the
    rest, bit for bit; the checkpoint's bytes, its save and restore
    seconds."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models import init_model
    from repro_torch.storage import checkpoint
    from repro_torch.train import Trainer, TrainerConfig, optim
    cfg = smoke_config(get_arch(TRAIN_ARCH).config)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    data = train_data(cfg, dev, batch=2, seq=64)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=2,
                            total_steps=TRAIN_RESUME_STEPS)
    half = TRAIN_RESUME_STEPS // 2
    full = Trainer(cfg, TrainerConfig(opt=opt))
    p_full, s_full = full.fit(model, data, TRAIN_RESUME_STEPS)
    ck = WORK / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    tcfg = TrainerConfig(opt=opt, checkpoint_every=half, ckpt_dir=str(ck))
    Trainer(cfg, tcfg).fit(model, data, half)
    check(checkpoint.latest_step(str(ck)) == half,
          "train: the trainer wrote no checkpoint")
    ck_bytes = sum(f.stat().st_size for f in (ck / f"step_{half}").iterdir())
    tr = Trainer(cfg, tcfg)
    p_res, s_res = tr.fit(model, data, TRAIN_RESUME_STEPS)
    check(tr.history[0]["step"] == half, "train: the resume did not start "
          "at the checkpoint's step")
    same_loss = [h["loss"] for h in tr.history] == \
        [h["loss"] for h in full.history[half:]]
    same = state_digests(p_full, s_full) == state_digests(p_res, s_res)
    check(same_loss and same, "train: a resumed run differs from the "
          "straight run")
    # the checkpoint's own times at this size
    tree = {"params": p_res, "opt": s_res}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(str(ck), 999, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _, _ = checkpoint.restore_checkpoint(str(ck), tree, step=999)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(state_digests(back["params"], back["opt"])
          == state_digests(p_res, s_res), "train: a restore differs from "
          "what was saved")
    shutil.rmtree(ck, ignore_errors=True)
    return dict(steps=TRAIN_RESUME_STEPS, losses_equal=same_loss,
                bits_equal=same, ckpt_bytes=ck_bytes, save_s=save_s,
                restore_s=restore_s,
                params=sum(p.numel() for p in model.parameters()))


def train_phase(policies: bool = False):
    """Training on one card (ROADMAP Queue A 16b) and the sharded train
    step (16c); see the module docstring. With `policies`, also the remat
    policies side by side (--train-only). -> summary, with the kernels'
    launch counts over the main training run."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import init_model
    from repro_torch.train import Trainer, TrainerConfig, optim
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).config,
                              num_layers=TRAIN_LAYERS)
    out = {}
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, flops_6nt, flops_remat = train_flops(cfg, model, tokens,
                                                TRAIN_SEQ)
    train_log(f"config {cfg.name} at full width, {cfg.num_layers} of 32 "
              f"layers: d_model {cfg.d_model}, {cfg.num_heads} heads "
              f"({cfg.num_kv_heads} KV), d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; "
              f"{n_params} random parameters (seed 0) in "
              f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x seq "
              f"{TRAIN_SEQ} (TokenStream seed 0), AdamW {TRAIN_OPT}")
    data = train_data(cfg, dev)
    tcfg = TrainerConfig(opt=optim.AdamWConfig(**TRAIN_OPT))

    # -- (a) the main run; the kernels' launch counts over it ---------------
    ops.reset_launch_counts()
    tr = Trainer(cfg, tcfg)
    params, state = tr.fit(model, data, TRAIN_STEPS)
    out["launches"] = dict(ops.launch_counts())
    hist = tr.history
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train: a loss or grad_norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    dts = [h["dt"] * 1e3 for h in hist[1:]]
    p50 = float(np.percentile(dts, 50))
    out.update(losses=losses, grad_norms=norms, lrs=[h["lr"] for h in hist],
               first_step_ms=hist[0]["dt"] * 1e3, step_ms_p50=p50,
               step_ms_max=max(dts), tokens_per_s=tokens / (p50 / 1e3),
               model_flops=flops, flops_6nt=flops_6nt,
               flops_with_remat=flops_remat,
               flops_share=flops / (p50 / 1e3) / BF16_FLOPS,
               peak_gib_run=torch.cuda.max_memory_allocated() / 2 ** 30)
    train_log(f"{TRAIN_STEPS} steps: loss " + " ".join(f"{x:.4f}"
                                                       for x in losses)
              + "; grad_norm " + " ".join(f"{x:.4f}" for x in norms)
              + " (finite, falling)")
    train_log(f"step {p50:.1f} ms p50, {max(dts):.1f} ms max over steps "
              f"1-{TRAIN_STEPS - 1} (step 0 {out['first_step_ms']:.1f} ms); "
              f"{out['tokens_per_s']:.0f} tokens/s; model FLOPs a step "
              f"{flops / 1e12:.2f} T (6 x {n_params - model.embed.table.numel()}"
              f" parameters in products x {tokens} tokens + causal "
              f"attention; {flops_6nt / 1e12:.2f} T as 6 N T with the "
              f"embedding; {flops_remat / 1e12:.2f} T with remat's "
              f"recompute), {100 * out['flops_share']:.2f} % of the "
              f"{BF16_FLOPS / 1e12:.0f} TFLOP/s dense bfloat16 peak; peak "
              f"{out['peak_gib_run']:.2f} GiB")
    detail = train_step_detail(cfg, params, state, next(data(TRAIN_STEPS)),
                               tcfg)
    out["detail"] = detail
    share = detail["busy_share"]
    train_log(f"one more step under torch.profiler: wall "
              f"{detail['wall_ms']:.1f} ms, the card busy "
              f"{fmt_ms(detail['busy_ms'])} ("
              + ("not measured" if share is None else f"{100 * share:.1f} %")
              + f", {detail['kernels']} kernels); {detail['host_ops']} torch "
              f"calls from Python a step; the AdamW update alone "
              f"{detail['update_ms']:.2f} ms (CUDA events); top kernels: "
              + "; ".join(f"{k} {v:.2f} ms x{n}"
                          for k, v, n in detail["top"]))
    del params, state, tr
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) two runs of the first steps, bit for bit -----------------------
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, tcfg)
        p, s = tr.fit(model, data, TRAIN_REPEAT_STEPS)
        runs.append(([h["loss"] for h in tr.history], state_digests(p, s)))
        del p, s, tr
        torch.cuda.empty_cache()
    same = runs[0] == runs[1]
    out["repeat"] = dict(steps=TRAIN_REPEAT_STEPS, losses=runs[0][0],
                         bits_equal=same, leaves=len(runs[0][1]),
                         matches_main=runs[0][0] == losses[:TRAIN_REPEAT_STEPS])
    check(same, "train: two runs from seed 0 differ")
    check(out["repeat"]["matches_main"], "train: the repeated runs' losses "
          "differ from the main run's first steps")
    train_log(f"two runs of the first {TRAIN_REPEAT_STEPS} steps: losses "
              f"{runs[0][0]} == {runs[1][0]}, all {len(runs[0][1])} "
              f"parameter and moment leaves bit for bit {same} (= the main "
              f"run's first steps)")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) autograd against a central difference ---------------------------
    fd = train_fd_check(cfg, dev)
    out["fd"] = fd
    check(fd["rel_err"] <= TRAIN_FD_TOL, f"train: autograd {fd['autograd']} "
          f"differs from the central difference {fd['central_difference']}")
    train_log(f"autograd == central difference ({TRAIN_FD_LAYERS} layer, "
              f"float32, d {cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{TRAIN_FD_SEQ} tokens, eps {TRAIN_FD_EPS} along a seeded "
              f"direction): {fd['autograd']:.6e} vs "
              f"{fd['central_difference']:.6e}, relative error "
              f"{fd['rel_err']:.3e} (limit {TRAIN_FD_TOL})")

    # -- (d) checkpoint-resume at the smoke config ---------------------------
    res = train_resume_check(dev)
    out["resume"] = res
    train_log(f"resume at the smoke config ({res['params']} parameters): "
              f"{res['steps']} straight steps == {res['steps'] // 2} + save "
              f"+ a fresh Trainer + {res['steps'] // 2}: losses "
              f"{res['losses_equal']}, bits {res['bits_equal']}; checkpoint "
              f"{res['ckpt_bytes']} bytes, save {res['save_s']:.3f} s, "
              f"restore {res['restore_s']:.3f} s")
    # -- (e) the sharded train step: 4 ranks on the card ----------------------
    out["sharded"] = sharded_train_phase()
    if policies:
        out["remat_policies"] = train_remat_policies()
    out["seconds"] = time.perf_counter() - t_phase
    train_log(f"kernel launches on the train path: {out['launches']} "
              f"(none of the three lies on it); peak {out['peak_gib']:.2f} "
              f"GiB; phase train: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the sharded train step (launch.steps on DTensor): 4 ranks on one card
# ---------------------------------------------------------------------------

SHARDED_TRAIN_LAYERS = 2     # of 32: llama3-8b at full width
SHARDED_TRAIN_MESH = (2, 2)  # (data, model): FSDP, TP and SP all take part
SHARDED_TRAIN_BATCH, SHARDED_TRAIN_SEQ = 2, 1024
SHARDED_TRAIN_STEPS = 3      # step 0 warms DTensor's caches, step 1 is
                             # timed, step 2 runs under costs.StepCounter
SHARDED_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)
SHARDED_TRAIN_TOL = 1e-2     # first-step loss, relative: bf16 partial sums
                             # add in another order on 4 ranks
SHARDED_TRAIN_TIMEOUT_S = 300


def sharded_train_config():
    import dataclasses
    from repro_torch.configs import get_arch
    arch = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(arch.config, num_layers=SHARDED_TRAIN_LAYERS)
    return dataclasses.replace(arch, config=cfg), cfg


def sharded_train_rank(rank, world, rdv, out_dir):
    """One rank of the sharded train phase (spawned): llama3-8b's model
    drawn from seed 0 on the card, placed by launch.steps under the rule
    placements on a (data 2, model 2) mesh over gloo, then
    SHARDED_TRAIN_STEPS steps on the TokenStream batches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import topk
    from repro_torch.kernels import ops
    from repro_torch.launch import costs, steps
    from repro_torch.models import init_model, sharding
    from repro_torch.train import optim
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=rdv, world_size=world,
                            rank=rank)
    mesh = init_device_mesh("cuda", SHARDED_TRAIN_MESH,
                            mesh_dim_names=("data", "model"))
    arch, cfg = sharded_train_config()
    res = dict(rank=rank, ready_at=time.time())
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    shape = ShapeConfig("sharded", "train", SHARDED_TRAIN_SEQ,
                        SHARDED_TRAIN_BATCH)
    lw = steps.train_lowerable(arch, shape, mesh,
                               opt_cfg=optim.AdamWConfig(**SHARDED_TRAIN_OPT))
    data = train_data(cfg, dev, batch=SHARDED_TRAIN_BATCH,
                      seq=SHARDED_TRAIN_SEQ)(0)
    # the parameters first, then their moments beside each shard: a full
    # float32 state per rank would crowd the shared card
    params = steps.place(model, lw.in_shardings[0], mesh)
    low = steps.lower(lw, mesh, (params, optim.init(params), next(data)))
    del model, params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sharding.reset_replicated_calls()
    topk.reset_host_staging()
    losses, step_ms = [], []
    params, state, batch = low.args
    for i in range(SHARDED_TRAIN_STEPS):
        if i:
            batch = steps.place(next(data), lw.in_shardings[2], mesh)
        torch.cuda.synchronize()
        dist.barrier()
        if i == SHARDED_TRAIN_STEPS - 1:
            staged0 = topk.host_staging()
            with costs.StepCounter() as counter:
                counter.hold((params, state, batch))
                params, state, m = low(params, state, batch)
            res["counted"] = dict(
                flops=counter.flops, bytes_accessed=counter.bytes_accessed,
                coll_bytes=counter.coll_bytes, coll_calls=counter.coll_calls,
                peak_live_bytes=counter.peak_bytes)
        else:
            staged0 = topk.host_staging()
            t0 = time.perf_counter()
            params, state, m = low(params, state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        staged = topk.host_staging()
        res[f"staged_step{i}"] = {k: staged[k] - staged0[k] for k in staged}
        losses.append(float(m["loss"]))
    res.update(losses=losses, step_ms=step_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=dict(ops.launch_counts()),
               replicated=sharding.replicated_calls(),
               staged=topk.host_staging(),
               params_local=sum(p.to_local().numel()
                                for p in params.parameters()),
               placements={n: [str(x) for x in p.placements]
                           for n, p in list(params.named_parameters())[:4]})
    with open(out_dir / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def sharded_train_phase():
    """The sharded train step (launch.steps) on the card: llama3-8b at its
    published widths cut to SHARDED_TRAIN_LAYERS layers, first one rank
    over the whole model (trainer.make_train_step) for SHARDED_TRAIN_STEPS
    steps, freed, then 4 ranks spawned on the same card on a (data 2,
    model 2) mesh over gloo with the same weights and batches. The ranks'
    losses equal each other; the first step's loss agrees with the single
    rank's within SHARDED_TRAIN_TOL relative. All-gathers cross through
    host memory (gloo cannot take CUDA tensors there), counted. The times
    are of 4 ranks sharing one card, not of a 4-card deployment."""
    import gc
    import torch
    import torch.multiprocessing as mp
    from repro_torch.models import init_model
    from repro_torch.train import TrainerConfig, optim
    from repro_torch.train.trainer import make_train_step
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arch, cfg = sharded_train_config()
    out = {}
    # -- one rank over the whole model ----------------------------------------
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    state = optim.init(model)
    step = make_train_step(cfg, TrainerConfig(
        opt=optim.AdamWConfig(**SHARDED_TRAIN_OPT)))
    data = train_data(cfg, dev, batch=SHARDED_TRAIN_BATCH,
                      seq=SHARDED_TRAIN_SEQ)(0)
    single, single_ms = [], []
    for _ in range(SHARDED_TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        single.append(float(m["loss"]))
        single_ms.append((time.perf_counter() - t0) * 1e3)
    out["single"] = dict(losses=single, step_ms=single_ms,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, state, step, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    # -- 4 ranks on the card ---------------------------------------------------
    out_dir = WORK / "sharded_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = SHARDED_TRAIN_MESH[0] * SHARDED_TRAIN_MESH[1]
    t0 = time.time()
    pc = mp.start_processes(
        sharded_train_rank, args=(world, f"file://{out_dir}/rdv", out_dir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARDED_TRAIN_TIMEOUT_S
    try:
        while not pc.join(timeout=5):
            check(time.monotonic() < deadline, "the sharded train ranks did "
                  f"not finish within {SHARDED_TRAIN_TIMEOUT_S} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    ready_s = max(r["ready_at"] for r in ranks) - t0
    losses = ranks[0]["losses"]
    check(all(r["losses"] == losses for r in ranks), "sharded train: the "
          f"ranks' losses differ: {[r['losses'] for r in ranks]}")
    rel = abs(losses[0] - single[0]) / abs(single[0])
    check(rel <= SHARDED_TRAIN_TOL, f"sharded train: first-step loss "
          f"{losses[0]} vs one rank's {single[0]} (relative {rel:.3e} > "
          f"{SHARDED_TRAIN_TOL})")
    out.update(ranks=world, mesh=SHARDED_TRAIN_MESH, ready_s=ready_s,
               losses=losses, first_rel=rel,
               step_ms=ranks[0]["step_ms"],
               peak_gib=[r["peak_gib"] for r in ranks],
               staged=[r["staged"] for r in ranks],
               staged_step1=ranks[0]["staged_step1"],
               replicated=ranks[0]["replicated"],
               counted=ranks[0]["counted"],
               params_local=[r["params_local"] for r in ranks])
    out["launches"] = {k: sum(r["launches"][k] for r in ranks)
                       for k in ranks[0]["launches"]}
    c = out["counted"]
    train_log(f"sharded: llama3-8b at full width, {SHARDED_TRAIN_LAYERS} of "
              f"32 layers ({n_params} parameters), batch "
              f"{SHARDED_TRAIN_BATCH} x {SHARDED_TRAIN_SEQ} (TokenStream "
              f"seed 0), AdamW {SHARDED_TRAIN_OPT}; {world} ranks on this "
              f"one card, a (data {SHARDED_TRAIN_MESH[0]}, model "
              f"{SHARDED_TRAIN_MESH[1]}) mesh over gloo, ready in "
              f"{ready_s:.1f} s (times are of 4 ranks sharing one card, not "
              f"of a 4-card deployment)")
    train_log("sharded: losses step by step (4 ranks | one rank): " + "; ".join(
        f"{a:.6f} | {b:.6f}" for a, b in zip(losses, single))
        + f"; first step relative {rel:.3e} (limit {SHARDED_TRAIN_TOL})")
    train_log(f"sharded: step ms {[round(x, 1) for x in out['step_ms']]} "
              f"(step 0 warms DTensor's caches) vs one rank "
              f"{[round(x, 1) for x in single_ms]}; peak GiB per rank "
              f"{[round(x, 2) for x in out['peak_gib']]} vs one rank "
              f"{out['single']['peak_gib']:.2f}; local parameters per rank "
              f"{out['params_local']}")
    train_log(f"sharded: collectives of one step (rank 0, counted): calls "
              f"{c['coll_calls']}, bytes {c['coll_bytes']}; host-staged "
              f"all-gathers in the timed step {out['staged_step1']}, in all "
              f"{out['staged'][0]}; ops run replicated {out['replicated']}; "
              f"traced FLOPs {c['flops'] / 1e12:.3f} T, live-bytes peak "
              f"{c['peak_live_bytes'] / 2 ** 30:.2f} GiB (allocator peak "
              f"{out['peak_gib'][0]:.2f} GiB)")
    out["seconds"] = time.perf_counter() - t_phase
    train_log(f"kernel launches on the sharded train path (4 ranks): "
              f"{out['launches']} (none of the three lies on it); phase "
              f"sharded train: {out['seconds']:.1f} s")
    return out


def train_remat_policies():
    """REPRO_REMAT_POLICY "nothing" beside "dots" on the train cell
    (llama3-8b at full width, TRAIN_LAYERS layers, 1 x 4,096 tokens):
    3 AdamW steps each from seed 0, step ms and peak memory; the losses
    must be equal."""
    import dataclasses
    import gc
    import os
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_model
    from repro_torch.train import Trainer, TrainerConfig, optim
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).config,
                              num_layers=TRAIN_LAYERS)
    tcfg = TrainerConfig(opt=optim.AdamWConfig(**TRAIN_OPT))
    out = {}
    prev = os.environ.get("REPRO_REMAT_POLICY")
    try:
        for policy in ("nothing", "dots"):
            os.environ["REPRO_REMAT_POLICY"] = policy
            model = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, tcfg)
            p, s = tr.fit(model, train_data(cfg, dev), 3)
            out[policy] = dict(
                losses=[h["loss"] for h in tr.history],
                step_ms=[h["dt"] * 1e3 for h in tr.history],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, p, s, tr
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT_POLICY", None)
        else:
            os.environ["REPRO_REMAT_POLICY"] = prev
    check(out["dots"]["losses"] == out["nothing"]["losses"], "train: the "
          f"dots policy's losses {out['dots']['losses']} differ from "
          f"nothing's {out['nothing']['losses']}")
    for policy, v in out.items():
        train_log(f"remat {policy}: losses {v['losses']}, step ms "
                  f"{[round(x, 1) for x in v['step_ms']]}, peak "
                  f"{v['peak_gib']:.2f} GiB")
    return out


def train_only():
    """Phases 1-2 done: the train phase alone, then its kernels line (the
    three kernels at no launch on this path, their rows not timed)."""
    out = train_phase(policies=True)
    print(json.dumps({"train": {k: v for k, v in out.items()
                                if k != "launches"},
                      "launches_by_path": {
                          "train": out["launches"],
                          "sharded_train": out["sharded"]["launches"]}},
                     default=str), flush=True)


def lm_only():
    """Phases 1-2 done: the lm and lm_families phases alone, then their
    kernels line."""
    import torch
    with torch.no_grad():
        out, rows, store = lm_phase()
        fam, fam_rows = lm_families_phase(store)
    res = {k: dict(r, rag=dict(r)) for k, r in rows.items()}
    for k, r in fam_rows.items():
        res[k]["rag_moe"] = r
    by_path = {"lm": out["launches"], "lm_moe": fam["launches"]}
    print(json.dumps({"kernels": kernels_line(res, out["launches"],
                                              by_path)}), flush=True)


def kernels_line(res, launches, by_path=None):
    kernels = []
    for kname, r in res.items():
        refuse_below_bound(r, kname)
        extra = {k: r[k] for k in ("device_ms", "exact", "prefilter",
                                   "paged", "program", "paged_program",
                                   "sharded", "rag", "rag_moe")
                 if k in r}
        if by_path is not None:
            extra["launches_by_path"] = {p: c[kname]
                                         for p, c in by_path.items()}
        kernels.append(dict(
            name=kname, **KERNEL_META[kname], launches=launches[kname],
            max_abs_err=r["max_abs_err"], ids_equal=r["ids_equal"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"], **extra))
    return kernels


def batch_times(idx, q, reps=30):
    """A Q=32 int8 ANN batch (k=100, n_probe=8) through executor.run on
    the in-memory index: unfiltered, post-filter `attr0 == 3` on the
    program route, and the same on the mask route, in turns `reps` times
    each (host clock, after a synchronize), as quartiles."""
    import torch
    from repro_torch.core import executor
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import Q
    base = Q.knn(k=100, n_probe=8)
    post = base.where(Pred(0, "==", 3)).postfilter()
    specs = {"unfiltered": base, "program route": post,
             "mask route": mask_route(post)}

    def once(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        executor.run(idx, q, spec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    for spec in specs.values():
        for _ in range(5):
            once(spec)
    times = {k: [] for k in specs}
    for _ in range(reps):
        for k, spec in specs.items():
            times[k].append(once(spec))
    for k, v in times.items():
        log(f"  time batch Q={q.shape[0]} {k}: {fmt_q(quartiles(v))}")


def kernels_only():
    """Phase 4 alone, on the main path's data and index configuration
    built in memory (no SQLite store): quick kernel times at the main
    path's shapes, for any tree's src/ (--src); then batch_times."""
    import numpy as np
    from repro_torch.core import ivf
    from repro_torch.core.types import IVFConfig
    from repro_torch.data import synthetic
    t0 = time.perf_counter()
    ds = synthetic.make("sift", scale=1.0, with_gt=False, seed=0)
    n, d = ds.X.shape
    rng = np.random.default_rng(0)
    attrs = np.stack([rng.integers(0, 10, n).astype(np.float32),
                      rng.random(n).astype(np.float32)], axis=1)
    idx = ivf.build_index(ds.X, np.arange(n, dtype=np.int32), attrs,
                          cfg=IVFConfig(dim=d, quantize="int8",
                                        rerank_factor=4))
    log(f"phase index: {time.perf_counter() - t0:.1f} s  k={idx.k} "
        f"p_max={idx.p_max}")
    res = timed_kernels(idx, ds.Q)
    batch_times(idx, ds.Q[:32])
    print(json.dumps({"kernels": kernels_line(
        res, {k: None for k in res})}), flush=True)


def run(args):
    global CARD
    name, count, card = device_info()
    CARD = card
    t_all = time.perf_counter()
    build_kernels()
    if args.quick:
        quick()
        return
    if args.kernels_only:
        kernels_only()
        return
    if args.lm_only:
        lm_only()
        return
    if args.train_only:
        train_only()
        return
    t0 = time.perf_counter()
    ctx, out = main_path()
    log(f"phase main: {time.perf_counter() - t0:.1f} s")
    out["paged"], pools = paged_phase(ctx)
    ctx["eng2"].close()
    out["paged_build"], pb = paged_build_phase(ctx)
    out["rebuild"] = rebuild_phase(ctx, pb)
    out["fleet"] = fleet_phase()
    eng, queries = ctx["eng"], ctx["queries"]
    t0 = time.perf_counter()
    profile_queries(eng, queries)
    profile_paged(pools, queries)
    log(f"phase profile: {time.perf_counter() - t0:.1f} s")
    res = timed_kernels(eng.index, queries)
    check_path_routes(res, ctx, pools)
    for pag in pools.values():
        pag.close()
    eng.close()
    shutil.rmtree(WORK, ignore_errors=True)
    # the lm phase last, on a card freed of the 1M engine and the fleet
    import gc
    import torch
    del ctx, pools, eng, queries
    gc.collect()
    torch.cuda.empty_cache()
    # the serving phases build no autograd graph (the parameters are
    # trainable); the train phase last, on a card freed of them
    with torch.no_grad():
        out["lm"], lm_rows, store = lm_phase()
        out["lm_families"], fam_rows = lm_families_phase(store)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = train_phase()
    for key, rows in (("rag", lm_rows), ("rag_moe", fam_rows)):
        for kname, row in rows.items():
            res[kname][key] = row
            res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"],
                                            row["max_abs_err"])
            res[kname]["ids_equal"] = res[kname]["ids_equal"] \
                and row["ids_equal"]
    res["ivf_scan_topk"]["sharded"] = out["sharded"]["k1_row"]
    by_path = {"main": out["launches"],
               "hybrid": out["hybrid"]["launches"],
               "serving": out["serving"]["launches"],
               "maintenance": out["maintenance"]["launches"],
               "paged": out["paged"]["launches"],
               "paged_serving": out["paged"]["serving"]["launches"],
               "paged_build": out["paged_build"]["launches"],
               "paged_rebuild": out["rebuild"]["paged"]["launches"],
               "resident_rebuild": out["rebuild"]["resident"]["launches"],
               "sharded": out["sharded"]["launches"],
               "fleet": out["fleet"]["launches"],
               "lm": out["lm"]["launches"],
               "lm_moe": out["lm_families"]["launches"],
               "train": out["train"]["launches"],
               "sharded_train": out["train"]["sharded"]["launches"]}
    kernels = kernels_line(res, out["launches"], by_path)
    log(json.dumps({"main": {k: v for k, v in out.items()
                             if k != "launches"}}))
    log(f"phase total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check each kernel once, then stop")
    ap.add_argument("--kernels-only", action="store_true",
                    help="check and time the kernels on an index built in "
                         "memory (no SQLite), print the kernels line, stop")
    ap.add_argument("--lm-only", action="store_true",
                    help="build, then the lm and lm_families phases alone "
                         "(llama3-8b and phi3.5-moe with MicroNN "
                         "retrieval, the recurrent, xLSTM and whisper "
                         "families), print their kernels line, stop")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then the train phase alone (llama3-8b at "
                         "full width, 8 of 32 layers, trained on the card; "
                         "autograd against a central difference; resume; "
                         "the sharded train step on 4 ranks; the remat "
                         "policies side by side), print its summary, stop")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch is driven "
                         "(another tree's, to compare two versions in one "
                         "run)")
    args = ap.parse_args()
    if not (args.src / "repro_torch" / "__init__.py").exists():
        print(f"FAIL: {args.src}/repro_torch not found", flush=True)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    try:
        run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
