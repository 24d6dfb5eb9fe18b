// Fused int8 scalar-quantized IVF scan + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sq_scan.py::sq_scan_topk
// (body _sq_scan_kernel).
//
// What it computes: the candidate stage of the quantized search. Queries
// arrive folded into the stacked two-term int8 form (quantize.fold_queries,
// run by the Python wrapper): q_i8 = [q1; q2] [2Q, d], alpha = [a1; a2]
// [2Q], beta [Q]. For each selected (query, probed partition) pair and
// each row code c, the integer products acc1 = q1.c, acc2 = q2.c are exact
// int32 sums; the epilogue, in float32 in the reference's order, is
//   dots  = (a1 * acc1 + a2 * acc2) + beta
//   score = v2 - 2 * dots (l2)  |  -dots (ip / cosine)
// with v2 from the precomputed code norms or, without them, from the
// decode-and-reduce sum of ((c + 128) * scale + lo)^2. Rows are masked by
// `valid` and by the post-filter: the attribute predicate program
// evaluated on the row's `attrs` inside the scan (pred_program.cuh; the
// Pallas kernel's fused attr_filter), or a precomputed `keep` mask for an
// opaque filter callable; the output is the
// ascending top-k_out by (score, position), carrying flat row ids
// p * p_max + slot (or `ids` when given), with (MASKED, -1) in the tail.
//
// What bounds it on the H100: bytes, and the top-k selection. The code
// tier is d bytes a row, 4x fewer than float32; each pair does
// 4 * rows * d integer operations over rows * d bytes, far below the int8
// rate's balance point. The least time is the selected partitions' valid
// codes and norms read once (0.014 ms at 512 queries x 8 probes over 1M
// rows), so what a kernel spends beyond that is finding work and sorting.
//
// Why no tensor cores: at 512 queries a selected partition is probed by
// ~1.4 queries on average (4,096 pairs over 2,923 partitions), so an int8
// MMA tile over 16 or more queries would be more than 90% padding. The
// work per row is one 128-byte read and 64 __dp4a; what matters is reading
// only the rows that hold work and sorting only the keys that can win.
//
// The design, against each cost of a plain (query, chunk) walk:
// - Finding the selected pairs: a tiny first kernel (scan_pair_list)
//   compacts each query's row of `qsel` into a list of its selected probe
//   positions, and pass 1's block (chunk c, query q) takes an equal share
//   of that list -- blocks own selected pairs, not ranges of the union.
//   Without `qsel` (exact search) every position is a pair.
// - Reading rows: a block walks its pairs' 32-slot groups, eight groups
//   per warp per round. The warp ballots the valid (and keep) bytes of
//   all eight, loaded one round ahead (with a predicate program, each
//   lane then evaluates it on its eight valid rows' attributes in
//   lockstep), and skips a group with none. In a
//   group, four teams of 8 lanes take 8 slots each; a lane issues the
//   16-byte loads of all its team's valid rows at once (coalesced
//   128-byte rows at d = 128), then __dp4a into exact int32
//   sums, reduced over the team by shuffles. So a group costs about one
//   memory latency, not one per row. Valid rows need not form a prefix.
//   A width that is not a multiple of 16 (or unaligned codes) reads
//   bytes instead, with the same sums.
// - Filtering before sorting: a row whose key is at or above the block's
//   running k-th key is dropped at once. Survivors are appended to a
//   shared candidate buffer by a warp-aggregated atomic; only when the
//   buffer could overflow, and at the end, the block sorts it at the next
//   power of two of its count (in one warp's registers for 32 or fewer)
//   and merges it into the running top-k by rank. So a pair no longer pays
//   a 1,024-key sort for ~120 rows.
// - Pass 2 (topk_merge_pass2) merges each query's per-chunk lists.
// No 32-row Q padding: the TPU's int8 tile minimum does not exist here.

#include <type_traits>

#include "pred_program.cuh"
#include "topk_common.cuh"

namespace {

constexpr int GROUP = 32;           // slots a warp examines per item
constexpr int ITEMS_PER_WARP = 8;   // items per warp between flush checks
// the most keys one round of items can add
constexpr int ROUND_MAX = NWARPS * ITEMS_PER_WARP * GROUP;
constexpr int CAP = 4096;           // candidate buffer (power of two)
constexpr int PAIR_BATCH = 64;      // pairs staged in shared memory at once
constexpr int ROWS = GROUP / 4;     // rows of a group per 8-lane team

// Slot rsel + 4 h of a group is a row to scan (bit set in the ballot m).
__device__ __forceinline__ bool row_in(unsigned m, int rsel, int h) {
  return (m >> (rsel + 4 * h)) & 1u;
}

// ((c + 128) * scale + lo)^2 added to v2 in the reference's float32 order.
__device__ __forceinline__ float fmaf_decode(int c, float sc, float lo,
                                             float v2) {
  const float v = __fadd_rn(__fmul_rn(__fadd_rn((float)c, 128.f), sc), lo);
  return fmaf(v, v, v2);
}

// One packed word (4 codes at depths e .. e + 3) into both exact int32
// sums, and into the decode norm's partial sum when decoding.
__device__ __forceinline__ void dot_word(int cw, int xw, int yw, int e,
                                         bool decode, const float* los,
                                         const float* scs, int& acc1,
                                         int& acc2, float& v2) {
  acc1 = __dp4a(xw, cw, acc1);
  acc2 = __dp4a(yw, cw, acc2);
  if (decode) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      v2 = fmaf_decode((int)(int8_t)(cw >> (8 * h)), scs[e + h], los[e + h],
                       v2);
  }
}

template <bool HAS_PROG>
__global__ void __launch_bounds__(THREADS, 2)
sq_scan_pass1(const int8_t* __restrict__ q_i8,
              const float* __restrict__ alpha,
              const float* __restrict__ beta,
              const float* __restrict__ lo,
              const float* __restrict__ scale,
              const int8_t* __restrict__ codes,
              const float* __restrict__ norms,
              const int8_t* __restrict__ valid,
              const int8_t* __restrict__ keep,
              const PredArg<HAS_PROG> pred,
              const int32_t* __restrict__ part_ids,
              const int32_t* __restrict__ pairs,     // null: all positions
              const int32_t* __restrict__ pair_cnt,
              int n_q, int d, int p_max, int n, int n_chunks, int k_out,
              int metric_l2, int vec16,   // 1: int4 loads, 0: bytes
              uint64_t* __restrict__ part_keys,
              int32_t* __restrict__ part_cnt) {
  extern __shared__ __align__(16) uint64_t smem1[];
  const int dq = (d + 15) & ~15;
  uint64_t* run = smem1;
  uint64_t* tmp = run + k_out;
  uint64_t* cand = tmp + k_out;
  int* pj = reinterpret_cast<int*>(cand + CAP);      // probe positions
  int* pp = pj + PAIR_BATCH;                         // their partitions
  int8_t* q1 = reinterpret_cast<int8_t*>(pp + PAIR_BATCH);
  int8_t* q2 = q1 + dq;
  float* los = reinterpret_cast<float*>(q2 + dq);
  float* scs = los + d;
  int* cnt_s = reinterpret_cast<int*>(scs + d);

  const int c = blockIdx.x, q = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane & 7, rsel = lane >> 3;   // 8 lanes per row
  for (int t = threadIdx.x; t < dq; t += THREADS) {
    q1[t] = t < d ? q_i8[(size_t)q * d + t] : 0;
    q2[t] = t < d ? q_i8[(size_t)(n_q + q) * d + t] : 0;
  }
  const bool decode = metric_l2 && norms == nullptr;
  if (decode) {
    for (int t = threadIdx.x; t < d; t += THREADS) {
      los[t] = lo[t];
      scs[t] = scale[t];
    }
  }
  if (threadIdx.x == 0) *cnt_s = 0;
  const float a1 = alpha[q], a2 = alpha[n_q + q], b = beta[q];
  const int cnt = pairs ? pair_cnt[q] : n;
  const int per = (cnt + n_chunks - 1) / n_chunks;
  const int a_begin = min(cnt, c * per), a_end = min(cnt, a_begin + per);
  const int groups = (p_max + GROUP - 1) / GROUP;

  int r = 0;
  uint64_t thresh = EMPTY_KEY;   // keys at or above it cannot enter
  for (int b0 = a_begin; b0 < a_end; b0 += PAIR_BATCH) {
    const int nb = min(PAIR_BATCH, a_end - b0);
    __syncthreads();             // the previous batch is fully read
    for (int t = threadIdx.x; t < nb; t += THREADS) {
      const int j = pairs ? pairs[(size_t)q * n + b0 + t] : b0 + t;
      pj[t] = j;
      pp[t] = part_ids[j];
    }
    __syncthreads();
    const int items = nb * groups;
    // A lane's valid and keep bytes of this warp's items in a round: the
    // next round's are loaded before this round's rows are scanned, so
    // their latency hides behind the scan.
    int8_t vb[ITEMS_PER_WARP], kb[ITEMS_PER_WARP];
    auto fetch = [&](int it0) {
      size_t at[ITEMS_PER_WARP];
#pragma unroll
      for (int u = 0; u < ITEMS_PER_WARP; ++u) {
        const int item = it0 + u * NWARPS + w;
        const int my = (item % groups) * GROUP + lane;
        vb[u] = 0;
        kb[u] = 1;
        at[u] = 0;
        if (item < items && my < p_max) {
          at[u] = (size_t)pp[item / groups] * p_max + my;
          vb[u] = valid[at[u]];
          if (keep != nullptr) kb[u] = keep[at[u]];
        }
      }
      if constexpr (HAS_PROG) {
        size_t row[ITEMS_PER_WARP];
        bool ok[ITEMS_PER_WARP];
#pragma unroll
        for (int u = 0; u < ITEMS_PER_WARP; ++u) {
          ok[u] = vb[u] != 0 && kb[u] != 0;
          row[u] = at[u] * pred.n_attr;
        }
        eval_program_rows<ITEMS_PER_WARP>(pred.prog, pred.attrs, row, ok);
#pragma unroll
        for (int u = 0; u < ITEMS_PER_WARP; ++u) kb[u] = ok[u];
      }
    };
    fetch(0);
    for (int it0 = 0; it0 < items; it0 += NWARPS * ITEMS_PER_WARP) {
      const int held = *cnt_s;   // read after a barrier: uniform
      if (held + ROUND_MAX > CAP) {
        r = flush_candidates(run, tmp, r, cand, held, k_out);
        if (threadIdx.x == 0) *cnt_s = 0;
        if (r == k_out) thresh = run[k_out - 1];
        __syncthreads();
      }
      // this round's ballots; then each non-empty group's rows, all their
      // loads at once
      unsigned mk[ITEMS_PER_WARP];
#pragma unroll
      for (int u = 0; u < ITEMS_PER_WARP; ++u)
        mk[u] = __ballot_sync(FULL, vb[u] != 0 && kb[u] != 0);
      fetch(it0 + NWARPS * ITEMS_PER_WARP);
      for (int u = 0; u < ITEMS_PER_WARP; ++u) {
        const unsigned m = mk[u];
        if (m == 0) continue;                    // warp-uniform
        const int item = it0 + u * NWARPS + w;
        const int slot0 = (item % groups) * GROUP;
        const int j = pj[item / groups];
        const size_t rowbase = (size_t)pp[item / groups] * p_max + slot0;
        // lanes 8 rsel .. 8 rsel + 7 take slots rsel + 4 h, h < 8
        int acc1[ROWS], acc2[ROWS];
        float v2[ROWS];
#pragma unroll
        for (int h = 0; h < ROWS; ++h) {
          acc1[h] = 0;
          acc2[h] = 0;
          v2[h] = 0.f;
          if (metric_l2 && !decode && sub == 0 && row_in(m, rsel, h))
            v2[h] = norms[rowbase + rsel + 4 * h];
        }
        if (vec16) {
          for (int sg = sub; sg < (d >> 4); sg += 8) {
            int4 cw[ROWS];
#pragma unroll
            for (int h = 0; h < ROWS; ++h)
              cw[h] = row_in(m, rsel, h)
                          ? __ldg(reinterpret_cast<const int4*>(
                                codes + (rowbase + rsel + 4 * h) * d) + sg)
                          : make_int4(0, 0, 0, 0);
            const int4 xw = reinterpret_cast<const int4*>(q1)[sg];
            const int4 yw = reinterpret_cast<const int4*>(q2)[sg];
#pragma unroll
            for (int h = 0; h < ROWS; ++h) {
              dot_word(cw[h].x, xw.x, yw.x, 16 * sg, decode, los, scs,
                       acc1[h], acc2[h], v2[h]);
              dot_word(cw[h].y, xw.y, yw.y, 16 * sg + 4, decode, los, scs,
                       acc1[h], acc2[h], v2[h]);
              dot_word(cw[h].z, xw.z, yw.z, 16 * sg + 8, decode, los, scs,
                       acc1[h], acc2[h], v2[h]);
              dot_word(cw[h].w, xw.w, yw.w, 16 * sg + 12, decode, los, scs,
                       acc1[h], acc2[h], v2[h]);
            }
          }
        } else {
          for (int e = sub; e < d; e += 8) {
#pragma unroll
            for (int h = 0; h < ROWS; ++h) {
              if (!row_in(m, rsel, h)) continue;
              const int cv = codes[(rowbase + rsel + 4 * h) * d + e];
              acc1[h] += (int)q1[e] * cv;
              acc2[h] += (int)q2[e] * cv;
              if (decode) v2[h] = fmaf_decode(cv, scs[e], los[e], v2[h]);
            }
          }
        }
        // exact integer sums over each row's 8 lanes; the decode norm's
        // partial sums in a fixed tree order
#pragma unroll
        for (int h = 0; h < ROWS; ++h) {
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) {
            acc1[h] += __shfl_xor_sync(FULL, acc1[h], off);
            acc2[h] += __shfl_xor_sync(FULL, acc2[h], off);
            if (decode) v2[h] += __shfl_xor_sync(FULL, v2[h], off);
          }
        }
        uint64_t key[ROWS];
        unsigned wb[ROWS];
        int total = 0;
#pragma unroll
        for (int h = 0; h < ROWS; ++h) {
          key[h] = EMPTY_KEY;
          if (sub == 0 && row_in(m, rsel, h)) {
            const float t1 = __fmul_rn(a1, (float)acc1[h]);
            const float t2 = __fmul_rn(a2, (float)acc2[h]);
            const float dots = __fadd_rn(__fadd_rn(t1, t2), b);
            const float s = metric_l2 ? __fsub_rn(v2[h], __fmul_rn(2.f, dots))
                                      : -dots;
            const int slot = slot0 + rsel + 4 * h;
            key[h] = make_key(s, (uint32_t)((size_t)j * p_max + slot));
          }
          wb[h] = __ballot_sync(FULL, key[h] < thresh);
          total += __popc(wb[h]);
        }
        int at = 0;                    // one atomic per group
        if (lane == 0 && total) at = atomicAdd(cnt_s, total);
        at = __shfl_sync(FULL, at, 0);
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int h = 0; h < ROWS; ++h) {
          if (key[h] < thresh) cand[at + __popc(wb[h] & below)] = key[h];
          at += __popc(wb[h]);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();               // cnt_s is final (also with no pairs)
  const int held = *cnt_s;
  if (held > 0) r = flush_candidates(run, tmp, r, cand, held, k_out);
  const size_t base = ((size_t)q * n_chunks + c) * (size_t)k_out;
  for (int t = threadIdx.x; t < r; t += THREADS) part_keys[base + t] = run[t];
  if (threadIdx.x == 0) part_cnt[(size_t)q * n_chunks + c] = r;
}

// Dynamic shared memory of pass 1.
size_t pass1_smem(int k_out, int d) {
  const int dq = (d + 15) & ~15;
  return (size_t)(2 * k_out + CAP) * sizeof(uint64_t) +
         (size_t)2 * PAIR_BATCH * sizeof(int) + (size_t)2 * dq +
         (size_t)2 * d * sizeof(float) + sizeof(int);
}

}  // namespace

// Launches the pair list (when qsel is given) and both passes on `stream`;
// the caller allocates scratch and outputs. `norms`, `keep`, `ids` and
// `qsel` may be null; `pairs` [n_q, n] and `pair_cnt` [n_q] are needed
// with qsel. `program` is a host PredProgram (null: none), copied into the
// launch arguments; with one, `attrs` [F, p_max, n_attr] is read.
// Returns cudaGetLastError().
extern "C" int sq_scan_launch(const void* q_i8, const void* alpha,
                              const void* beta, const void* lo,
                              const void* scale, const void* codes,
                              const void* norms, const void* valid,
                              const void* keep, const void* attrs,
                              const void* program, const void* ids,
                              const void* part_ids, const void* qsel,
                              int n_q, int d, int p_max, int n, int n_chunks,
                              int k_out, int metric_l2, int n_attr,
                              void* pairs,
                              void* pair_cnt, void* part_keys,
                              void* part_cnt, void* out_s, void* out_i,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qsel != nullptr) {
    scan_pair_list<<<n_q, THREADS, 0, st>>>(
        static_cast<const int8_t*>(qsel), n, static_cast<int32_t*>(pairs),
        static_cast<int32_t*>(pair_cnt));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes);
  const int vec16 = d % 16 == 0 && cp % 16 == 0;
  const size_t smem1 = pass1_smem(k_out, d);
  dim3 grid1(n_chunks, n_q);
  auto pass1 = [&](auto pred) {
    constexpr bool P = std::is_same_v<decltype(pred), PredArg<true>>;
    cudaError_t e = allow_smem(sq_scan_pass1<P>, smem1);
    if (e != cudaSuccess) return e;
    sq_scan_pass1<P><<<grid1, THREADS, smem1, st>>>(
        static_cast<const int8_t*>(q_i8), static_cast<const float*>(alpha),
        static_cast<const float*>(beta), static_cast<const float*>(lo),
        static_cast<const float*>(scale), static_cast<const int8_t*>(codes),
        static_cast<const float*>(norms), static_cast<const int8_t*>(valid),
        static_cast<const int8_t*>(keep), pred,
        static_cast<const int32_t*>(part_ids),
        qsel ? static_cast<const int32_t*>(pairs) : nullptr,
        static_cast<const int32_t*>(pair_cnt), n_q, d, p_max, n, n_chunks,
        k_out, metric_l2, vec16, static_cast<uint64_t*>(part_keys),
        static_cast<int32_t*>(part_cnt));
    return cudaGetLastError();
  };
  err = program != nullptr
            ? pass1(PredArg<true>{static_cast<const float*>(attrs), n_attr,
                                  *static_cast<const PredProgram*>(program)})
            : pass1(PredArg<false>{});
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = pass2_smem_bytes(k_out, n_chunks);
  err = allow_smem(topk_merge_pass2, smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_pass2<<<n_q, THREADS, smem2, st>>>(
      static_cast<const uint64_t*>(part_keys),
      static_cast<const int32_t*>(part_cnt), n_chunks, k_out, nullptr,
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(part_ids),
      p_max, static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}
