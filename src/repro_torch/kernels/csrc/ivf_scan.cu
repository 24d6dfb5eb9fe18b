// Fused IVF partition scan + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ivf_scan.py::ivf_scan_topk
// (body _scan_kernel, running merge _merge_topk).
//
// What it computes: for each query q and each probed partition part_ids[j]
// that q selects (qsel[q, j] != 0; every j without qsel), the scores
// ||v||^2 - 2 q.v (l2) or -q.v (ip / cosine) of the partition's p_max rows,
// masked by `valid` and by the post-filter -- the attribute predicate
// program evaluated on the row's `attrs` inside the scan
// (pred_program.cuh; the Pallas kernel's fused attr_filter), or a
// precomputed `keep` mask for an opaque filter callable -- and the
// ascending top-k_out over the flattened [n * p_max] list, ties broken by
// position j * p_max + slot (the order lax.top_k gives). Fewer qualifying
// rows than k_out leaves (MASKED, -1) in the tail -- never a repeated id.
// `vectors` may be any [F, p_max, d] pool that part_ids index.
//
// What bounds it on the H100: bytes. A selected (query, partition) pair
// does 2 d flops per valid row over 4 d bytes, 0.5 flop/byte, far below
// the ~20 flop/byte where float32 compute would take over. The least time
// is the selected partitions' valid rows read once at 3.35 TB/s (0.05 ms
// at 512 queries x 8 probes over 1M x 128 rows; 0.15 ms for an exact scan
// of all 1M rows, whatever the number of queries). What a kernel spends
// beyond that is finding work, leaving warps idle, issuing instructions
// per row, and sorting keys that cannot win.
//
// The design, against each cost:
// - Finding work: with qsel, scan_pair_list (topk_common.cuh) compacts
//   each query's selection row into its selected probe positions, and
//   pass 1's block (chunk c, query group) takes an equal share of that
//   list (of all n positions without qsel); the plan
//   (kernels/common.scan_plan) makes about as many blocks as the card
//   holds at once, so at 512 queries a query is one block and pass 2 is a
//   copy.
// - Keeping every warp busy: a block lists the rows of 128 (pair, 32-slot
//   group) items at a time -- each warp ballots the valid (and keep) bytes
//   of 16 items, all loads in flight, then evaluates the predicate program
//   on the valid rows' attributes (8 B a row at n_attr = 2; the 16 rows in
//   lockstep, their loads in flight together), and appends the set slots,
//   holes or not -- and then deals the listed rows out in batches of 4 R, so every
//   warp has the same share and most of a partition's empty groups cost
//   one ballot. Barriers fall only between lists and sub-rounds.
// - Reading rows: four teams of 8 lanes take R rows each per batch; a lane
//   issues its 16-byte loads of all R rows at once (each team load covers
//   128 contiguous bytes of a row). Widths that are not a multiple of 4,
//   or unaligned vectors, take the one scalar path.
// - Fixed reduction order: lane `sub` of a team sums the elements of the
//   float4s sub, sub + 8, sub + 16, ... in ascending order with fmaf (the
//   scalar path visits the same elements in the same order), and the 8
//   partials meet in one xor-shuffle tree (team_sum; with a query group
//   each lane keeps one query's sums, in the same tree). A row's score
//   therefore does not depend on the chunking, the batch, the query group
//   or which block reads the row: a query's results are bit-identical
//   solo or batched.
// - Filtering before sorting: a key at or above the block's running k-th
//   (or a k-th that another block of the same query published) is dropped
//   at once; survivors go into a shared candidate buffer through a
//   warp-aggregated atomic, which is sorted at its own power of two and
//   rank-merged into the running top-k (flush_candidates) when a sub-round
//   could overflow it, once it first holds k_out keys (to set a threshold
//   early), and at the end. Blocks publish their k-th with atomicMin into
//   `limits`, and pass 2 cuts every list to the keys at or below the final
//   limit before merging, so many chunks per query stay cheap.
// - Row sharing on the exact route (no qsel): a block takes a group of up
//   to 8 queries, staged in shared memory, reads each row once and scores
//   it against every query of the group, keeping one running top-k and one
//   candidate buffer per query -- what the Pallas kernel's [Q, p_max]
//   product per partition did.
// No tensor cores: at 512 queries a selected partition is probed by ~1.4
// queries, so an MMA tile would be mostly padding; on the exact route the
// bytes set the bound; and TF32 would move scores (and ids) by ~1e-3.

#include "pred_program.cuh"
#include "topk_common.cuh"

namespace {

constexpr int GROUP = 32;          // slots a warp ballots at once
constexpr int PAIR_BATCH = 64;     // pairs staged in shared memory at once
constexpr int LIST_ITEMS = 128;    // (pair, 32-slot group) items per row list
constexpr int LIST_CAP = LIST_ITEMS * GROUP;
// dynamic shared memory that still lets two blocks share an SM
constexpr size_t SMEM_TWO_PER_SM = 113 * 1024;

// Per query-group size G (queries a block scores each row against): the
// candidate buffer per query, the rows between flush checks (at most that
// many keys per query join a buffer in between), and the rows per 8-lane
// team per batch. With one query a block stays under 48 KB of shared
// memory up to k_out ~800, so no per-call opt-in (a host-side cost that
// small batches feel).
__host__ __device__ constexpr int cap_of(int g) {
  return g == 1 ? 2048 : 1024;
}
__host__ __device__ constexpr int sub_of(int g) {
  return g == 1 ? 1024 : 512;
}
__host__ __device__ constexpr int rows_of(int g) { return g == 1 ? 4 : 2; }

// One level of the team's reduction that halves the values a lane holds:
// the lane keeps the upper half when `hi`, and adds its partner's half.
template <int N>
__device__ __forceinline__ void halve(float* x, int off, bool hi) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = hi ? x[i] : x[i + N / 2];
    const float keep = hi ? x[i + N / 2] : x[i];
    x[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// The sums of a team's G per-lane partials x[0..G) over its 8 lanes, in
// the xor tree of offsets 4, 2, 1 (partner sums commute, so every g's sum
// has the same bits whatever G is). The first log2 G levels halve what a
// lane holds; lane `sub` ends with query sub / (8 / G)'s sum.
template <int G>
__device__ __forceinline__ float team_sum(float* x, int sub) {
  if constexpr (G >= 2) halve<G>(x, 4, sub & 4);
  else x[0] += __shfl_xor_sync(FULL, x[0], 4);
  if constexpr (G >= 4) halve<G / 2>(x, 2, sub & 2);
  else x[0] += __shfl_xor_sync(FULL, x[0], 2);
  if constexpr (G >= 8) halve<G / 4>(x, 1, sub & 1);
  else x[0] += __shfl_xor_sync(FULL, x[0], 1);
  return x[0];
}

struct ScanArgs {
  const float* queries;
  const float* vectors;
  const int8_t* valid;
  const int8_t* keep;          // null: no precomputed post-filter mask
  const int32_t* part_ids;
  const int32_t* pairs;        // null: every probe position is a pair
  const int32_t* pair_cnt;
  int n_q, d, p_max, n, n_chunks, k_out, metric_l2;
  int vec4;                    // 1: float4 loads, 0: the scalar path
  unsigned long long* limits;  // null: one chunk per query
  uint64_t* part_keys;
  int32_t* part_cnt;
};

size_t pass1_smem(int g, int k_out, int d) {
  const int dq = (d + 3) & ~3;
  return (size_t)g * dq * sizeof(float) +
         (size_t)g * (2 * k_out + cap_of(g) + 1) * sizeof(uint64_t) +
         (size_t)(LIST_CAP + 2 * g + 3 + 2 * PAIR_BATCH) * sizeof(int);
}

template <int G, bool HAS_PROG>
__global__ void __launch_bounds__(THREADS, 2)
ivf_scan_pass1(ScanArgs a, PredArg<HAS_PROG> pred) {
  constexpr int CAP = cap_of(G);
  constexpr int SUB = sub_of(G);
  constexpr int R = rows_of(G);
  constexpr int BATCH = 4 * R;                  // rows a warp takes at once
  constexpr int WARP_ITEMS = LIST_ITEMS / NWARPS;
  static_assert(SUB <= CAP, "a sub-round must fit the candidate buffer");
  extern __shared__ __align__(16) uint64_t smem1[];
  const int d = a.d, p_max = a.p_max, k_out = a.k_out;
  const int dq = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem1);                   // [G][dq]
  uint64_t* lists = reinterpret_cast<uint64_t*>(qs + G * dq);    // [G][2 k]
  uint64_t* cand = lists + (size_t)G * 2 * k_out;                // [G][CAP]
  uint64_t* thr_s = cand + (size_t)G * CAP;                      // [G]
  int* rowlist = reinterpret_cast<int*>(thr_s + G);  // slot << 6 | pair
  int* cnt_s = rowlist + LIST_CAP;                               // [G]
  int* r_s = cnt_s + G;                                          // [G]
  int* par_s = r_s + G;       // bit g: query g's list is its second half
  int* list_n = par_s + 1;    // [2] rows listed, alternating by list
  int* pj = list_n + 2;                                          // probe pos
  int* pp = pj + PAIR_BATCH;                                     // partition

  const int c = blockIdx.x, q0 = blockIdx.y * G;
  const int gq = min(G, a.n_q - q0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sub = lane & 7, team = lane >> 3;   // 8 lanes per row
  const unsigned below = (1u << lane) - 1u;
  for (int t = threadIdx.x; t < G * dq; t += THREADS) {
    const int g = t / dq, e = t - g * dq;
    qs[t] = (g < gq && e < d) ? a.queries[(size_t)(q0 + g) * d + e] : 0.f;
  }
  if (threadIdx.x < G) {
    thr_s[threadIdx.x] = EMPTY_KEY;
    cnt_s[threadIdx.x] = 0;
    r_s[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    *par_s = 0;
    list_n[0] = 0;
  }
  const int cnt = a.pairs ? a.pair_cnt[q0] : a.n;
  const int per = (cnt + a.n_chunks - 1) / a.n_chunks;
  const int a_begin = min(cnt, c * per), a_end = min(cnt, a_begin + per);
  const int groups = (p_max + GROUP - 1) / GROUP;
  const int nf = d >> 2;      // float4s per row on the vector path

  // Fold query g's candidates into its running list and publish its k-th.
  // Every thread calls it, after a barrier; it ends with one.
  auto flush = [&](int g) {
    uint64_t* base = lists + (size_t)g * 2 * k_out;
    const bool second = (*par_s >> g) & 1;
    uint64_t* run = second ? base + k_out : base;
    uint64_t* tmp = second ? base : base + k_out;
    const int r = flush_candidates(run, tmp, r_s[g], cand + (size_t)g * CAP,
                                   cnt_s[g], k_out);
    if (threadIdx.x == 0) {
      r_s[g] = r;
      *par_s ^= 1 << g;
      cnt_s[g] = 0;
      if (r == k_out) {
        uint64_t kth = run[k_out - 1];
        if (a.limits != nullptr) {
          const uint64_t old = atomicMin(a.limits + q0 + g,
                                         (unsigned long long)kth);
          if (old < kth) kth = old;
        }
        if (kth < thr_s[g]) thr_s[g] = kth;
      }
    }
    __syncthreads();
  };

  int list_no = 0;
  for (int b0 = a_begin; b0 < a_end; b0 += PAIR_BATCH) {
    const int nb = min(PAIR_BATCH, a_end - b0);
    __syncthreads();             // the previous batch is fully read
    for (int t = threadIdx.x; t < nb; t += THREADS) {
      const int j = a.pairs ? a.pairs[(size_t)q0 * a.n + b0 + t] : b0 + t;
      pj[t] = j;
      pp[t] = a.part_ids[j];
    }
    __syncthreads();
    const int items = nb * groups;
    for (int i0 = 0; i0 < items; i0 += LIST_ITEMS, ++list_no) {
      // The rows of the next LIST_ITEMS items, listed: each warp ballots
      // the valid (and keep) bytes of its items, all loads in flight at
      // once, and appends the set slots with one atomic per item.
      int* ln = list_n + (list_no & 1);
      if (threadIdx.x == 0) list_n[(list_no + 1) & 1] = 0;
      bool ok[WARP_ITEMS];
#pragma unroll
      for (int u = 0; u < WARP_ITEMS; ++u) {
        const int item = i0 + w * WARP_ITEMS + u;
        const int slot = (item % groups) * GROUP + lane;
        ok[u] = false;
        if (item < items && slot < p_max) {
          const size_t at = (size_t)pp[item / groups] * p_max + slot;
          ok[u] = a.valid[at] != 0 && (a.keep == nullptr || a.keep[at] != 0);
        }
      }
      if constexpr (HAS_PROG) {
        size_t row[WARP_ITEMS];
#pragma unroll
        for (int u = 0; u < WARP_ITEMS; ++u) {
          const int item = i0 + w * WARP_ITEMS + u;
          const int slot = (item % groups) * GROUP + lane;
          row[u] = ok[u] ? ((size_t)pp[item / groups] * p_max + slot) *
                               pred.n_attr
                         : 0;
        }
        eval_program_rows<WARP_ITEMS>(pred.prog, pred.attrs, row, ok);
      }
#pragma unroll
      for (int u = 0; u < WARP_ITEMS; ++u) {
        const unsigned m = __ballot_sync(FULL, ok[u]);
        if (m == 0) continue;                    // warp-uniform
        int at = 0;
        if (lane == 0) at = atomicAdd(ln, __popc(m));
        at = __shfl_sync(FULL, at, 0);
        const int item = i0 + w * WARP_ITEMS + u;
        if (ok[u])
          rowlist[at + __popc(m & below)] =
              ((item % groups) * GROUP + lane) << 6 | (item / groups);
      }
      __syncthreads();
      const int nrows = *ln;
      // The listed rows in sub-rounds of at most SUB: warps take BATCH
      // rows at a time in turn, so every warp has the same share.
      for (int s0 = 0; s0 < nrows; s0 += SUB) {
        // k-th keys other blocks of these queries published tighten the
        // filter (any value once published stays a valid bound)
        if (a.limits != nullptr && threadIdx.x < gq) {
          const uint64_t lim = __ldcg(a.limits + q0 + threadIdx.x);
          if (lim < thr_s[threadIdx.x]) thr_s[threadIdx.x] = lim;
        }
        __syncthreads();
        // flush a buffer that this sub-round could overflow, and a first
        // k_out candidates at once, to set a threshold early
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < gq && (cnt_s[g] + SUB > CAP ||
                         (r_s[g] < k_out && cnt_s[g] >= k_out)))
            flush(g);
        const int s1 = min(nrows, s0 + SUB);
        for (int bs = s0 + w * BATCH; bs < s1; bs += NWARPS * BATCH) {
          // team `team` takes the listed rows bs + team * R + h
          bool has[R];
          uint32_t pos[R];
          const float* vr[R];
#pragma unroll
          for (int h = 0; h < R; ++h) {
            const int idx = bs + team * R + h;
            has[h] = idx < s1;
            const int e = has[h] ? rowlist[idx] : 0;
            const int slot = e >> 6;
            pos[h] = (uint32_t)((size_t)pj[e & 63] * p_max + slot);
            vr[h] = a.vectors + ((size_t)pp[e & 63] * p_max + slot) * d;
          }
          float dot[R][G], v2[R];
#pragma unroll
          for (int h = 0; h < R; ++h) {
            v2[h] = 0.f;
#pragma unroll
            for (int g = 0; g < G; ++g) dot[h][g] = 0.f;
          }
          if (a.vec4) {
            for (int f0 = 0; f0 < nf; f0 += 32) {
              float4 x[R][4];
#pragma unroll
              for (int h = 0; h < R; ++h) {
#pragma unroll
                for (int u4 = 0; u4 < 4; ++u4) {
                  const int f = f0 + sub + 8 * u4;
                  x[h][u4] = (has[h] && f < nf)
                                 ? __ldg(reinterpret_cast<const float4*>(
                                       vr[h]) + f)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
                }
              }
#pragma unroll
              for (int u4 = 0; u4 < 4; ++u4) {
                const int f = f0 + sub + 8 * u4;
                if (f >= nf) break;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                  const float4 b =
                      reinterpret_cast<const float4*>(qs + g * dq)[f];
#pragma unroll
                  for (int h = 0; h < R; ++h) {
                    dot[h][g] = fmaf(b.x, x[h][u4].x, dot[h][g]);
                    dot[h][g] = fmaf(b.y, x[h][u4].y, dot[h][g]);
                    dot[h][g] = fmaf(b.z, x[h][u4].z, dot[h][g]);
                    dot[h][g] = fmaf(b.w, x[h][u4].w, dot[h][g]);
                  }
                }
#pragma unroll
                for (int h = 0; h < R; ++h) {
                  v2[h] = fmaf(x[h][u4].x, x[h][u4].x, v2[h]);
                  v2[h] = fmaf(x[h][u4].y, x[h][u4].y, v2[h]);
                  v2[h] = fmaf(x[h][u4].z, x[h][u4].z, v2[h]);
                  v2[h] = fmaf(x[h][u4].w, x[h][u4].w, v2[h]);
                }
              }
            }
          } else {
            // the same elements per lane in the same order, one at a time
            for (int f = sub; 4 * f < d; f += 8) {
              for (int e = 4 * f; e < min(d, 4 * f + 4); ++e) {
#pragma unroll
                for (int h = 0; h < R; ++h) {
                  const float x = has[h] ? vr[h][e] : 0.f;
#pragma unroll
                  for (int g = 0; g < G; ++g)
                    dot[h][g] = fmaf(qs[g * dq + e], x, dot[h][g]);
                  v2[h] = fmaf(x, x, v2[h]);
                }
              }
            }
          }
          // ||v||^2 over the team's xor tree (every lane the same bits);
          // the dots over the same tree, each lane keeping one query's
          // sums: the query gl of the lanes sub = gl * S, S = 8 / G
          constexpr int S = 8 / G;
          const int gl = sub / S;
          const bool owner = sub % S == 0 && gl < gq;
          float dg[R];
#pragma unroll
          for (int h = 0; h < R; ++h) {
#pragma unroll
            for (int off = 4; off > 0; off >>= 1)
              v2[h] += __shfl_xor_sync(FULL, v2[h], off);
            dg[h] = team_sum<G>(dot[h], sub);
          }
          const uint64_t th = owner ? thr_s[gl] : 0;
          uint64_t key[R];
          unsigned wb[R], any = 0;
#pragma unroll
          for (int h = 0; h < R; ++h) {
            key[h] = EMPTY_KEY;
            if (owner && has[h]) {
              const float s = a.metric_l2
                                  ? __fsub_rn(v2[h], __fmul_rn(2.f, dg[h]))
                                  : -dg[h];
              key[h] = make_key(s, pos[h]);
            }
            wb[h] = __ballot_sync(FULL, key[h] < th);
            any |= wb[h];
          }
          if (any == 0) continue;                     // warp-uniform
          // one atomic per query, by its owner lane of team 0, for the
          // survivors of its four owner lanes (one per team)
          const unsigned qmask = 0x01010101u << (gl * S);
          int total = 0;
#pragma unroll
          for (int h = 0; h < R; ++h) total += __popc(wb[h] & qmask);
          int at = 0;
          if (owner && team == 0 && total > 0)
            at = atomicAdd(cnt_s + gl, total);
          at = __shfl_sync(FULL, at, gl * S);
          uint64_t* cg = cand + (size_t)gl * CAP;
#pragma unroll
          for (int h = 0; h < R; ++h) {
            if (key[h] < th) cg[at + __popc(wb[h] & qmask & below)] = key[h];
            at += __popc(wb[h] & qmask);
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();               // cnt_s is final (also with no pairs)
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (g < gq && cnt_s[g] > 0) flush(g);
  for (int g = 0; g < gq; ++g) {
    const int r = r_s[g];
    const uint64_t* run =
        lists + (size_t)g * 2 * k_out + (((*par_s >> g) & 1) ? k_out : 0);
    const size_t at = (size_t)(q0 + g) * a.n_chunks + c;
    for (int t = threadIdx.x; t < r; t += THREADS)
      a.part_keys[at * k_out + t] = run[t];
    if (threadIdx.x == 0) a.part_cnt[at] = r;
  }
}

template <int G, bool HAS_PROG>
cudaError_t run_pass1(const ScanArgs& a, const PredArg<HAS_PROG>& pred,
                      size_t smem, cudaStream_t st) {
  cudaError_t err = allow_smem(ivf_scan_pass1<G, HAS_PROG>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_chunks, (a.n_q + G - 1) / G);
  ivf_scan_pass1<G, HAS_PROG><<<grid, THREADS, smem, st>>>(a, pred);
  return cudaGetLastError();
}

template <bool HAS_PROG>
cudaError_t launch_pass1(const ScanArgs& a, const PredArg<HAS_PROG>& pred,
                         int group, size_t smem, cudaStream_t st) {
  switch (group) {
    case 8: return run_pass1<8>(a, pred, smem, st);
    case 4: return run_pass1<4>(a, pred, smem, st);
    case 2: return run_pass1<2>(a, pred, smem, st);
    case 1: return run_pass1<1>(a, pred, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the pair list (with qsel), pass 1 and pass 2 on `stream`; the
// caller allocates scratch and outputs: pairs [n_q * (n + 1)] i32 with qsel
// (lists, then counts), limits [n_q] u64 with more than one chunk,
// part_keys [n_q, n_chunks, k_out] u64, part_cnt [n_q, n_chunks] i32.
// `program` is a host PredProgram (null: none), copied into the launch
// arguments; with one, `attrs` [F, p_max, n_attr] is read on the device.
// `group` is the most queries a block shares rows across (1 with qsel);
// it is halved until a block's shared memory lets two blocks share an SM.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ivf_scan_launch(const void* queries, const void* vectors,
                               const void* valid, const void* keep,
                               const void* attrs, const void* program,
                               const void* ids, const void* part_ids,
                               const void* qsel, int n_q, int d, int p_max,
                               int n, int n_chunks, int k_out, int metric_l2,
                               int group, int n_attr, void* pairs,
                               void* pair_cnt,
                               void* limits, void* part_keys, void* part_cnt,
                               void* out_s, void* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (qsel != nullptr) {
    group = 1;
    scan_pair_list<<<n_q, THREADS, 0, st>>>(
        static_cast<const int8_t*>(qsel), n, static_cast<int32_t*>(pairs),
        static_cast<int32_t*>(pair_cnt));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_chunks > 1) {
    err = cudaMemsetAsync(limits, 0xff, (size_t)n_q * sizeof(uint64_t), st);
    if (err != cudaSuccess) return (int)err;
  } else {
    limits = nullptr;
  }
  ScanArgs a{static_cast<const float*>(queries),
             static_cast<const float*>(vectors),
             static_cast<const int8_t*>(valid),
             static_cast<const int8_t*>(keep),
             static_cast<const int32_t*>(part_ids),
             qsel ? static_cast<const int32_t*>(pairs) : nullptr,
             static_cast<const int32_t*>(pair_cnt),
             n_q, d, p_max, n, n_chunks, k_out, metric_l2,
             d % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0,
             static_cast<unsigned long long*>(limits),
             static_cast<uint64_t*>(part_keys),
             static_cast<int32_t*>(part_cnt)};
  while (group > 1 && pass1_smem(group, k_out, d) > SMEM_TWO_PER_SM)
    group >>= 1;
  const size_t smem1 = pass1_smem(group, k_out, d);
  if (program != nullptr) {
    const PredArg<true> pred{static_cast<const float*>(attrs), n_attr,
                             *static_cast<const PredProgram*>(program)};
    err = launch_pass1(a, pred, group, smem1, st);
  } else {
    err = launch_pass1(a, PredArg<false>{}, group, smem1, st);
  }
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = pass2_smem_bytes(k_out, n_chunks);
  err = allow_smem(topk_merge_pass2, smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_pass2<<<n_q, THREADS, smem2, st>>>(
      static_cast<const uint64_t*>(part_keys),
      static_cast<const int32_t*>(part_cnt), n_chunks, k_out,
      static_cast<const unsigned long long*>(limits),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(part_ids),
      p_max, static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}
