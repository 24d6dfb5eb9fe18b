// The attribute predicate program, evaluated per row inside the scans.
//
// Replaces the fused `attr_filter(attrs_ref[0])` of the Pallas scan
// kernels (repro/kernels/ivf_scan.py, repro/kernels/sq_scan.py), which
// evaluate the compiled predicate tree on each probed partition's
// [p_max, n_attr] attribute block. Here the tree arrives as a postfix
// program (core/hybrid.compile_program): one instruction per leaf
// (attrs[col] <op> value, or a uint32 tag-bit match) and n-ary AND / OR
// combinators. The results live in a 32-bit stack per row (bit 0 = top),
// so no local memory is touched.
//
// The program rides in the launch arguments (by value, 516 bytes: the
// kernel-parameter space), so a filtered scan costs no host-to-device
// copy; every lane walks the same instructions, so its reads of the
// parameter space are uniform. A lane evaluates all the rows it holds
// together (eval_program_rows). The scans take it as PredArg<HAS_PROG>, a
// template parameter of pass 1, so the instance without a program carries
// neither the evaluator's registers nor the 520 argument bytes.
//
// Semantics are core/hybrid.eval_predicate's: comparisons in float32
// against the value rounded to float32 once (NaN compares false, and !=
// true), match as ((int64)x & bits) == bits.

#pragma once
#include <cstdint>

constexpr int PRED_MAX = 64;    // instructions (hybrid.MAX_PROGRAM)
constexpr int PRED_OP_AND = 7;  // opcodes: hybrid.PROGRAM_OPS
constexpr int PRED_OP_OR = 8;

struct PredProgram {
  int32_t n;                    // instructions
  uint32_t code[PRED_MAX];      // opcode | arg << 8
  uint32_t word[PRED_MAX];      // float32 value bits, or match tag bits
};

// Pass 1's predicate argument: nothing without a program.
template <bool HAS_PROG>
struct PredArg {};
template <>
struct PredArg<true> {
  const float* attrs;           // [F, p_max, n_attr]
  int n_attr;
  PredProgram prog;
};

// The predicate for a lane's U rows at once: row[u] is the offset of row
// u's attributes in `attrs`, read only where ok[u]; ok[u] ends true where
// it was and the row satisfies the predicate. The rows walk the program in
// lockstep, one instruction at a time, so each leaf issues its U loads
// together (one memory latency per leaf, not per row and leaf), and the
// opcode branch is uniform across the warp.
template <int U>
__device__ __forceinline__ void eval_program_rows(
    const PredProgram& p, const float* __restrict__ attrs,
    const size_t (&row)[U], bool (&ok)[U]) {
  uint32_t st[U];
#pragma unroll
  for (int u = 0; u < U; ++u) st[u] = 0u;
  for (int i = 0; i < p.n; ++i) {
    const uint32_t c = p.code[i];
    const uint32_t op = c & 0xffu, arg = c >> 8;
    if (op >= PRED_OP_AND) {
      // pop `arg` results (arg <= 32, the stack depth limit), push one
      const uint32_t m = arg >= 32 ? 0xffffffffu : (1u << arg) - 1u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t top = st[u] & m;
        const uint32_t bit = op == PRED_OP_AND ? (top == m) : (top != 0u);
        st[u] = ((arg >= 32 ? 0u : st[u] >> arg) << 1) | bit;
      }
      continue;
    }
    const uint32_t w = p.word[i];
    const float v = __uint_as_float(w);
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = ok[u] ? __ldg(attrs + row[u] + arg) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t bit;
      switch (op) {
        case 0: bit = x[u] < v; break;
        case 1: bit = x[u] <= v; break;
        case 2: bit = x[u] > v; break;
        case 3: bit = x[u] >= v; break;
        case 4: bit = x[u] == v; break;
        case 5: bit = x[u] != v; break;
        default:
          bit = (((uint32_t)(long long)x[u]) & w) == w;
          break;
      }
      st[u] = (st[u] << 1) | bit;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) ok[u] = ok[u] && (st[u] & 1u);
}
