// One text step of the W-word Myers/Hyyro Levenshtein DP on match words
// looked up from a unit_table.cuh table, and the distance read from the
// last column.  Shared by the Myers tile kernel (myers_tile.cu, W = 1, 2,
// 4, 8) and the gathered Myers kernel (myers_gathered.cu, W = 1), so the
// two cannot drift apart.
//
// A pattern of ql units keeps Pv = the ql low bits set and Mv = 0 at the
// start; bits above the pattern's last bit never reach the score, since
// carries and shifts only move up.  After `steps` text steps the distance
// is steps + popc(Pv) - popc(Mv) over the pattern's bits: D[0][n] = n,
// plus the last column's +1s and -1s.

#pragma once

#include <stdint.h>

#include "unit_table.cuh"

namespace myers_step {

using unit_table::kDirect;

__host__ __device__ __forceinline__ uint32_t bits_below(int n) {
  // (1 << n) - 1 for n in [0, 32]; << 32 is undefined in C too
  if (n <= 0) return 0u;
  if (n >= 32) return 0xFFFFFFFFu;
  return (1u << n) - 1u;
}

// s += b as W-word integers (word 0 lowest), the carry out of the top word
// dropped
template <int W>
__device__ __forceinline__ void add_words(uint32_t (&s)[W],
                                          const uint32_t (&b)[W]) {
  if constexpr (W == 1) {
    s[0] += b[0];
  } else if constexpr (W == 2) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, %3;"
        : "+r"(s[0]), "+r"(s[1])
        : "r"(b[0]), "r"(b[1]));
  } else if constexpr (W == 4) {
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, %7;"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
  } else {
    static_assert(W == 8, "W is 1, 2, 4 or 8");
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
          "+r"(s[5]), "+r"(s[6]), "+r"(s[7])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]));
  }
}

// The W match words of text unit t in one query's table (laid out as
// unit_table.cuh builds it, nside side-list entries): a direct load below
// 256, else a search of the side list (all zero if t is not there).  With
// kSide false the caller knows the side list is empty (nside == 0), and
// the search is compiled out.
template <int W, bool kSide = true>
__device__ __forceinline__ void match_words(const uint32_t* peq, uint32_t t,
                                            int nside, int L,
                                            uint32_t (&eq)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) eq[w] = 0u;
  if (t < (uint32_t)kDirect) {
#pragma unroll
    for (int w = 0; w < W; ++w) eq[w] = peq[w * kDirect + t];
  } else if constexpr (kSide) {
    const int32_t* side_unit =
        reinterpret_cast<const int32_t*>(peq + kDirect * W);
    const uint32_t* side_mask = peq + kDirect * W + L;
    for (int s = 0; s < nside; ++s) {
      if ((uint32_t)side_unit[s] == t) {
#pragma unroll
        for (int w = 0; w < W; ++w) eq[w] = side_mask[w * L + s];
        break;
      }
    }
  }
}

// One text step of the W-word Myers/Hyyro recurrence on looked-up match
// words.
template <int W>
__device__ __forceinline__ void hyyro_step(const uint32_t (&eq)[W],
                                           uint32_t (&pv)[W],
                                           uint32_t (&mv)[W]) {
  // xh = (((eq & pv) + pv) ^ pv) | eq, the add carrying across words
  uint32_t sum[W];
#pragma unroll
  for (int w = 0; w < W; ++w) sum[w] = eq[w] & pv[w];
  add_words<W>(sum, pv);
  uint32_t xv[W], ph[W], mh[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    xv[w] = eq[w] | mv[w];
    const uint32_t xh = (sum[w] ^ pv[w]) | eq[w];
    ph[w] = mv[w] | ~(xh | pv[w]);
    mh[w] = pv[w] & xh;
  }
  // horizontal shifts with cross-word carries
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t nph =
        w == 0 ? (ph[0] << 1) | 1u : __funnelshift_l(ph[w - 1], ph[w], 1);
    const uint32_t nmh =
        w == 0 ? mh[0] << 1 : __funnelshift_l(mh[w - 1], mh[w], 1);
    pv[w] = nmh | ~(xv[w] | nph);
    mv[w] = nph & xv[w];
  }
}

// The DP state of a pattern of ql units before the first text step.
template <int W>
__device__ __forceinline__ void start(int ql, uint32_t (&pv)[W],
                                      uint32_t (&mv)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = bits_below(ql - 32 * w);
    mv[w] = 0u;
  }
}

// d(pattern, text) after `steps` text steps: steps + the last column's +1s
// - its -1s, over the pattern's ql bits (those above it never reach them).
template <int W>
__device__ __forceinline__ int last_column(int ql, int steps,
                                           const uint32_t (&pv)[W],
                                           const uint32_t (&mv)[W]) {
  int score = steps;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t bits = bits_below(ql - 32 * w);
    score += __popc(pv[w] & bits) - __popc(mv[w] & bits);
  }
  return score;
}

}  // namespace myers_step
