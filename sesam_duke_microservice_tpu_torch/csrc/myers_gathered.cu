// Levenshtein distance of each query to its own gathered candidates, for
// Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _myers_gathered_kernel  (:539, pallas_call in _myers_gathered_padded
//                              :588, entry myers_distance_gathered :609)
// for patterns of at most 32 UTF-16 units.  Unlike the cross-product tiles,
// candidate k of query q is a specific corpus row (the dd rescorer's
// survivor layout), so every pair has its own text.  It computes
// d(query_q[:ql], cand_qk[:cl]) -- the text length for an empty pattern --
// as that kernel does.
//
// Design.  One thread owns one (query, candidate) pair and keeps one uint32
// word of Pv and Mv.  A block is 8 warps; warp w serves one query and 32 of
// its candidates.  The query's pattern is staged once in shared memory and
// read as a broadcast; the 32 candidates' chars are one contiguous
// (32, L) run in device memory, loaded coalesced and stored transposed
// (lane-consecutive, conflict-free).  Each warp runs as many text steps as
// its longest candidate; per step a thread builds its match word by
// comparing its text char with the first ql pattern chars (bits above the
// pattern's last bit never reach the score) and runs the Hyyro step.  The
// dd ratio, map and log stay in torch (ops/dd.py), outside this kernel.
//
// Bound.  Per pair cl text steps of ~22 int32 operations (a match-table
// lookup, the Xv/Xh/Ph/Mh/Pv/Mv bit-ops, the add and the shifts) plus ~4
// for the score; the inputs are O(Q K L) chars read once and the output
// one int32 per pair.  That is about 4 bytes of input per ~26 operations
// per char, so at K = 64 the kernel sits near the H100's int32 ops:bytes
// balance; which of the two bounds it is computed from the run's data.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;    // queries per block (one per warp)
constexpr int kTileK = 32;   // candidates per warp (one per lane)
constexpr int kMaxL = 32;    // one DP word per pair

__device__ __forceinline__ uint32_t bits_below(int n) {
  if (n <= 0) return 0u;
  if (n >= 32) return 0xFFFFFFFFu;
  return (1u << n) - 1u;
}

__global__ void __launch_bounds__(kTileQ * kTileK)
myers_gathered_kernel(const int32_t* __restrict__ qchars,
                      const int32_t* __restrict__ qlen,
                      const int32_t* __restrict__ cchars,
                      const int32_t* __restrict__ clen,
                      int32_t* __restrict__ out, int Q, int K, int L) {
  __shared__ int32_t s_text[kTileQ][kMaxL][kTileK + 1];
  __shared__ int32_t s_pat[kTileQ][kMaxL];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int q = blockIdx.y * kTileQ + ty;
  const int k0 = blockIdx.x * kTileK;
  const bool qvalid = q < Q;
  const int krows = qvalid ? min(kTileK, K - k0) : 0;

  // this warp's query pattern and its candidates' chars, transposed
  if (qvalid) {
    const int32_t* src = cchars + ((int64_t)q * K + k0) * L;
    for (int e = tx; e < kTileK * L; e += kTileK) {
      const int row = e / L;
      s_text[ty][e - row * L][row] = row < krows ? src[e] : 0;
    }
    for (int e = tx; e < L; e += kTileK) {
      s_pat[ty][e] = qchars[(int64_t)q * L + e];
    }
  }
  __syncwarp();

  const int k = k0 + tx;
  const bool valid = tx < krows;
  const int ql = qvalid ? qlen[q] : 0;
  const int cl = valid ? clen[(int64_t)q * K + k] : 0;
  const int steps = min(__reduce_max_sync(0xFFFFFFFFu, cl), L);
  const int32_t* pat = s_pat[ty];
  const int plen = min(ql, L);

  uint32_t pv = bits_below(ql);
  uint32_t mv = 0u;
  const uint32_t hibit = 1u << ((max(ql, 1) - 1) & 31);
  int score = ql;
  for (int i = 0; i < steps; ++i) {
    const int32_t t = s_text[ty][i][tx];
    uint32_t eq = 0u;
    for (int j = 0; j < plen; ++j) {
      eq |= (uint32_t)(pat[j] == t) << j;
    }
    const uint32_t xv = eq | mv;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    uint32_t ph = mv | ~(xh | pv);
    uint32_t mh = pv & xh;
    if (i < cl) {
      score += (ph & hibit) != 0u;
      score -= (mh & hibit) != 0u;
      ph = (ph << 1) | 1u;
      mh = mh << 1;
      pv = mh | ~(xv | ph);
      mv = ph & xv;
    }
  }
  if (valid) {
    out[(int64_t)q * K + k] = ql == 0 ? cl : score;
  }
}

}  // namespace

extern "C" int myers_gathered(const int32_t* qchars, const int32_t* qlen,
                              const int32_t* cchars, const int32_t* clen,
                              int32_t* out, int Q, int K, int L,
                              cudaStream_t stream) {
  if (Q <= 0 || K <= 0 || L <= 0 || L > kMaxL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTileK, kTileQ);
  const dim3 grid((K + kTileK - 1) / kTileK, (Q + kTileQ - 1) / kTileQ);
  myers_gathered_kernel<<<grid, block, 0, stream>>>(
      qchars, qlen, cchars, clen, out, Q, K, L);
  return (int)cudaGetLastError();
}
