// All-pairs Levenshtein distance by Myers/Hyyro bit-parallel DP, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernels
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _myers_tile_kernel   (:151, one uint32 word, patterns <= 32 chars)
//     _myersN_tile_kernel  (:265, W = ceil(L/32) <= 8 words)
// with one kernel templated on W in {1, 2, 4, 8}.  It computes what those
// kernels compute -- d(query_q[:ql], corpus_c[:cl]) for every (q, c) pair,
// the text length for an empty pattern -- not a copy of their block layout.
//
// Design.  One thread owns one (query, corpus) pair and keeps the W words
// of Pv and Mv in registers.  A block is TQ x TC = 8 x 32 pairs: the 32
// lanes of a warp share one query (its pattern is read from shared memory
// as a broadcast) and walk 32 corpus rows whose text tile sits transposed
// in shared memory (lane-consecutive, conflict-free).  Per text step each
// thread rebuilds its match words by comparing the text char against the
// pattern's chars (only the first ql of them: bits above the pattern's
// last bit never reach the score, since carries and shifts only move
// up), then runs the Hyyro step with an explicit carry through the add
// chain and the cross-word shifts.  The similarity / logit math stays in
// torch, outside this kernel, so nvcc's FMA contraction never touches it.
//
// Bound.  The DP needs, per pair, cl text steps of ~22 int32 operations
// per word (a match-table lookup, then the Xv/Xh/Ph/Mh/Pv/Mv bit-ops, the
// add with its carry and the cross-word shifts) plus ~4 for the score;
// it writes one int32 per pair, and its inputs are O((Q + C) L).  At the
// main path's shapes (Q >= 1024, C = 8192) that is hundreds of operations
// per output byte, far above the H100's ops:bytes balance, so the bound is
// the int32 ALU rate (64 lanes per SM), not device memory.  This kernel
// has no match table: it spends up to ql extra compares per text step
// building the match words, which is most of its distance from the bound.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;   // queries per block (one per warp)
constexpr int kTileC = 32;  // corpus rows per block (one per lane)

__device__ __forceinline__ uint32_t bits_below(int n) {
  // (1 << n) - 1 for n in [0, 32]; << 32 is undefined in C too
  if (n <= 0) return 0u;
  if (n >= 32) return 0xFFFFFFFFu;
  return (1u << n) - 1u;
}

template <int W>
__global__ void __launch_bounds__(kTileQ * kTileC)
myers_tile_kernel(const int32_t* __restrict__ qchars,
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ cchars,
                  const int32_t* __restrict__ clen,
                  int32_t* __restrict__ out, int Q, int C, int L) {
  extern __shared__ int32_t smem[];
  int32_t* s_text = smem;                             // [L][kTileC + 1]
  int32_t* s_pat = smem + L * (kTileC + 1);           // [kTileQ][L]
  __shared__ int s_maxcl;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileC + tx;
  const int q0 = blockIdx.y * kTileQ;
  const int c0 = blockIdx.x * kTileC;
  if (tid == 0) s_maxcl = 0;

  // stage the corpus text tile transposed and the block's patterns
  for (int e = tid; e < kTileC * L; e += kTileQ * kTileC) {
    const int row = e / L;
    const int col = e - row * L;
    const int c = c0 + row;
    s_text[col * (kTileC + 1) + row] =
        c < C ? cchars[(int64_t)c * L + col] : 0;
  }
  for (int e = tid; e < kTileQ * L; e += kTileQ * kTileC) {
    const int row = e / L;
    const int q = q0 + row;
    s_pat[e] = q < Q ? qchars[(int64_t)q * L + (e - row * L)] : 0;
  }
  const int q = q0 + ty;
  const int c = c0 + tx;
  const int ql = q < Q ? qlen[q] : 0;
  const int cl = c < C ? clen[c] : 0;
  __syncthreads();
  if (ty == 0) atomicMax(&s_maxcl, cl);
  __syncthreads();
  const int steps = min(s_maxcl, L);
  const int32_t* pat = s_pat + ty * L;
  const int plen = min(ql, L);

  uint32_t pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = bits_below(ql - 32 * w);
    mv[w] = 0u;
  }
  // the score bit rides in the pattern's last word/bit
  const int last = max(ql, 1) - 1;
  const int hi_word = last >> 5;
  const uint32_t hibit = 1u << (last & 31);
  int score = ql;

  for (int i = 0; i < steps; ++i) {
    const int32_t t = s_text[i * (kTileC + 1) + tx];
    const bool active = i < cl;
    uint32_t eq[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t e = 0u;
      const int jend = min(32, plen - 32 * w);
      for (int j = 0; j < jend; ++j) {
        e |= (uint32_t)(pat[32 * w + j] == t) << j;
      }
      eq[w] = e;
    }
    uint32_t xv[W], xh[W], ph[W], mh[W];
    uint32_t carry = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      xv[w] = eq[w] | mv[w];
      // xh = (((eq & pv) + pv) ^ pv) | eq, the carry crossing words (the
      // carry out of the last word falls off the pattern window)
      const uint64_t s = (uint64_t)(eq[w] & pv[w]) + pv[w] + carry;
      carry = (uint32_t)(s >> 32);
      xh[w] = (((uint32_t)s) ^ pv[w]) | eq[w];
      ph[w] = mv[w] | ~(xh[w] | pv[w]);
      mh[w] = pv[w] & xh[w];
    }
    uint32_t ph_hi = ph[0], mh_hi = mh[0];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      if (hi_word == w) {
        ph_hi = ph[w];
        mh_hi = mh[w];
      }
    }
    if (active) {
      score += (ph_hi & hibit) != 0u;
      score -= (mh_hi & hibit) != 0u;
      // horizontal shifts with cross-word carries
      uint32_t ph_c = 1u, mh_c = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t nph = (ph[w] << 1) | ph_c;
        const uint32_t nmh = (mh[w] << 1) | mh_c;
        ph_c = ph[w] >> 31;
        mh_c = mh[w] >> 31;
        pv[w] = nmh | ~(xv[w] | nph);
        mv[w] = nph & xv[w];
      }
    }
  }
  if (q < Q && c < C) {
    out[(int64_t)q * C + c] = ql == 0 ? cl : score;
  }
}

template <int W>
cudaError_t launch(const int32_t* qchars, const int32_t* qlen,
                   const int32_t* cchars, const int32_t* clen, int32_t* out,
                   int Q, int C, int L, cudaStream_t stream) {
  const dim3 block(kTileC, kTileQ);
  const dim3 grid((C + kTileC - 1) / kTileC, (Q + kTileQ - 1) / kTileQ);
  const size_t shmem = sizeof(int32_t) * (size_t)L * (kTileC + 1 + kTileQ);
  myers_tile_kernel<W><<<grid, block, shmem, stream>>>(
      qchars, qlen, cchars, clen, out, Q, C, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int myers_tiles(const int32_t* qchars, const int32_t* qlen,
                           const int32_t* cchars, const int32_t* clen,
                           int32_t* out, int Q, int C, int L, int words,
                           cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || L <= 0 || L > 32 * words) {
    return (int)cudaErrorInvalidValue;
  }
  switch (words) {
    case 1:
      return (int)launch<1>(qchars, qlen, cchars, clen, out, Q, C, L, stream);
    case 2:
      return (int)launch<2>(qchars, qlen, cchars, clen, out, Q, C, L, stream);
    case 4:
      return (int)launch<4>(qchars, qlen, cchars, clen, out, Q, C, L, stream);
    case 8:
      return (int)launch<8>(qchars, qlen, cchars, clen, out, Q, C, L, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
