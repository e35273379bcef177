// All-pairs Jaro-Winkler similarity, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _jw_tile_kernel  (:387, pallas_call in _jw_tiles_padded :495)
// for patterns and texts of at most 32 UTF-16 units.  It computes what that
// kernel computes -- the Jaro similarity of query_q[:ql] and corpus_c[:cl]
// with the Winkler prefix boost above boost_threshold -- not a copy of its
// block layout; the exact-equality override (1.0) stays in torch.
//
// Design.  One thread owns one (query, corpus) pair.  A block is TQ x TC =
// 8 x 32 pairs: the 32 lanes of a warp share one query (its chars are read
// from shared memory as a broadcast) and walk 32 corpus rows whose chars
// sit transposed in shared memory (lane-consecutive, conflict-free).
//   * Matching: for each query char in order, the lowest unmatched equal
//     text char inside the window max(l1, l2)/2 - 1 is taken (the lowest
//     set bit of the available mask); matched positions go into two uint32
//     masks, m1 over the query and m2 over the text.
//   * Transpositions: both masks are walked lowest bit first (__ffs), and
//     the k-th matched query char is compared with the k-th matched text
//     char.
//   * Prefix: the common prefix, up to max_prefix chars.
//   * The float tail (m/l1 + m/l2 + (m - t/2)/m) / 3 and the boost
//     j + prefix * prefix_scale * (1 - j) are evaluated in the JAX order
//     with __fdiv_rn / __fadd_rn / __fsub_rn / __fmul_rn, so nvcc's default
//     -fmad=true contracts nothing and the result equals the plain PyTorch
//     version (separate IEEE operations) bit for bit.
//
// Bound.  A match done by lookup (one position mask per char for each
// corpus row, shared by all queries) needs ~8 int32 operations per query
// char, plus ~6 per match for the walk and 2 per prefix char; this kernel
// compares each query char with every text position of its window instead,
// so it does several times the bound's work.  The output is one float per
// pair and the inputs O((Q + C) L): at the main path's shapes (Q >= 1024,
// C = 8192, L = 32) the bound is the int32 ALU rate, not device memory.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;    // queries per block (one per warp)
constexpr int kTileC = 32;   // corpus rows per block (one per lane)
constexpr int kMaxL = 32;    // one uint32 mask per side

__global__ void __launch_bounds__(kTileQ * kTileC)
jw_tile_kernel(const int32_t* __restrict__ qchars,
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ cchars,
               const int32_t* __restrict__ clen,
               float* __restrict__ out, int Q, int C, int L, int max_prefix,
               float prefix_scale, float boost_threshold) {
  __shared__ int32_t s_text[kMaxL][kTileC + 1];
  __shared__ int32_t s_pat[kTileQ][kMaxL];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileC + tx;
  const int q0 = blockIdx.y * kTileQ;
  const int c0 = blockIdx.x * kTileC;

  // stage the corpus tile transposed and the block's query chars
  for (int e = tid; e < kTileC * L; e += kTileQ * kTileC) {
    const int row = e / L;
    const int col = e - row * L;
    const int c = c0 + row;
    s_text[col][row] = c < C ? cchars[(int64_t)c * L + col] : 0;
  }
  for (int e = tid; e < kTileQ * L; e += kTileQ * kTileC) {
    const int row = e / L;
    const int col = e - row * L;
    const int q = q0 + row;
    s_pat[row][col] = q < Q ? qchars[(int64_t)q * L + col] : 0;
  }
  __syncthreads();

  const int q = q0 + ty;
  const int c = c0 + tx;
  if (q >= Q || c >= C) return;
  const int l1 = qlen[q];
  const int l2 = clen[c];
  const int32_t* pat = s_pat[ty];

  // greedy matching into the two position masks
  const int window = max(max(l1, l2) / 2 - 1, 0);
  uint32_t m1 = 0u, m2 = 0u;
  int matches = 0;
  const int imax = min(l1, L);
  for (int i = 0; i < imax; ++i) {
    const int32_t ci = pat[i];
    const int lo = max(i - window, 0);
    const int hi = min(min(l2, i + window + 1), L);
    uint32_t avail = 0u;
    for (int j = lo; j < hi; ++j) {
      avail |= (uint32_t)(s_text[j][tx] == ci) << j;
    }
    avail &= ~m2;
    const uint32_t jstar = avail & (0u - avail);  // lowest available bit
    if (jstar != 0u) {
      m2 |= jstar;
      m1 |= 1u << i;
      ++matches;
    }
  }

  // transpositions: the k-th matched chars of both sides, in order
  int trans = 0;
  uint32_t a = m1, b = m2;
  while (a != 0u) {
    trans += pat[__ffs(a) - 1] != s_text[__ffs(b) - 1][tx];
    a &= a - 1u;
    b &= b - 1u;
  }

  // Winkler common prefix
  int prefix = 0;
  const int kmax = min(min(L, max_prefix), min(l1, l2));
  while (prefix < kmax && pat[prefix] == s_text[prefix][tx]) ++prefix;

  float jaro = 0.0f;
  if (matches != 0 && l1 != 0 && l2 != 0) {
    const float m = (float)matches;
    const float n1 = fmaxf((float)l1, 1.0f);
    const float n2 = fmaxf((float)l2, 1.0f);
    const float half_trans = (float)(trans / 2);
    const float sum = __fadd_rn(
        __fadd_rn(__fdiv_rn(m, n1), __fdiv_rn(m, n2)),
        __fdiv_rn(__fsub_rn(m, half_trans), fmaxf(m, 1.0f)));
    jaro = __fdiv_rn(sum, 3.0f);
  }
  const float boosted = __fadd_rn(
      jaro, __fmul_rn(__fmul_rn((float)prefix, prefix_scale),
                      __fsub_rn(1.0f, jaro)));
  out[(int64_t)q * C + c] = jaro < boost_threshold ? jaro : boosted;
}

}  // namespace

extern "C" int jw_tiles(const int32_t* qchars, const int32_t* qlen,
                        const int32_t* cchars, const int32_t* clen,
                        float* out, int Q, int C, int L, int max_prefix,
                        float prefix_scale, float boost_threshold,
                        cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || L <= 0 || L > kMaxL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTileC, kTileQ);
  const dim3 grid((C + kTileC - 1) / kTileC, (Q + kTileQ - 1) / kTileQ);
  jw_tile_kernel<<<grid, block, 0, stream>>>(
      qchars, qlen, cchars, clen, out, Q, C, L, max_prefix, prefix_scale,
      boost_threshold);
  return (int)cudaGetLastError();
}
