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
// Design.  One thread owns one corpus row and the pairs of QW = 2 queries
// on it.  A block holds 8 warps of two queries each and 4 tiles of 32
// corpus rows, whose text sits transposed in shared memory
// (lane-consecutive, conflict-free); each warp walks the 4 tiles in turn,
// one row per lane.
//   * Each warp builds, once per block, a match table of each of its
//     queries (unit_table.cuh at W = 1): per unit, the mask of the query
//     positions holding it, from the first ql units only, so padding 0s and
//     real U+0000s inside the length stay apart; units of 256 and up go to
//     a side list that only text units of 256 and up search.
//   * Matching walks the corpus row, not the query: for each text position
//     j < cl in order, the table gives the query positions of t[j]; the
//     lowest one inside the window [j - w, j + w] (w = max(l1, l2)/2 - 1)
//     not yet matched is taken into m1, and j into m2.  This greedy order
//     gives the same m1 and m2 as the reference's, which walks the query
//     and takes the lowest unmatched text position (tests/
//     test_torch_jw_walk.py holds a model of this walk against it).  The
//     window mask slides with one shift and one or per step.
//   * Transpositions: both masks are walked lowest bit first (__ffs), and
//     the k-th matched query char is compared with the k-th matched text
//     char.  Prefix: the common prefix, up to max_prefix chars.
//   * The float tail (m/l1 + m/l2 + (m - t/2)/m) / 3 and the boost
//     j + prefix * prefix_scale * (1 - j) are evaluated in the JAX order
//     with __fdiv_rn / __fadd_rn / __fsub_rn / __fmul_rn, so nvcc's default
//     -fmad=true contracts nothing and the result equals the plain PyTorch
//     version (separate IEEE operations) bit for bit.
//   * A lane walks min(cl, L) text steps, so a warp takes as many as the
//     longest row of its tile: a counting sort orders the block's 128 rows
//     by length before the text is staged.  Results go through shared
//     memory back into column order, so each query's 128 outputs are
//     stored lane-consecutive along C.
//
// Bound.  Both greedy orders give the same matches, so the least work
// walks the shorter side: ~8 int32 operations per step of min(l1, l2) (the
// lookup's mask, the window, the and-not, the lowest bit, the two ors, the
// window slide), plus ~6 per match for the walk and 2 per prefix char.
// The output is one float per pair and the inputs O((Q + C) L): at the
// main path's shapes (Q >= 1024, C = 8192, L = 32) the bound is the int32
// ALU rate, not device memory.  This kernel walks the corpus side, cl
// steps, whichever is shorter.
//
// Shared memory: the text tile (L x 129 units), per query the table
// (256 + 2 L words) and its chars (L), and the output staging (128 floats
// per query): 47.6 KB at L = 32.  The limit is raised past 48 KB once,
// through cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "unit_table.cuh"

namespace {

using unit_table::build_table;
using unit_table::kDirect;
using unit_table::words_per_query;

constexpr int kWarps = 8;            // warps per block
constexpr int kTileC = 32;           // corpus rows per tile (one per lane)
constexpr int kTiles = 4;            // tiles per block
constexpr int kQW = 2;               // queries per warp
constexpr int kRows = kTileC * kTiles;
constexpr int kStride = kRows + 1;   // text tile row pitch
constexpr int kMaxL = 32;            // one uint32 mask per side
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t bits_below(int n) {
  // (1 << n) - 1 for n in [0, 32]; << 32 is undefined in C too
  if (n <= 0) return 0u;
  if (n >= 32) return 0xFFFFFFFFu;
  return (1u << n) - 1u;
}

// the query positions holding text unit t (a W = 1 table)
__device__ __forceinline__ uint32_t lookup(const uint32_t* table, int L,
                                           int nside, uint32_t t) {
  if (t < (uint32_t)kDirect) return table[t];
  const int32_t* side_unit = reinterpret_cast<const int32_t*>(table + kDirect);
  const uint32_t* side_mask = table + kDirect + L;
  for (int s = 0; s < nside; ++s) {
    if ((uint32_t)side_unit[s] == t) return side_mask[s];
  }
  return 0u;
}

__global__ void __launch_bounds__(kWarps * kTileC)
jw_tile_kernel(const int32_t* __restrict__ qchars,
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ cchars,
               const int32_t* __restrict__ clen,
               float* __restrict__ out, int Q, int C, int L, int max_prefix,
               float prefix_scale, float boost_threshold) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kTileC + lane;
  const int wpq = (int)words_per_query<1>(L);
  int32_t* s_text = smem;                                  // [L][kStride]
  int32_t* s_pat = smem + L * kStride + warp * kQW * L;    // [kQW][L]
  uint32_t* tables = reinterpret_cast<uint32_t*>(
      smem + L * kStride + kWarps * kQW * L) + warp * kQW * wpq;
  float* s_out = reinterpret_cast<float*>(
      smem + L * kStride + kWarps * kQW * (L + wpq)) + warp * kQW * kRows;

  __shared__ int s_row[kRows];  // text tile column -> row of the block
  __shared__ int s_len[kRows];  // that row's text length
  __shared__ int s_count[kMaxL + 1];
  const int q0 = (blockIdx.y * kWarps + warp) * kQW;    // the warp's queries
  const int c0 = blockIdx.x * kRows;

  // order the block's rows by their step count, min(cl, L), with a
  // counting sort (rows of one length in any order: each result goes back
  // to its own column)
  for (int k = tid; k <= L; k += kWarps * kTileC) s_count[k] = 0;
  __syncthreads();
  int len = 0, key = 0, pos = 0;
  if (tid < kRows) {
    len = c0 + tid < C ? clen[c0 + tid] : 0;
    key = min(max(len, 0), L);
    pos = atomicAdd(&s_count[key], 1);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sum over the L + 1 counts
    int base = 0;
    for (int k0 = 0; k0 <= L; k0 += kTileC) {
      const int k = k0 + lane;
      const int n = k <= L ? s_count[k] : 0;
      int incl = n;
      for (int o = 1; o < kTileC; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (k <= L) s_count[k] = base + incl - n;
      base += __shfl_sync(kFull, incl, kTileC - 1);
    }
  }
  __syncthreads();
  if (tid < kRows) {
    s_row[s_count[key] + pos] = tid;
    s_len[s_count[key] + pos] = len;
  }
  __syncthreads();

  // stage the corpus text tile transposed, in that order
  for (int r = warp; r < kRows; r += kWarps) {
    const int c = c0 + s_row[r];
    for (int col = lane; col < L; col += kTileC) {
      s_text[col * kStride + r] = c < C ? cchars[(int64_t)c * L + col] : 0;
    }
  }

  // the warp's queries: chars and match tables
  int l1[kQW], nside[kQW];
  int live = 0;
#pragma unroll
  for (int k = 0; k < kQW; ++k) {
    const int q = q0 + k;
    l1[k] = q < Q ? qlen[q] : 0;
    const int plen = min(max(l1[k], 0), L);
    for (int col = lane; col < L; col += kTileC) {
      s_pat[k * L + col] = q < Q ? qchars[(int64_t)q * L + col] : 0;
    }
    nside[k] = build_table<1>(tables + k * wpq, qchars + (int64_t)q * L,
                              plen, L, lane);
    live += plen > 0;
  }
  __syncthreads();

  for (int tile = 0; tile < kTiles; ++tile) {
    const int r = tile * kTileC + lane;
    const int l2 = s_len[r];
    // empty patterns (or padding queries) match nothing
    const int steps = live ? min(max(l2, 0), L) : 0;
    int window[kQW];
    uint32_t win[kQW], m1[kQW], m2[kQW];
#pragma unroll
    for (int k = 0; k < kQW; ++k) {
      window[k] = max(max(l1[k], l2) / 2 - 1, 0);
      win[k] = bits_below(window[k] + 1);    // query positions [0, w]
      m1[k] = 0u;
      m2[k] = 0u;
    }
    uint32_t jbit = 1u;
    for (int j = 0; j < steps; ++j) {
      const uint32_t t = (uint32_t)s_text[j * kStride + r];
#pragma unroll
      for (int k = 0; k < kQW; ++k) {
        const uint32_t avail =
            lookup(tables + k * wpq, L, nside[k], t) & win[k] & ~m1[k];
        const uint32_t low = avail & (0u - avail);  // lowest available bit
        m1[k] |= low;
        if (low != 0u) m2[k] |= jbit;
        // slide to [j + 1 - w, j + 1 + w], clipped at 0
        win[k] = (win[k] << 1) | (uint32_t)(j < window[k]);
      }
      jbit <<= 1;
    }

#pragma unroll
    for (int k = 0; k < kQW; ++k) {
      const int32_t* pat = s_pat + k * L;
      // transpositions: the k-th matched chars of both sides, in order
      int trans = 0;
      uint32_t a = m1[k], b = m2[k];
      while (a != 0u) {
        trans += pat[__ffs(a) - 1] != s_text[(__ffs(b) - 1) * kStride + r];
        a &= a - 1u;
        b &= b - 1u;
      }
      // Winkler common prefix
      int prefix = 0;
      const int kmax = min(min(L, max_prefix), min(l1[k], l2));
      while (prefix < kmax && pat[prefix] == s_text[prefix * kStride + r]) {
        ++prefix;
      }
      const int matches = __popc(m1[k]);
      float jaro = 0.0f;
      if (matches != 0 && l1[k] != 0 && l2 != 0) {
        const float m = (float)matches;
        const float n1 = fmaxf((float)l1[k], 1.0f);
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
      s_out[k * kRows + s_row[r]] = jaro < boost_threshold ? jaro : boosted;
    }
  }
  __syncwarp();

  // each query's results in column order, lane-consecutive along C
#pragma unroll
  for (int k = 0; k < kQW; ++k) {
    const int q = q0 + k;
    if (q >= Q) break;
    for (int col = lane; col < kRows && c0 + col < C; col += kTileC) {
      out[(int64_t)q * C + c0 + col] = s_out[k * kRows + col];
    }
  }
}

size_t shmem_bytes(int L) {
  return sizeof(int32_t) *
         ((size_t)L * kStride +
          kWarps * kQW * ((size_t)L + words_per_query<1>(L) + kRows));
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
  // once per process, for the current device: allow the largest launch
  static const cudaError_t limit = cudaFuncSetAttribute(
      jw_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem_bytes(kMaxL));
  if (limit != cudaSuccess) return (int)limit;
  const dim3 block(kTileC, kWarps);
  const dim3 grid((C + kRows - 1) / kRows,
                  (Q + kWarps * kQW - 1) / (kWarps * kQW));
  jw_tile_kernel<<<grid, block, shmem_bytes(L), stream>>>(
      qchars, qlen, cchars, clen, out, Q, C, L, max_prefix, prefix_scale,
      boost_threshold);
  return (int)cudaGetLastError();
}
