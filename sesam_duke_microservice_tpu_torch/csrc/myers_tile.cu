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
// Design.  One thread owns one corpus row and the DP of QW queries on it
// (QW = 2 at W <= 2, else 1), the W words of Pv and Mv per query in
// registers.  A block holds 8 warps of QW queries each and 32 x kTiles
// corpus rows (kTiles = 4 at W = 1, 2 at W = 2, else 1), whose text tile
// sits transposed in shared memory (lane-consecutive, conflict-free); each
// warp walks the kTiles tiles of 32 rows in turn, one row per lane.
//   * Match words come from a per-warp table of each of its queries
//     (unit_table.cuh), built once per block from the pattern's first ql
//     units (bits above the pattern's last bit never reach the score,
//     since carries and shifts only move up, so padding 0s and real
//     U+0000s inside the length stay apart).  Units below 256 index it
//     directly; pattern units of 256 and up go into a side list, usually
//     empty, that a text unit of 256 or more searches, so 'A' (0x41) never
//     matches 'Ł' (0x141).
//   * Per text step each thread loads its text unit once and, per query,
//     W table words, then runs the Hyyro step: the add (eq & Pv) + Pv as
//     one W-word add through the carry flag (PTX add.cc / addc; a plain
//     32-bit add at W = 1), the horizontal shifts as funnel shifts.  Two
//     queries give each thread two independent chains to interleave.
//   * The score is read once, after the last text step, from the last
//     column's vertical deltas: d = steps + popc(Pv) - popc(Mv) over the
//     pattern's ql bits (D[0][n] = n, plus the column's +1s and -1s), so
//     the step loop carries no score.  The lookup, the step and
//     this read live in myers_step.cuh, shared with the gathered Myers
//     kernel.
//   * Each lane steps only through its own row's text (min(cl, L) steps),
//     so a warp takes as many steps as the longest of its 32 rows.  Where
//     a block holds several tiles, a counting sort orders the block's rows
//     by that step count before the text is staged, so each tile holds
//     texts of about one length.
// Lengths are taken to lie in [0, L].  The similarity / logit math stays
// in torch, outside this kernel, so nvcc's FMA contraction never touches
// it.
//
// Bound.  The fewest int32 instructions a pair's DP needs: cl text steps
// of 10 per word -- (eq & Pv) and its add (one carry-chained add per word
// at W > 1), Xh = (sum ^ Pv) | eq, Ph = Mv | ~(Xh | Pv) and Mh = Pv & Xh
// (one three-input LOP3 each), Xv = eq | Mv, the two horizontal shifts
// (a funnel shift or shift-add each), Pv = Mh' | ~(Xv | Ph') (one LOP3)
// and Mv = Ph' & Xv.  The match word and the text unit are shared-memory
// loads, not int32 ALU work, and the score's O(W) popcounts per pair are
// left out.  The kernel writes one int32 per pair and reads O((Q + C) L)
// inputs: at the main path's shapes (Q >= 1024, C = 8192) that is tens of
// operations per output byte, above the H100's ops:bytes balance, so the
// bound is the int32 ALU rate (64 lanes per SM).  At W >= 4 a block holds
// one tile, so its rows go unsorted and lanes idle behind the longest row
// of their warp, and shared memory allows fewer warps per SM.
//
// Shared memory: the text tile (L x (32 kTiles + 1) units) plus, per
// query, the table and the side list ((256 W + L + W L) words): 36.1 KB
// at W = 1 (L 32), 60.3 KB at W = 2 (L 64), 68.5 KB at W = 4 (L 128),
// 169 KB at W = 8 (L 256).  The limit is raised past 48 KB once per W,
// to its largest launch (L = 32 W), through
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_step.cuh"
#include "unit_table.cuh"

namespace {

using unit_table::build_table;
using unit_table::words_per_query;
using myers_step::hyyro_step;
using myers_step::last_column;
using myers_step::match_words;

constexpr int kWarps = 8;   // warps per block
constexpr int kTileC = 32;  // corpus rows per tile (one per lane)
constexpr unsigned kFull = 0xFFFFFFFFu;

// corpus tiles per block: at narrow widths one table serves several tiles
template <int W>
__host__ __device__ constexpr int tiles() {
  return W == 1 ? 4 : (W == 2 ? 2 : 1);
}

// queries per warp: at narrow widths each lane walks its text through two
// queries' DPs, sharing the text loads and interleaving two chains
template <int W>
__host__ __device__ constexpr int queries_per_warp() {
  return W <= 2 ? 2 : 1;
}

// Walk one text through the DP of each of the warp's QW queries; a text
// unit of 256 or more searches each query's side list (nside entries).
template <int W, int QW, int kStride>
__device__ __forceinline__ void walk(const int32_t* text, int steps,
                                     const uint32_t* tables, int wpq, int L,
                                     const int (&nside)[QW],
                                     uint32_t (&pv)[QW][W],
                                     uint32_t (&mv)[QW][W]) {
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    const uint32_t t = (uint32_t)text[i * kStride];
#pragma unroll
    for (int k = 0; k < QW; ++k) {
      const uint32_t* peq = tables + k * wpq;
      uint32_t eq[W];
      match_words<W>(peq, t, nside[k], L, eq);
      hyyro_step<W>(eq, pv[k], mv[k]);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kWarps * kTileC)
myers_tile_kernel(const int32_t* __restrict__ qchars,
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ cchars,
                  const int32_t* __restrict__ clen,
                  int32_t* __restrict__ out, int Q, int C, int L) {
  constexpr int QW = queries_per_warp<W>();
  constexpr int kRows = kTileC * tiles<W>();
  constexpr int kStride = kRows + 1;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int wpq = (int)words_per_query<W>(L);
  int32_t* s_text = smem;                               // [L][kStride]
  uint32_t* tables = reinterpret_cast<uint32_t*>(smem + L * kStride) +
                     warp * QW * wpq;                   // QW x [wpq]

  __shared__ int s_row[kRows];  // text tile column -> row of the block
  __shared__ int s_len[kRows];  // that row's text length
  const int tid = warp * kTileC + lane;
  const int q0 = (blockIdx.y * kWarps + warp) * QW;     // the warp's queries
  const int c0 = blockIdx.x * kRows;

  // order the block's rows by their step count, min(cl, L), so that the 32
  // lanes of each tile walk texts of about one length: a counting sort
  // (the order among rows of one length is free, as each row's result goes
  // to its own column)
  if constexpr (tiles<W>() > 1) {
    __shared__ int s_count[32 * W + 1];
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
  } else if (tid < kRows) {
    s_row[tid] = tid;
    s_len[tid] = c0 + tid < C ? clen[c0 + tid] : 0;
  }
  __syncthreads();

  // stage the corpus text tile transposed, in that order (each warp some
  // rows, its lanes reading consecutive units)
  for (int r = warp; r < kRows; r += kWarps) {
    const int c = c0 + s_row[r];
    for (int col = lane; col < L; col += kTileC) {
      s_text[col * kStride + r] = c < C ? cchars[(int64_t)c * L + col] : 0;
    }
  }

  // the warp's match tables
  int ql[QW], nside[QW];
  int live = 0;
#pragma unroll
  for (int k = 0; k < QW; ++k) {
    const int q = q0 + k;
    ql[k] = q < Q ? min(max(qlen[q], 0), L) : 0;
    nside[k] = build_table<W>(tables + k * wpq, qchars + (int64_t)q * L,
                              ql[k], L, lane);
    live += ql[k] > 0;
  }
  __syncthreads();

  for (int tile = 0; tile < tiles<W>(); ++tile) {
    const int r = tile * kTileC + lane;
    const int c = c0 + s_row[r];
    const int cl = s_len[r];
    // empty patterns (or padding queries) need no DP
    const int steps = live ? min(max(cl, 0), L) : 0;
    uint32_t pv[QW][W], mv[QW][W];
#pragma unroll
    for (int k = 0; k < QW; ++k) myers_step::start<W>(ql[k], pv[k], mv[k]);
    walk<W, QW, kStride>(s_text + r, steps, tables, wpq, L, nside, pv, mv);
#pragma unroll
    for (int k = 0; k < QW; ++k) {
      const int score = last_column<W>(ql[k], steps, pv[k], mv[k]);
      if (q0 + k < Q && c < C) {
        out[(int64_t)(q0 + k) * C + c] = ql[k] == 0 ? cl : score;
      }
    }
  }
}

template <int W>
size_t shmem_bytes(int L) {
  return sizeof(int32_t) * ((size_t)L * (kTileC * tiles<W>() + 1) +
                            kWarps * queries_per_warp<W>() *
                                words_per_query<W>(L));
}

template <int W>
cudaError_t launch(const int32_t* qchars, const int32_t* qlen,
                   const int32_t* cchars, const int32_t* clen, int32_t* out,
                   int Q, int C, int L, cudaStream_t stream) {
  // once per W (and process), for the current device: allow the largest
  // launch of this W, at L = 32 W
  static const cudaError_t limit = cudaFuncSetAttribute(
      myers_tile_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem_bytes<W>(32 * W));
  if (limit != cudaSuccess) return limit;
  constexpr int rows = kTileC * tiles<W>();
  constexpr int queries = kWarps * queries_per_warp<W>();
  const dim3 block(kTileC, kWarps);
  const dim3 grid((C + rows - 1) / rows, (Q + queries - 1) / queries);
  myers_tile_kernel<W><<<grid, block, shmem_bytes<W>(L), stream>>>(
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
