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
// Design.  One warp per query: it builds the query's match table once
// (unit_table.cuh, the table the Myers tile and Jaro-Winkler kernels use:
// units below 256 index it directly, wider ones go to a side list) and
// walks a group of 64 of its candidates, two per lane.  The group's chars
// are one contiguous (64, L) run in device memory: the warp issues all of
// its loads at once (16 bytes a lane and load where L % 4 == 0), with the
// pattern and the lengths, and stores the chars transposed in shared
// memory (lane-consecutive, conflict-free); the kernel moves little data
// per block, so it waits on load latency unless the loads overlap.
// Each lane walks its two texts together for the shorter one's steps --
// two independent chains to interleave -- and the longer one alone after
// that; per text step one table lookup (the side-list search compiled out
// when the query has no unit of 256 or more) and the one-word Hyyro step.
// The distance is read once from the last column.  The lookup, the step
// and that read are myers_step.cuh's, shared with myers_tile.cu.  The dd
// ratio, map and log stay in torch (ops/dd.py), outside this kernel.
//
// Bound.  Per pair with a non-empty pattern cl text steps of 10 int32
// instructions (myers_tile.cu's count at W = 1); the inputs are the
// (Q, K, L) candidate chars, read once, and the output one int32 per pair.
// At the main path's K = 64 and L = 32 that is 128 bytes of chars per pair
// against ~10 cl instructions, below the H100's int32 ops:bytes balance,
// so the bound is the memory rate.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_step.cuh"
#include "unit_table.cuh"

namespace {

using myers_step::hyyro_step;
using myers_step::last_column;
using myers_step::match_words;
using unit_table::build_table;
using unit_table::words_per_query;

constexpr int kWarps = 4;    // queries per block (one per warp)
constexpr int kLanes = 32;
constexpr int kGroup = 64;   // candidates per warp (two per lane)
constexpr int kStride = kGroup + 1;
constexpr int kMaxL = 32;    // one DP word per pair
constexpr int kVecPerLane = kGroup * kMaxL / 4 / kLanes;  // 16-byte loads

// Walk text a (sa steps) and text b (sb <= sa steps) through the DP of one
// query; columns of the transposed tile, kStride units apart.
template <bool kSide>
__device__ __forceinline__ void walk_two(const int32_t* ta, int sa,
                                         const int32_t* tb, int sb,
                                         const uint32_t* peq, int nside,
                                         int L, uint32_t (&pva)[1],
                                         uint32_t (&mva)[1],
                                         uint32_t (&pvb)[1],
                                         uint32_t (&mvb)[1]) {
  int i = 0;
  for (; i < sb; ++i) {
    uint32_t eqa[1], eqb[1];
    match_words<1, kSide>(peq, (uint32_t)ta[i * kStride], nside, L, eqa);
    match_words<1, kSide>(peq, (uint32_t)tb[i * kStride], nside, L, eqb);
    hyyro_step<1>(eqa, pva, mva);
    hyyro_step<1>(eqb, pvb, mvb);
  }
  for (; i < sa; ++i) {
    uint32_t eqa[1];
    match_words<1, kSide>(peq, (uint32_t)ta[i * kStride], nside, L, eqa);
    hyyro_step<1>(eqa, pva, mva);
  }
}

__global__ void __launch_bounds__(kWarps * kLanes)
myers_gathered_kernel(const int32_t* __restrict__ qchars,
                      const int32_t* __restrict__ qlen,
                      const int32_t* __restrict__ cchars,
                      const int32_t* __restrict__ clen,
                      int32_t* __restrict__ out, int Q, int K, int L) {
  __shared__ int32_t s_text[kWarps][kMaxL][kStride];
  __shared__ uint32_t s_table[kWarps][words_per_query<1>(kMaxL)];
  __shared__ int32_t s_pat[kWarps][kMaxL];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int q = blockIdx.y * kWarps + warp;
  if (q >= Q) return;  // the whole warp; the block never syncs as one
  const int k0 = blockIdx.x * kGroup;
  const int rows = min(kGroup, K - k0);
  const int64_t base = (int64_t)q * K + k0;
  const int32_t* src = cchars + base * L;

  // every global load of the warp first, so that they are in flight
  // together: the group's chars (16-byte loads where the rows allow), the
  // pattern, its length and the lane's two text lengths
  const bool vec = L % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int n4 = vec ? rows * L / 4 : 0;
  int4 v[kVecPerLane];
#pragma unroll
  for (int i = 0; i < kVecPerLane; ++i) {
    const int e4 = i * kLanes + lane;
    if (e4 < n4) v[i] = reinterpret_cast<const int4*>(src)[e4];
  }
  const int32_t pat_unit = lane < L ? qchars[(int64_t)q * L + lane] : 0;
  const int qlen_q = qlen[q];
  const bool has_a = lane < rows;
  const bool has_b = lane + kLanes < rows;
  const int cla = has_a ? clen[base + lane] : 0;
  const int clb = has_b ? clen[base + lane + kLanes] : 0;

  // the group's chars, transposed (lane-consecutive, conflict-free)
  int32_t(*text)[kStride] = s_text[warp];
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVecPerLane; ++i) {
      const int e = 4 * (i * kLanes + lane);
      if (e < 4 * n4) {
        const int r = e / L;  // L % 4 == 0: the 4 units share a row
        const int col = e - r * L;
        text[col][r] = v[i].x;
        text[col + 1][r] = v[i].y;
        text[col + 2][r] = v[i].z;
        text[col + 3][r] = v[i].w;
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      for (int col = lane; col < L; col += kLanes) {
        text[col][r] = src[r * L + col];
      }
    }
  }
  s_pat[warp][lane] = pat_unit;
  __syncwarp();
  const int ql = min(max(qlen_q, 0), L);
  uint32_t* peq = s_table[warp];
  const int nside = build_table<1>(peq, s_pat[warp], ql, L, lane);
  __syncwarp();

  // lane's candidates: columns lane and lane + 32 of the group; empty
  // patterns need no DP
  int sa = ql > 0 ? min(max(cla, 0), L) : 0;
  int sb = ql > 0 ? min(max(clb, 0), L) : 0;
  // walk the longer text as "a"
  const bool swapped = sb > sa;
  const int ra = swapped ? lane + kLanes : lane;
  if (swapped) {
    const int t = sa;
    sa = sb;
    sb = t;
  }
  uint32_t pva[1], mva[1], pvb[1], mvb[1];
  myers_step::start<1>(ql, pva, mva);
  myers_step::start<1>(ql, pvb, mvb);
  const int32_t* ta = &text[0][ra];
  const int32_t* tb = &text[0][ra ^ kLanes];  // the other column
  if (nside == 0) {
    walk_two<false>(ta, sa, tb, sb, peq, nside, L, pva, mva, pvb, mvb);
  } else {
    walk_two<true>(ta, sa, tb, sb, peq, nside, L, pva, mva, pvb, mvb);
  }
  const int da = last_column<1>(ql, sa, pva, mva);
  const int db = last_column<1>(ql, sb, pvb, mvb);
  if (has_a) out[base + lane] = ql == 0 ? cla : (swapped ? db : da);
  if (has_b) out[base + lane + kLanes] = ql == 0 ? clb : (swapped ? da : db);
}

}  // namespace

extern "C" int myers_gathered(const int32_t* qchars, const int32_t* qlen,
                              const int32_t* cchars, const int32_t* clen,
                              int32_t* out, int Q, int K, int L,
                              cudaStream_t stream) {
  if (Q <= 0 || K <= 0 || L <= 0 || L > kMaxL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kLanes, kWarps);
  const dim3 grid((K + kGroup - 1) / kGroup, (Q + kWarps - 1) / kWarps);
  myers_gathered_kernel<<<grid, block, 0, stream>>>(
      qchars, qlen, cchars, clen, out, Q, K, L);
  return (int)cudaGetLastError();
}
