// A per-query match table of UTF-16 units in shared memory, built by one
// warp: for each unit of the pattern's first plen positions, the mask of
// positions holding it, W 32-bit words wide.  Shared by the Myers tile
// kernel (W = 1, 2, 4, 8) and the Jaro-Winkler tile kernel (W = 1).
//
// Units below 256 index the table directly: 256 entries x W words,
// word-major, filled with shared atomicOr (repeated units share an entry).
// Pattern units of 256 and up (and negative ones) go, once per distinct
// unit, into a side list of (unit, W mask words), usually empty; a text
// unit of 256 or more searches it, so 'A' (0x41) never matches 'Ł'
// (0x141).  Only the first plen units go in, so padding 0s and real U+0000s
// inside the length stay apart.  Building costs O(256 W + plen) per query.
//
// Layout of one query's table (words_per_query<W>(L) 32-bit words):
//   [W][256] direct masks, [L] side-list units, [W][L] side-list masks.

#pragma once

#include <stdint.h>

namespace unit_table {

constexpr int kDirect = 256;    // units indexing the table directly
constexpr int kLanes = 32;      // a warp builds the table
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int W>
__host__ __device__ constexpr size_t words_per_query(int L) {
  return (size_t)kDirect * W + (size_t)L + (size_t)W * L;
}

// Build one query's table at `table` from its first plen units (the whole
// warp): zero it, then OR each position's bit into its unit's entry; a
// wide unit gets one side-list slot, claimed by its first position.
// Returns the side list's length.
template <int W>
__device__ __forceinline__ int build_table(uint32_t* table,
                                           const int32_t* pat, int plen,
                                           int L, int lane) {
  uint32_t* peq = table;                                       // [W][256]
  int32_t* side_unit = reinterpret_cast<int32_t*>(table + kDirect * W);
  uint32_t* side_mask = table + kDirect * W + L;               // [W][L]
  for (int k = lane; k < kDirect * W; k += kLanes) peq[k] = 0u;
  __syncwarp();
  int nside = 0;
  for (int j0 = 0; j0 < plen; j0 += kLanes) {
    const int j = j0 + lane;
    const uint32_t u = j < plen ? (uint32_t)pat[j] : 0u;
    const bool wide = j < plen && u >= (uint32_t)kDirect;
    if (j < plen && !wide) {
      atomicOr(&peq[(j >> 5) * kDirect + u], 1u << (j & 31));
    }
    bool first = wide;
    for (int k = 0; first && k < j; ++k) first = (uint32_t)pat[k] != u;
    const unsigned firsts = __ballot_sync(kFull, first);
    if (first) {
      side_unit[nside + __popc(firsts & ((1u << lane) - 1u))] = (int32_t)u;
    }
    nside += __popc(firsts);
  }
  if (nside > 0) {
    for (int k = lane; k < W * L; k += kLanes) side_mask[k] = 0u;
    __syncwarp();
    for (int j = lane; j < plen; j += kLanes) {
      const uint32_t u = (uint32_t)pat[j];
      if (u >= (uint32_t)kDirect) {
        int s = 0;
        while ((uint32_t)side_unit[s] != u) ++s;
        atomicOr(&side_mask[(j >> 5) * L + s], 1u << (j & 31));
      }
    }
  }
  return nside;
}

}  // namespace unit_table
