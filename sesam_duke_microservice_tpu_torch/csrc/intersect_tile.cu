// All-pairs |A ∩ B| of hashed q-gram / token sets, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _intersect_tile_kernel  (:653, pallas_call in _intersect_tiles_padded
//                              :700, entries set_intersection_tiles :712 and
//                              set_sim_tiles :733)
// for sets of at most 256 ids.  It computes what that kernel computes --
// the number of ids among the first qn of query q's row equal to one of the
// first cn of corpus row c's -- not a copy of its layout.  Entries past n
// are never read, so garbage padding cannot count; the rows need not be
// sorted, and a repeated id counts once per (query entry, corpus entry)
// pair, as the plain version counts it.
//
// Design.  Each corpus id is looked up in a hash table of each query's ids
// instead of merged against them.
//   * Tables.  Per query, S slots in shared memory (S the power of two at
//     or above 4 G up to G = 128, 2 G above; at least 128), built once per
//     block by the warp that owns the query, its 4 queries' tables in one
//     pass: each id goes to the first free slot from its home slot on
//     (linear probing, slots claimed with a shared atomicOr on an
//     occupancy bitmask), home = the top log2 S bits of id * 0x9E3779B1
//     (ids need not have spread-out low bits).  D, the largest distance of
//     an id from its home, is at most qn - 1 < S / 2.
//   * No value means "empty": every int32 is a legal id (0x7FFFFFFF =
//     SET_PAD and 0x80000000 too).  A lookup of x reads the slots home(x)
//     .. home(x) + D (mod S) and counts the ids there equal to x, so every
//     query entry equal to x is counted once.  A free slot s holds the id
//     whose home is s + S/2: if x equals it, x's window starts S/2 > D
//     slots past s and never reaches it.
//   * Work.  A block holds 8 warps of 4 queries each and 128 corpus rows
//     (4 tiles of 32), staged transposed in shared memory; each warp walks
//     the 4 tiles in turn, one row per lane.  A lane loads each of its
//     row's cn ids once, hashes it once and probes its warp's 4 tables
//     with it, over the warp's largest D + 1 slots (a uniform count, so
//     no lane waits on another's probe chain; the common windows of 1 to
//     4 slots are unrolled).  The warp's 4 tables are laid out slot-major,
//     so one 16-byte shared load reads a slot of all 4: the lanes' slots
//     are random, and a load's cost is its bank conflicts.  A pair costs
//     cn probes instead of qn + cn dependent merge steps, and the probes
//     of consecutive ids are independent.
//   * A counting sort orders the block's rows by cn before staging, so
//     each tile's 32 lanes walk sets of about one size.
//   * Latency.  A block moves little data for its work, so its loads are
//     issued together: the set sizes and the warp's query ids (held in
//     registers until the tables are built) first, then the corpus tile
//     as a flat run of 16-byte loads, a batch of 8 a thread in flight.
//     The counts go back to the rows' own order through shared memory, so
//     each query's 128 outputs are written as consecutive words.
// The similarity map stays in torch (ops/pairwise.py).
//
// Bound.  chip_smoke.py's INTERSECT_OPS_PER_PROBE: the fewest int32
// instructions are min(qn, cn) probes a pair (the smaller set's ids in the
// larger set's table), a compare and a count each; this kernel probes the
// corpus row's cn ids over its window.  The output is one int32 per pair
// and the inputs O((Q + C) G), so the bound is the int32 ALU rate.
//
// Shared memory: the corpus tile (G x 129 ids) and 32 tables of S slots:
// 24.9 KB at G = 16, 66.0 KB at G = 64, 198 KB at G = 256.  The limit is
// raised past 48 KB once per instance (kPer, the ids of a query a lane
// holds), to its largest launch.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kLanes = 32;
constexpr int kQueries = 4;        // queries per warp
constexpr int kTiles = 4;          // corpus tiles of 32 rows per block
constexpr int kRows = kLanes * kTiles;
constexpr int kStride = kRows + 1;
constexpr int kMaxG = 256;         // widest set
constexpr int kMinSlots = 128;     // 4 x 128 words: the warp's outputs
constexpr int kMaxSlots = 2 * kMaxG;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr uint32_t kMul = 0x9E3779B1u;  // odd, so invertible mod 2^32
constexpr uint32_t inverse(uint32_t a) {
  uint32_t x = a;  // right to 3 bits; each step doubles them
  for (int i = 0; i < 5; ++i) x *= 2u - a * x;
  return x;
}
constexpr uint32_t kMulInv = inverse(kMul);
static_assert(kMul * kMulInv == 1u, "kMulInv inverts kMul");

// the home slot of an id in a table of 2^(32 - shift) slots
__device__ __forceinline__ uint32_t home(uint32_t id, int shift) {
  return (id * kMul) >> shift;
}

// an id whose home slot is t
__device__ __forceinline__ uint32_t id_at_home(uint32_t t, int shift) {
  return (t << shift) * kMulInv;
}

// slots a query's table holds: the power of two at or above 4 G (a load of
// at most 1/4, so most ids sit at their home slot), at least kMinSlots;
// above 128 ids only 2 G, within shared memory
int slots_for(int g) {
  int s = kMinSlots;
  while (s < 4 * g && s < kMaxSlots) s *= 2;
  while (s < 2 * g) s *= 2;
  return s;
}

// 32-bit words of the corpus tile, rounded up to a 16-byte multiple
__host__ __device__ __forceinline__ int tile_words(int g) {
  return (g * kStride + 3) & ~3;
}

// Build the warp's kQueries tables from its queries' first n[k] ids, held
// kPer a lane (id i * 32 + lane of query k in ids[k][i]; the whole warp):
// slot s of query k is tabs[s * kQueries + k], and its occupancy bit is in
// occ[(s / 32) * kQueries + k].  The inserts of all four queries are in
// flight together, and one 16-byte store fills slot s of all four.
// Returns the warp's window: the largest D + 1.
template <int kPer>
__device__ __forceinline__ int build_tables(
    uint32_t* tabs, uint32_t* occ, const int32_t (&ids)[kQueries][kPer],
    const int (&n)[kQueries], int S, int shift, int lane) {
  const uint32_t mask = (uint32_t)S - 1u;
  for (int w = lane; w < (S / 32) * kQueries; w += kLanes) occ[w] = 0u;
  __syncwarp();
  int dmax = 0;
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i * kLanes + lane < n[k]) {
        const uint32_t x = (uint32_t)ids[k][i];
        const uint32_t h = home(x, shift);
        uint32_t s = h;
        while (atomicOr(&occ[(s >> 5) * kQueries + k], 1u << (s & 31)) &
               (1u << (s & 31))) {
          s = (s + 1u) & mask;
        }
        tabs[s * kQueries + k] = x;
        dmax = max(dmax, (int)((s - h) & mask));
      }
    }
  }
  __syncwarp();
  uint4* tabs4 = reinterpret_cast<uint4*>(tabs);
  const uint4* occ4 = reinterpret_cast<const uint4*>(occ);
  for (int s = lane; s < S; s += kLanes) {
    const uint4 o = occ4[s >> 5];
    const uint32_t bit = 1u << (s & 31);
    const uint32_t fill =
        id_at_home(((uint32_t)s + (uint32_t)S / 2u) & mask, shift);
    uint4 t = tabs4[s];
    if (!(o.x & bit)) t.x = fill;
    if (!(o.y & bit)) t.y = fill;
    if (!(o.z & bit)) t.z = fill;
    if (!(o.w & bit)) t.w = fill;
    tabs4[s] = t;
  }
  const int window = __reduce_max_sync(kFull, dmax) + 1;
  __syncwarp();
  return window;
}

// Count x in slot s of the warp's four tables: the 16 bytes tabs[s].
__device__ __forceinline__ void probe_slot(const uint4* tabs, uint32_t s,
                                           uint32_t x,
                                           int (&cnt)[kQueries]) {
  const uint4 t = tabs[s];
  cnt[0] += t.x == x;
  cnt[1] += t.y == x;
  cnt[2] += t.z == x;
  cnt[3] += t.w == x;
}

// Count, for each of the warp's queries, the ids of one corpus row (nb ids
// down column `col`) found in its table, reading kWindow slots from each
// id's home (kWindow = 0: the run-time count `window`).
template <int kWindow>
__device__ __forceinline__ void probe_row(const int32_t* col, int nb,
                                          const uint4* tabs, int S,
                                          int shift, int window,
                                          int (&cnt)[kQueries]) {
  const uint32_t mask = (uint32_t)S - 1u;
#pragma unroll 2
  for (int j = 0; j < nb; ++j) {
    const uint32_t x = (uint32_t)col[j * kStride];
    const uint32_t h = home(x, shift);
    if constexpr (kWindow > 0) {
#pragma unroll
      for (int d = 0; d < kWindow; ++d) {
        probe_slot(tabs, (h + d) & mask, x, cnt);
      }
    } else {
      for (int d = 0; d < window; ++d) {
        probe_slot(tabs, (h + d) & mask, x, cnt);
      }
    }
  }
}

// Stage the block's corpus rows into the transposed tile, row i of the
// block (c0 + i) into column s_pos[i], only its first s_n[i] ids: 16-byte
// loads where the rows allow (kVec = 4), each thread's kBatch loads in
// flight together.
template <int kVec>
__device__ __forceinline__ void stage_tile(int32_t* s_c, const int* s_pos,
                                           const int* s_n,
                                           const int32_t* cgrams, int c0,
                                           int C, int G, int tid) {
  constexpr int kBatch = 8;
  constexpr int kThreads = kWarps * kLanes;
  const int per_row = G / kVec;
  const int total = min(kRows, C - c0) * per_row;
  const int32_t* src = cgrams + (int64_t)c0 * G;
  for (int e0 = 0; e0 < total; e0 += kBatch * kThreads) {
    int32_t v[kBatch][kVec];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kThreads + tid;
      const int i = e / per_row;
      const int col = (e - i * per_row) * kVec;
      if (e < total && col < s_n[i]) {
        if constexpr (kVec == 4) {
          const int4 w = reinterpret_cast<const int4*>(src)[e];
          v[b][0] = w.x;
          v[b][1] = w.y;
          v[b][2] = w.z;
          v[b][3] = w.w;
        } else {
          v[b][0] = src[e];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kThreads + tid;
      const int i = e / per_row;
      const int col = (e - i * per_row) * kVec;
      if (e < total && col < s_n[i]) {
#pragma unroll
        for (int m = 0; m < kVec; ++m) {
          s_c[(col + m) * kStride + s_pos[i]] = v[b][m];
        }
      }
    }
  }
}

// kPer: ids a lane holds of one query, G <= 32 kPer
template <int kPer>
__global__ void __launch_bounds__(kWarps * kLanes)
intersect_tile_kernel(const int32_t* __restrict__ qgrams,
                      const int32_t* __restrict__ qn,
                      const int32_t* __restrict__ cgrams,
                      const int32_t* __restrict__ cn,
                      int32_t* __restrict__ out, int Q, int C, int G, int S,
                      int shift) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_c = smem;                                      // [G][kStride]
  uint32_t* tables =                                        // 16-byte aligned
      reinterpret_cast<uint32_t*>(smem + tile_words(G));
  uint32_t* occ = tables + kWarps * kQueries * S;  // [kWarps][S/32][kQueries]
  static_assert(kQueries == 4, "a slot of the warp's tables is one uint4");
  __shared__ int s_len[kRows];  // tile column -> its row's set size
  __shared__ int s_pos[kRows];  // row of the block -> tile column
  __shared__ int s_n[kRows];    // row of the block -> its set size
  __shared__ int s_count[kMaxG + 1];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int q0 = (blockIdx.y * kWarps + warp) * kQueries;  // warp's queries
  const int c0 = blockIdx.x * kRows;

  // the loads that need nothing else first, in flight together: the
  // block's set sizes, the warp's queries' sizes and ids
  int len = 0;
  if (tid < kRows && c0 + tid < C) len = min(max(cn[c0 + tid], 0), G);
  int nq[kQueries];
  int32_t qids[kQueries][kPer];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int q = q0 + k;
    nq[k] = q < Q ? min(max(qn[q], 0), G) : 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = i * kLanes + lane;
      qids[k][i] = q < Q && j < G ? qgrams[(int64_t)q * G + j] : 0;
    }
  }

  // order the block's rows by set size, so that the 32 lanes of each tile
  // walk sets of about one size: a counting sort (the order among rows of
  // one size is free, as each row's result goes to its own column)
  for (int k = tid; k <= G; k += kWarps * kLanes) s_count[k] = 0;
  __syncthreads();
  int pos = 0;
  if (tid < kRows) pos = atomicAdd(&s_count[len], 1);
  __syncthreads();
  if (warp == 0) {  // exclusive prefix sum over the G + 1 counts
    int base = 0;
    for (int k0 = 0; k0 <= G; k0 += kLanes) {
      const int k = k0 + lane;
      const int n = k <= G ? s_count[k] : 0;
      int incl = n;
      for (int o = 1; o < kLanes; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (k <= G) s_count[k] = base + incl - n;
      base += __shfl_sync(kFull, incl, kLanes - 1);
    }
  }
  __syncthreads();
  if (tid < kRows) {
    const int at = s_count[len] + pos;  // the row's place in size order
    s_len[at] = len;
    s_pos[tid] = at;
    s_n[tid] = len;
  }
  __syncthreads();

  // the corpus tile, transposed, in that order
  const bool vec = G % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(cgrams) & 15) == 0;
  if (vec) {
    stage_tile<4>(s_c, s_pos, s_n, cgrams, c0, C, G, tid);
  } else {
    stage_tile<1>(s_c, s_pos, s_n, cgrams, c0, C, G, tid);
  }

  // the warp's tables, slot-major ([S][kQueries]), and the window every
  // lookup of this warp reads
  uint32_t* tabs = tables + warp * kQueries * S;
  const int window = build_tables<kPer>(
      tabs, occ + warp * kQueries * (S / 32), qids, nq, S, shift, lane);
  __syncthreads();

  const uint4* tabs4 = reinterpret_cast<const uint4*>(tabs);
  int cnt[kTiles][kQueries];
#pragma unroll
  for (int tile = 0; tile < kTiles; ++tile) {
    const int r = tile * kLanes + lane;
    const int nb = s_len[r];
#pragma unroll
    for (int k = 0; k < kQueries; ++k) cnt[tile][k] = 0;
    // the common windows unrolled: through the run-time loop alone
    // (myers_ab.py's "window0") the kernel took 12-40% longer on an H100
    switch (window) {
      case 1:
        probe_row<1>(s_c + r, nb, tabs4, S, shift, window, cnt[tile]);
        break;
      case 2:
        probe_row<2>(s_c + r, nb, tabs4, S, shift, window, cnt[tile]);
        break;
      case 3:
        probe_row<3>(s_c + r, nb, tabs4, S, shift, window, cnt[tile]);
        break;
      case 4:
        probe_row<4>(s_c + r, nb, tabs4, S, shift, window, cnt[tile]);
        break;
      default:
        probe_row<0>(s_c + r, nb, tabs4, S, shift, window, cnt[tile]);
    }
  }

  // the counts back in the rows' own order through the warp's tables
  // (4 x 128 words, no longer read), so that each query's 128 outputs are
  // written as consecutive words
  __syncwarp();
  int32_t* s_out = reinterpret_cast<int32_t*>(tabs);        // [kQueries][kRows]
#pragma unroll
  for (int tile = 0; tile < kTiles; ++tile) {
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      s_out[k * kRows + tile * kLanes + lane] = cnt[tile][k];
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    if (q0 + k >= Q) break;
#pragma unroll
    for (int i = lane; i < kRows; i += kLanes) {
      if (c0 + i < C) {
        out[(int64_t)(q0 + k) * C + c0 + i] = s_out[k * kRows + s_pos[i]];
      }
    }
  }
}

size_t shmem_bytes(int g, int s) {
  return sizeof(int32_t) *
         ((size_t)tile_words(g) + (size_t)kWarps * kQueries * s +
          (size_t)kWarps * kQueries * (s / 32));
}

template <int kPer>
cudaError_t launch(const int32_t* qgrams, const int32_t* qn,
                   const int32_t* cgrams, const int32_t* cn, int32_t* out,
                   int Q, int C, int G, cudaStream_t stream) {
  // once per instance (and process), for the current device: allow its
  // largest launch, at G = 32 kPer
  static const cudaError_t limit = cudaFuncSetAttribute(
      intersect_tile_kernel<kPer>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem_bytes(32 * kPer, slots_for(32 * kPer)));
  if (limit != cudaSuccess) return limit;
  const int s = slots_for(G);
  int shift = 32;
  for (int v = s; v > 1; v >>= 1) --shift;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((C + kRows - 1) / kRows,
                  (Q + kWarps * kQueries - 1) / (kWarps * kQueries));
  intersect_tile_kernel<kPer><<<grid, block, shmem_bytes(G, s), stream>>>(
      qgrams, qn, cgrams, cn, out, Q, C, G, s, shift);
  return cudaGetLastError();
}

}  // namespace

extern "C" int intersect_tiles(const int32_t* qgrams, const int32_t* qn,
                               const int32_t* cgrams, const int32_t* cn,
                               int32_t* out, int Q, int C, int G,
                               cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || G <= 0 || G > kMaxG) {
    return (int)cudaErrorInvalidValue;
  }
  if (G <= 32) {
    return (int)launch<1>(qgrams, qn, cgrams, cn, out, Q, C, G, stream);
  }
  if (G <= 64) {
    return (int)launch<2>(qgrams, qn, cgrams, cn, out, Q, C, G, stream);
  }
  if (G <= 128) {
    return (int)launch<4>(qgrams, qn, cgrams, cn, out, Q, C, G, stream);
  }
  return (int)launch<8>(qgrams, qn, cgrams, cn, out, Q, C, G, stream);
}
