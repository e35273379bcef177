// All-pairs |A ∩ B| of hashed q-gram / token sets, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _intersect_tile_kernel  (:653, pallas_call in _intersect_tiles_padded
//                              :700, entries set_intersection_tiles :712 and
//                              set_sim_tiles :733)
// for sets of at most 256 ids.  It computes what that kernel computes --
// the number of ids among the first qn of query q's row equal to one of the
// first cn of corpus row c's -- not a copy of its layout.
//
// Design.  The sets are sorted ascending and distinct in their first n
// entries (ops/features.py sorts each value's folded hashes; SET_PAD =
// 2^31 - 1 sorts last), so one thread per (query, corpus) pair counts the
// intersection by a two-pointer merge over the first qn and cn entries:
// O(qn + cn) compares where the TPU kernel compares G x G, and entries past
// n are never read, so garbage padding cannot count.  The merge's body is
// branch-free (advance each side by the comparison's outcome).  A block is
// TQ x TC = 8 x 32 pairs: the warp's lanes share one query set (a shared
// memory broadcast) and walk 32 corpus sets stored transposed in shared
// memory.  The similarity map stays in torch (ops/pairwise.py).
//
// Bound.  Per pair the merge takes at most qn + cn steps of 4 int32 ALU
// operations (the compare, the count and the two advances) besides its two
// shared-memory loads; the output is one int32 per pair and the inputs
// O((Q + C) G).  At the main path's shapes (Q >= 1024, C = 8192, sets of
// ~10-60 ids) that is tens of operations per output byte, so the bound is
// the int32 ALU rate.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;     // queries per block (one per warp)
constexpr int kTileC = 32;    // corpus rows per block (one per lane)
constexpr int kMaxG = 256;    // widest set: 42 KB of shared memory

__global__ void __launch_bounds__(kTileQ * kTileC)
intersect_tile_kernel(const int32_t* __restrict__ qgrams,
                      const int32_t* __restrict__ qn,
                      const int32_t* __restrict__ cgrams,
                      const int32_t* __restrict__ cn,
                      int32_t* __restrict__ out, int Q, int C, int G) {
  extern __shared__ int32_t smem[];
  int32_t* s_c = smem;                          // [G][kTileC + 1]
  int32_t* s_q = smem + G * (kTileC + 1);       // [kTileQ][G]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileC + tx;
  const int q0 = blockIdx.y * kTileQ;
  const int c0 = blockIdx.x * kTileC;

  for (int e = tid; e < kTileC * G; e += kTileQ * kTileC) {
    const int row = e / G;
    const int col = e - row * G;
    const int c = c0 + row;
    s_c[col * (kTileC + 1) + row] = c < C ? cgrams[(int64_t)c * G + col] : 0;
  }
  for (int e = tid; e < kTileQ * G; e += kTileQ * kTileC) {
    const int row = e / G;
    const int q = q0 + row;
    s_q[e] = q < Q ? qgrams[(int64_t)q * G + (e - row * G)] : 0;
  }
  __syncthreads();

  const int q = q0 + ty;
  const int c = c0 + tx;
  if (q >= Q || c >= C) return;
  const int na = min(max(qn[q], 0), G);
  const int nb = min(max(cn[c], 0), G);
  const int32_t* a = s_q + ty * G;
  const int32_t* b = s_c + tx;
  int i = 0, j = 0, count = 0;
  while (i < na && j < nb) {
    const int32_t x = a[i];
    const int32_t y = b[j * (kTileC + 1)];
    count += x == y;
    i += x <= y;
    j += y <= x;
  }
  out[(int64_t)q * C + c] = count;
}

}  // namespace

extern "C" int intersect_tiles(const int32_t* qgrams, const int32_t* qn,
                               const int32_t* cgrams, const int32_t* cn,
                               int32_t* out, int Q, int C, int G,
                               cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || G <= 0 || G > kMaxG) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTileC, kTileQ);
  const dim3 grid((C + kTileC - 1) / kTileC, (Q + kTileQ - 1) / kTileQ);
  const size_t shmem = sizeof(int32_t) * (size_t)G * (kTileC + 1 + kTileQ);
  intersect_tile_kernel<<<grid, block, shmem, stream>>>(
      qgrams, qn, cgrams, cn, out, Q, C, G);
  return (int)cudaGetLastError();
}
