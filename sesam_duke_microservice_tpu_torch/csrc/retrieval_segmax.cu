// The ann backend's fused retrieval for Hopper: bf16 cosine product,
// candidate mask and strided segment max / argmax in one pass.
//
// Replaces the JAX package's Pallas TPU kernel
//   sesam_duke_microservice_tpu/ops/pallas_kernels.py
//     _retrieval_segmax_kernel  (:798, pallas_call in retrieval_segmax :868)
// It computes, per query q and per bin b, the largest masked score
//   score[r, q] = sum_d c[r, d] * q[q, d]   (bf16 values, f32 sums)
// over the bin's rows and the smallest row reaching it.  Bins are strided
// within each tile of tc rows: bin i*(tc/seg) + j holds rows
// i*tc + j + k*(tc/seg), k < seg, so adjacent rows (a batch's duplicates)
// fall in different bins.  A row is a candidate when valid, not deleted,
// not the query's own row and, with group filtering, of another group
// (groups clipped to [-1, 100] on both sides, as the TPU kernel's int8
// encoding does); other scores are -3.0e38.  The output is query-major,
// (Q, N/seg) f32 + int32, so no transpose follows.
//
// Design.  A block owns 64 queries x 64 consecutive bins and walks the seg
// rows of its bins in order (k = 0 .. seg-1).  Per step it stages the 64
// bins' rows and the 64 queries, 128 dims at a time, in shared memory and
// multiplies them with bf16 wmma fragments (16 x 16 x 16, f32 accumulate;
// 8 warps, two 16 x 16 output fragments each).  The 64 x 64 score tile then
// goes through shared memory to the reduction: each thread owns one bin and
// 16 queries and keeps their running max and argmax in registers.  Rows
// grow with k, so a strict ">" keeps the smallest row among equal maxima.
// The query tile is re-staged at every step: simple, at the price of
// reading it from L2 seg times.
//
// Bound.  2 N D Q operations on the tensor cores (5.5e11 at Q = 2048,
// N = 524,288, D = 256) against about 0.3 GB of inputs and the (Q, N/seg)
// outputs: compute bound on the card, at ~0.55 ms for the bf16 dense peak.
// This first version leaves the card's asynchronous copies (TMA, cp.async)
// and wgmma unused; the synchronous staging and the per-step reduction
// through shared memory bound it well above that.
//
// Returns cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTQ = 64;        // queries per block
constexpr int kTB = 64;        // bins per block
constexpr int kDC = 128;       // embedding dims staged per pass
constexpr int kPad = 8;        // bf16 row padding (16 bytes): no conflicts
constexpr int kThreads = 256;  // 8 warps
constexpr int kPerThread = kTQ * kTB / kThreads;  // 16 (query, bin) cells
constexpr float kNeg = -3.0e38f;

// bf16 bit patterns, read through __nv_bfloat16 pointers by wmma
struct Staged {
  uint16_t q[kTQ][kDC + kPad];
  uint16_t c[kTB][kDC + kPad];
};

// the staged operands and the score tile are never live at once
union Shared {
  Staged in;
  float s[kTQ][kTB + 4];
};

__device__ __forceinline__ int clip_group(int g) {
  return min(max(g, -1), 100);
}

// corpus row of bin g at step k (bins = tc / seg per tile)
__device__ __forceinline__ int bin_row(int g, int k, int tc, int bins) {
  return (g / bins) * tc + (g % bins) + k * bins;
}

__device__ __forceinline__ const __nv_bfloat16* as_bf16(const uint16_t* p) {
  return reinterpret_cast<const __nv_bfloat16*>(p);
}

__global__ void __launch_bounds__(kThreads)
retrieval_segmax_kernel(const __nv_bfloat16* __restrict__ qemb,
                        const __nv_bfloat16* __restrict__ corpus,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ deleted,
                        const int32_t* __restrict__ group,
                        const int32_t* __restrict__ qrow,
                        const int32_t* __restrict__ qgroup,
                        float* __restrict__ seg_max,
                        int32_t* __restrict__ seg_arg, int Q, int N, int D,
                        int tc, int seg, int group_filtering) {
  __shared__ __align__(128) Shared sm;
  __shared__ int s_qrow[kTQ];
  __shared__ int s_qgroup[kTQ];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int nbins = N / seg;
  const int bins = tc / seg;
  const int g0 = blockIdx.x * kTB;
  const int q0 = blockIdx.y * kTQ;

  if (tid < kTQ) {
    const int q = q0 + tid;
    s_qrow[tid] = q < Q ? qrow[q] : -1;
    s_qgroup[tid] = q < Q ? clip_group(qgroup[q]) : -1;
  }

  // this thread's cells: bin column cb, queries cq + 4 i
  const int cb = tid % kTB;
  const int cq = tid / kTB;
  const int g = g0 + cb;
  const bool gvalid = g < nbins;
  float best[kPerThread];
  int arg[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    best[i] = __int_as_float((int)0xff800000);  // -inf: the first row wins
    arg[i] = 0;
  }

  // the warp's output fragments: queries 16 wq.., bins 32 wb + 16 j
  const int wq = warp / 2;
  const int wb = warp % 2;
  // staging: 16 uint4 (8 bf16 each) per 128-dim row, 4 per thread per side
  constexpr int kVecPerRow = kDC / 8;

  for (int k = 0; k < seg; ++k) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // the previous pass (or reduction) is done
      for (int e = tid; e < kTQ * kVecPerRow; e += kThreads) {
        const int r = e / kVecPerRow;
        const int col = (e % kVecPerRow) * 8;
        const int q = q0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (q < Q) {
          v = *reinterpret_cast<const uint4*>(qemb + (int64_t)q * D + d0 +
                                              col);
        }
        *reinterpret_cast<uint4*>(&sm.in.q[r][col]) = v;
      }
      for (int e = tid; e < kTB * kVecPerRow; e += kThreads) {
        const int r = e / kVecPerRow;
        const int col = (e % kVecPerRow) * 8;
        const int gb = g0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gb < nbins) {
          const int64_t row = bin_row(gb, k, tc, bins);
          v = *reinterpret_cast<const uint4*>(corpus + row * D + d0 + col);
        }
        *reinterpret_cast<uint4*>(&sm.in.c[r][col]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, as_bf16(&sm.in.q[wq * 16][kk]),
                               kDC + kPad);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // B (dims x bins) is the staged (bins x dims) tile, column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(
              b, as_bf16(&sm.in.c[wb * 32 + j * 16][kk]), kDC + kPad);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();  // every warp is done reading the staged operands
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&sm.s[wq * 16][wb * 32 + j * 16], acc[j],
                              kTB + 4, wmma::mem_row_major);
    }
    __syncthreads();

    if (gvalid) {
      const int row = bin_row(g, k, tc, bins);
      const bool live = valid[row] != 0 && deleted[row] == 0;
      const int cg = clip_group(group[row]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int ql = cq + 4 * i;
        bool ok = live && s_qrow[ql] != row;
        if (group_filtering) ok = ok && cg != s_qgroup[ql];
        const float v = ok ? sm.s[ql][cb] : kNeg;
        if (v > best[i]) {
          best[i] = v;
          arg[i] = row;
        }
      }
    }
  }

  if (gvalid) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int q = q0 + cq + 4 * i;
      if (q < Q) {
        seg_max[(int64_t)q * nbins + g] = best[i];
        seg_arg[(int64_t)q * nbins + g] = arg[i];
      }
    }
  }
}

}  // namespace

extern "C" int retrieval_segmax(const void* qemb, const void* corpus,
                                const uint8_t* valid, const uint8_t* deleted,
                                const int32_t* group, const int32_t* qrow,
                                const int32_t* qgroup, float* seg_max,
                                int32_t* seg_arg, int Q, int N, int D, int tc,
                                int seg, int group_filtering,
                                cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D % kDC != 0 || seg <= 0 || tc <= 0 ||
      tc % seg != 0 || N % tc != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nbins = N / seg;
  const dim3 grid((nbins + kTB - 1) / kTB, (Q + kTQ - 1) / kTQ);
  retrieval_segmax_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qemb),
      static_cast<const __nv_bfloat16*>(corpus), valid, deleted, group, qrow,
      qgroup, seg_max, seg_arg, Q, N, D, tc, seg, group_filtering);
  return (int)cudaGetLastError();
}
