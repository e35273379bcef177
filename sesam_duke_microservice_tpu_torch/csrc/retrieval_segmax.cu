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
// Design (warp-specialised, after the hopper-kernels guide).  A block
// holds 128 queries and three warpgroups: two consumers of 64 queries each
// and one producer.
//   * The block's query tile (128 x D bf16, 64 KB at D = 256) is wgmma's
//     operand A, K-major, 128-byte swizzled, one 64-dim slab per TMA box.
//     Up to D = 512 it is loaded once by TMA and stays in shared memory for
//     the block's life; wider tiles would leave the ring fewer than
//     kMinStages stages, so each query slab then streams through the ring
//     beside the corpus slab it multiplies (served by the L2: the whole
//     query set is Q x D x 2 bytes).
//   * Corpus rows stream in chunks of BN consecutive rows (BN = 128, or 64
//     when tc/seg > 64), each as D/64 slabs of BN rows x 64 dims, loaded by
//     TMA into a ring of up to 8 stages with full / empty mbarriers.  One
//     producer thread issues the loads; a producer warp writes each chunk's
//     row caps (+inf, or -3.0e38 for an invalid or deleted row) and
//     clipped groups beside its last slab, so one fminf masks a score.  It
//     loads a chunk's mask inputs one chunk ahead: at the card's rate a
//     chunk takes about a microsecond, one global load's round trip.
//   * Each consumer warpgroup multiplies its 64 queries by the chunk:
//     wgmma m64nBNk16 (bf16 in, f32 accumulate, both operands from shared
//     memory), 4 per slab, each slab released once the next slab's products
//     are issued.  Nothing reads the accumulator inside that loop, so
//     ptxas adds no wait of its own there.
//   * The masked max / argmax folds in registers, after the chunk's last
//     wait.  A thread of the accumulator holds, for two queries, columns
//     8j + 2(lane % 4) + {0, 1} of the chunk.  Chunks are laid over bins
//     so that column c always falls in bin slot c mod G, G = min(tc/seg,
//     BN): when tc/seg <= BN a block walks a whole tc tile in order
//     (BN / (tc/seg) steps k per chunk); otherwise it walks BN consecutive
//     bins, one chunk per step k.  Every column of one bin slot then sits
//     in the same thread, which keeps G/2 running (max, argmax) pairs in
//     registers, folded in increasing row order with a strict ">" (the
//     smallest row wins a tie) -- no shared-memory round trip and no
//     shuffle.  64-row chunks above 64 bins keep G at 64, so the slots fit
//     in registers beside the accumulator.  Before the fold, the scores a
//     row cap cannot mask (another group's row with group filtering, the
//     query's own row) are set to -3.0e38 in the accumulator: the group
//     pass runs only with filtering, the own-row pass only in the chunk
//     whose columns hold that row.
//   * L2 reuse: blockIdx.x is the query tile, so the blocks in flight at
//     once (x varying fastest) walk the same corpus range, which the L2
//     then serves to all query tiles; each block takes several consecutive
//     (tile, bin group) units, at least 4,096 rows unless that leaves SMs
//     idle, so its query tile is loaded once for that many.
//
// Bound.  2 N D Q operations on the tensor cores (5.5e11 at Q = 2048,
// N = 524,288, D = 256) against about 0.3 GB of inputs and the (Q, N/seg)
// outputs: compute bound on the card, at ~0.51 ms for the bf16 dense peak.
// Shared memory carries the rest: per 64 x 128 x 16 product wgmma reads
// 6 KB of operands, and TMA writes each corpus slab once, about 128 bytes
// a clock per SM at the tensor cores' full rate, the SM's whole shared
// memory bandwidth.
//
// Takes tc and seg powers of two with tc / seg >= 8 and tc >= 128 (the
// fused route's gate gives tc >= max(1024, 8 seg)), and D a multiple of
// 64; returns cudaErrorInvalidValue for anything else (the wrapper raises
// first), else cudaGetLastError() after the launch.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                    // queries per consumer warpgroup
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kTQ = kBM * kConsumers;      // queries per block
constexpr int kBK = 64;                    // dims per slab (128 bytes)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSlabQ = kTQ * kBK * 2;      // bytes of a query slab
constexpr int kMaxStages = 8;
constexpr int kMinStages = 4;              // else the query tile streams
constexpr int kSmemLimit = 232448;         // 227 KB a block can use
constexpr int kMinRows = 4096;             // corpus rows a block, at least
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ int clip_group(int g) {
  return min(max(g, -1), 100);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 2-D TMA box {x (dims), y (rows)} of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major, 128-byte swizzled operand at shared
// address addr: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A (64 x 16, K-major) * B (16 x N, K-major), f32 accumulate, N =
// 128 or 64; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a,
                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t desc_a,
                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the accumulator's registers are read only after the last wait: a
// volatile empty asm that "writes" each one keeps the compiler from moving
// the reads above it (none sits between an issue and its wait, where
// ptxas would insert a wait of its own)
template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Mask the chunk's scores that the row caps do not: with group filtering
// (gf), those of rows in the query's group; and a query's own row, which
// falls in one column of the whole corpus, where the thread's columns may
// hold it (own[h], relative to the thread's first column).  grp: the
// chunk's clipped groups at that column.
template <int BN>
__device__ __forceinline__ void mask(float (&acc)[BN / 2], const int32_t* grp,
                                     bool gf, const int (&my_group)[2],
                                     const int (&own)[2]) {
  if (gf) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 gp = *reinterpret_cast<const int2*>(grp + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((e ? gp.y : gp.x) == my_group[h]) acc[4 * j + 2 * h + e] = kNeg;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if ((unsigned)own[h] < (unsigned)BN && (own[h] & 6) == 0) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j + e == own[h]) acc[4 * j + 2 * h + e] = kNeg;
        }
      }
    }
  }
}

// Fold one chunk's scores into the running (max, argmax) of the thread's
// bin slots, in increasing row order.  cap: the chunk's row caps (+inf for
// a live row, kNeg for an invalid or deleted one) at the thread's first
// column; row_lc: that column's row.
template <int G, int BN>
__device__ __forceinline__ void fold(const float (&acc)[BN / 2],
                                     float (&best)[G / 2], int (&arg)[G / 2],
                                     const float* cap, int row_lc) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 cp = *reinterpret_cast<const float2*>(cap + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row_lc + 8 * j + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = fminf(acc[4 * j + 2 * h + e], e ? cp.y : cp.x);
        const int slot = ((j % (G / 8)) * 2 + h) * 2 + e;
        if (v > best[slot]) {
          best[slot] = v;
          arg[slot] = row;
        }
      }
    }
  }
}

// BN: corpus rows per chunk (the wgmma's N); G: bin slots per chunk,
// min(tc / seg, BN).  gf: group filtering; resident: the query tile stays
// in shared memory (else its slabs stream through the ring)
template <int G, int BN>
__global__ void __launch_bounds__(kThreads, 1)
retrieval_segmax_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap cmap,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ deleted,
                        const int32_t* __restrict__ group,
                        const int32_t* __restrict__ qrow,
                        const int32_t* __restrict__ qgroup,
                        float* __restrict__ seg_max,
                        int32_t* __restrict__ seg_arg, int Q, int D, int tc,
                        int bins, int nbins, int units, int units_per_block,
                        int stages, bool gf, bool resident) {
  constexpr int kSlots = G / 2;          // (max, argmax) pairs a thread keeps
  constexpr int kStage = BN * kBK * 2;   // bytes of a corpus slab
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte aligned destinations
  uint8_t* base =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int slabs = D / kBK;
  // a stage: a corpus slab [BN][64], then (streamed) a query slab [kTQ][64]
  const int stage_bytes = kStage + (resident ? 0 : kSlabQ);
  uint8_t* qtile = base;                          // resident: [slabs][kTQ][64]
  uint8_t* ring = base + (resident ? slabs * kSlabQ : 0);
  float* caps = reinterpret_cast<float*>(ring + stages * stage_bytes);
  int32_t* grps = reinterpret_cast<int32_t*>(caps + stages * BN);
  uint64_t* bars = reinterpret_cast<uint64_t*>(grps + stages * BN);
  const uint32_t full0 = smem_u32(bars);                // [stages]
  const uint32_t empty0 = full0 + 8 * stages;           // [stages]
  const uint32_t qbar = empty0 + 8 * stages;

  // a unit is one (tc tile, group of G-slot columns); its chunks are
  // `chunks` blocks of BN consecutive rows, `step` rows apart
  const int groups = bins / G;
  const int chunks = G == bins ? tc / BN : tc / bins;
  const int step = G == bins ? BN : bins;
  const int u0 = blockIdx.y * units_per_block;
  const int u1 = min(units, u0 + units_per_block);
  auto first_row = [&](int u, int m) {
    return (u / groups) * tc + (u % groups) * BN + m * step;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA thread + the row warp
      mbar_init(empty0 + 8 * s, kConsumers * 4);  // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == kConsumers) {
    // -- producer: one thread issues the TMA loads, one warp the row caps
    // and groups --
    if (warp > 1 || (warp == 0 && lane != 0)) return;
    if (warp == 0) {
      mbar_expect_tx(qbar, resident ? slabs * kSlabQ : 0);
      for (int k = 0; resident && k < slabs; ++k) {
        tma_load(smem_u32(qtile + k * kSlabQ), &qmap, qbar, k * kBK,
                 blockIdx.x * kTQ);
      }
    }
    // the row warp loads each chunk's valid / deleted / group one chunk
    // ahead, into registers, so the loads' latency hides behind the ring
    uint8_t ok_valid[BN / 32], ok_deleted[BN / 32];
    int ok_group[BN / 32];
    auto prefetch = [&](int u, int m) {
      const int row0 = first_row(u, m);
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int r = row0 + lane + 32 * i;
        ok_valid[i] = valid[r];
        ok_deleted[i] = deleted[r];
        ok_group[i] = group[r];
      }
    };
    if (warp == 1) prefetch(u0, 0);
    int s = 0;
    uint32_t phase = 0;
    for (int u = u0; u < u1; ++u) {
      for (int m = 0; m < chunks; ++m) {
        const int row0 = first_row(u, m);
        for (int k = 0; k < slabs; ++k) {
          mbar_wait(empty0 + 8 * s, phase ^ 1u);
          if (warp == 0) {
            uint8_t* stage = ring + s * stage_bytes;
            mbar_expect_tx(full0 + 8 * s, stage_bytes);
            tma_load(smem_u32(stage), &cmap, full0 + 8 * s, k * kBK, row0);
            if (!resident) {
              tma_load(smem_u32(stage + kStage), &qmap, full0 + 8 * s,
                       k * kBK, blockIdx.x * kTQ);
            }
          } else {
            if (k == slabs - 1) {
#pragma unroll
              for (int i = 0; i < BN / 32; ++i) {
                caps[s * BN + lane + 32 * i] =
                    ok_valid[i] != 0 && ok_deleted[i] == 0
                        ? __int_as_float(0x7f800000)  // +inf: no cap
                        : kNeg;
                grps[s * BN + lane + 32 * i] = clip_group(ok_group[i]);
              }
              if (m + 1 < chunks) {
                prefetch(u, m + 1);
              } else if (u + 1 < u1) {
                prefetch(u + 1, 0);
              }
            }
            mbar_arrive(full0 + 8 * s);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // -- consumers ------------------------------------------------------------
  const int lc = 2 * (lane % 4);  // the thread's first column of each 8
  const int qa = blockIdx.x * kTQ + wg * kBM + warp * 16 + lane / 4;
  int my_row[2], my_group[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = qa + 8 * h;
    my_row[h] = q < Q ? qrow[q] : -1;
    my_group[h] = q < Q ? clip_group(qgroup[q]) : 0;
  }
  const uint32_t wg_rows = wg * kBM * 128;  // this WG's rows in a query slab
  float acc[BN / 2] = {};
  float best[kSlots];
  int arg[kSlots];
  int s = 0, prev = 0;
  uint32_t phase = 0;
  mbar_wait(qbar, 0);

  for (int u = u0; u < u1; ++u) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      best[i] = __int_as_float((int)0xff800000);  // -inf: the first row wins
      arg[i] = 0;
    }
    for (int m = 0; m < chunks; ++m) {
      const int row0 = first_row(u, m);
      // the slab loop issues the chunk's products and nothing else reads
      // the accumulator in it (a read there would make ptxas wait for the
      // products in flight at every slab)
      for (int k = 0; k < slabs; ++k) {
        mbar_wait(full0 + 8 * s, phase);
        wgmma_fence();
        const uint32_t b = smem_u32(ring + s * stage_bytes);
        const uint32_t a =
            (resident ? smem_u32(qtile + k * kSlabQ) : b + kStage) + wg_rows;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                (k | kk) != 0);
        }
        wgmma_commit();
        if (k > 0) {  // the previous slab's products are done: free it
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_registers(acc);
      // mask and fold the chunk (its caps and groups sit beside its last
      // slab): column 8j + lc + e is row row0 + 8j + lc + e
      const int row_lc = row0 + lc;
      const int own[2] = {my_row[0] - row_lc, my_row[1] - row_lc};
      mask<BN>(acc, grps + prev * BN + lc, gf, my_group, own);
      fold<G, BN>(acc, best, arg, caps + prev * BN + lc, row_lc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    }
    // bin slot 8 jj + lc + e of this unit
    const int bin0 = (u / groups) * bins + (u % groups) * BN + lc;
#pragma unroll
    for (int jj = 0; jj < G / 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qa + 8 * h;
        if (q < Q) {
          const int slot = (jj * 2 + h) * 2;
          const int64_t at = (int64_t)q * nbins + bin0 + 8 * jj;
          *reinterpret_cast<float2*>(seg_max + at) =
              make_float2(best[slot], best[slot + 1]);
          *reinterpret_cast<int2*>(seg_arg + at) =
              make_int2(arg[slot], arg[slot + 1]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (rows, D) row-major bf16 matrix in boxes of box_rows x 64 dims,
// 128-byte swizzled; rows past the end read as zeros
bool encode(CUtensorMap* map, const void* ptr, int rows, int D,
            int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <int G, int BN>
cudaError_t launch(const void* qemb, const void* corpus, const uint8_t* valid,
                   const uint8_t* deleted, const int32_t* group,
                   const int32_t* qrow, const int32_t* qgroup, float* seg_max,
                   int32_t* seg_arg, int Q, int N, int D, int tc, int seg,
                   bool gf, cudaStream_t stream) {
  // once per instance (and process), for the current device
  static const cudaError_t limit = cudaFuncSetAttribute(
      retrieval_segmax_kernel<G, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (limit != cudaSuccess) return limit;
  CUtensorMap qmap, cmap;
  if (!encode(&qmap, qemb, Q, D, kTQ) || !encode(&cmap, corpus, N, D, BN)) {
    return cudaErrorInvalidValue;
  }
  const int bins = tc / seg;
  const int tile = D / kBK * kSlabQ;  // bytes of the block's query tile
  // a corpus slab, its caps and groups, its two barriers
  const int corpus_stage = BN * kBK * 2 + BN * 8 + 16;
  // + the alignment slack and the query barrier
  const bool resident = 1024 + 8 + tile + kMinStages * corpus_stage <=
                        kSmemLimit;
  const int fixed = 1024 + 8 + (resident ? tile : 0);
  const int per_stage = corpus_stage + (resident ? 0 : kSlabQ);
  const int stages = min(kMaxStages, (kSmemLimit - fixed) / per_stage);
  // once per process: the blocks that fill the card
  static const int sms = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return max(count, 1);
  }();
  const int chunks = G == bins ? tc / BN : seg;
  const int units = (N / tc) * (bins / G);
  const int qtiles = (Q + kTQ - 1) / kTQ;
  // at least kMinRows rows a block, unless that leaves SMs idle
  const int per_block = max(
      1, min((kMinRows / BN + chunks - 1) / chunks, units * qtiles / sms));
  const dim3 grid(qtiles, (units + per_block - 1) / per_block);
  retrieval_segmax_kernel<G, BN>
      <<<grid, kThreads, fixed + stages * per_stage, stream>>>(
          qmap, cmap, valid, deleted, group, qrow, qgroup, seg_max, seg_arg,
          Q, D, tc, bins, N / seg, units, per_block, stages, gf, resident);
  return cudaGetLastError();
}

}  // namespace

extern "C" int retrieval_segmax(const void* qemb, const void* corpus,
                                const uint8_t* valid, const uint8_t* deleted,
                                const int32_t* group, const int32_t* qrow,
                                const int32_t* qgroup, float* seg_max,
                                int32_t* seg_arg, int Q, int N, int D, int tc,
                                int seg, int group_filtering,
                                cudaStream_t stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D % kBK != 0 || !pow2(tc) ||
      !pow2(seg) || tc < 128 || tc / seg < 8 || N % tc != 0) {
    return (int)cudaErrorInvalidValue;
  }
#define SEGMAX_LAUNCH(G, BN)                                                  \
  launch<G, BN>(qemb, corpus, valid, deleted, group, qrow, qgroup, seg_max,  \
                seg_arg, Q, N, D, tc, seg, group_filtering != 0, stream)
  // up to 64 bins a tile: chunks of 128 rows walk the tile; more: chunks
  // of 64 rows walk 64 consecutive bins, so a thread keeps 32 slots
  switch (tc / seg) {
    case 8:
      return (int)SEGMAX_LAUNCH(8, 128);
    case 16:
      return (int)SEGMAX_LAUNCH(16, 128);
    case 32:
      return (int)SEGMAX_LAUNCH(32, 128);
    case 64:
      return (int)SEGMAX_LAUNCH(64, 128);
    default:
      return (int)SEGMAX_LAUNCH(64, 64);
  }
#undef SEGMAX_LAUNCH
}
