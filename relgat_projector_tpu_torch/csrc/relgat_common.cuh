// Shared device helpers of the RelGAT propagate kernels (relgat_fwd.cu,
// relgat_bwd.cu): the warp sum, a lane's share of a row, the LeakyReLU and
// the attention-dropout hash.
#pragma once

#include <math.h>

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace relgat {

// Features per lane are a template parameter so the per-warp row (F values,
// lane-strided) lives in registers. 32 covers F <= 1024 (ops/cuda/fused.py
// MAX_FEAT); the wrappers reject wider heads. Past F = 128 the ring kernels
// below take the forward and src pass at the widths where the card
// measured them faster than the one-warp-a-head template (ops/cuda/fused.py
// design_of). In both designs the sums stay in registers, since every edge
// reads and writes all of them.
constexpr int kMaxFeatPerLane = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Butterfly sum: every lane ends with the same bits, since each step adds
// the same two values (a + b == b + a in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// bf16 is the upper half of an fp32 word, so widening is a shift: exact,
// and one integer op per value.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A lane's share of an F-wide row of T (float, or bf16 widened to float):
// NV vectors of VEC values, vector i at feature VEC * (lane + 32 * i). F is
// a multiple of VEC, so a vector lies wholly inside the row or wholly past
// its end (and reads as zeros). VEC = 4 reads 16 bytes of fp32 or 8 bytes
// of bf16 a vector; the caller checks the row's alignment for that width.
template <int VEC, int NV, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         int feat, int lane,
                                         float (&v)[VEC * NV]) {
  static_assert(std::is_same_v<T, float> || std::is_same_v<T, __nv_bfloat16>,
                "rows are fp32 or bf16");
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int f = VEC * (lane + 32 * i);
    if constexpr (VEC == 4 && std::is_same_v<T, float>) {
      const float4 x = f < feat ? *reinterpret_cast<const float4*>(p + f)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    } else if constexpr (VEC == 4) {
      // element 2k sits in the low half of word k (little-endian)
      const uint2 x = f < feat ? *reinterpret_cast<const uint2*>(p + f)
                               : make_uint2(0u, 0u);
      v[4 * i] = bf16_lo(x.x);
      v[4 * i + 1] = bf16_hi(x.x);
      v[4 * i + 2] = bf16_lo(x.y);
      v[4 * i + 3] = bf16_hi(x.y);
    } else {
      v[i] = f < feat ? to_float(p[f]) : 0.f;
    }
  }
}

template <int VEC, int NV>
__device__ __forceinline__ void store_row(float* __restrict__ p, int feat,
                                          int lane,
                                          const float (&v)[VEC * NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int f = VEC * (lane + 32 * i);
    if (f >= feat) continue;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p + f) =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else {
      p[f] = v[i];
    }
  }
}

// 8 bf16 values (16 bytes) widened to fp32.
__device__ __forceinline__ void widen8(uint4 x, float (&v)[8]) {
  v[0] = bf16_lo(x.x);
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
  v[4] = bf16_lo(x.z);
  v[5] = bf16_hi(x.z);
  v[6] = bf16_lo(x.w);
  v[7] = bf16_hi(x.w);
}

__device__ __forceinline__ float leaky_relu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// ---------------------------------------------------------------------------
// The wide-head ring (relgat_fwd_ring_kernel, relgat_bwd_src_ring_kernel):
// one producer warp streams each edge's row slice into a ring of
// shared-memory stages with 1-D bulk copies (the TMA's cp.async.bulk), each
// stage with a "full" mbarrier (the copy's bytes arrive on it) and an
// "empty" one (each consumer warp arrives when it has read the stage).

// Features a lane holds at F > 128 are NK = 8, 10, 16 or 32 (F <= 256,
// 320, 512, 1024): with VW = 1, feature lane + 32 k; with VW = 2 (F even,
// rows 2-value aligned), features 2 (lane + 32 k) and the next, one 8-byte
// (fp32) or 4-byte (bf16) read, k < NK / 2. A ring block takes a group of up
// to kRingFwdGroupHeads (kRingBwdGroupHeads) heads, one consumer warp each
// (an item's or a source row's groups adjacent in the grid, so a row's
// slices are requested together): small blocks keep several rows in flight
// on an SM, each block's latency (its edge indices, its first bulk copy)
// overlapping the others'. On the card four heads a block were faster
// than two or eight; a block of all 12 heads, the first design, was slower
// than the template in the bf16 src pass at 12 x 300 (7.50 against 6.79 ms).
constexpr int kRingFwdGroupHeads = 4;
constexpr int kRingBwdGroupHeads = 4;
// Warps an SM each kernel's launch bounds ask for, by NK: they cap the
// registers at 65,536 / (32 x warps), at what each needs without spills.
template <int NK>
constexpr int ring_fwd_warps() {
  return NK <= 10 ? 35 : (NK <= 16 ? 25 : 10);
}
template <int NK>
constexpr int ring_bwd_warps() {
  return NK <= 10 ? 25 : (NK <= 16 ? 20 : 10);
}
// The bf16 src pass's factored loop (relgat_bwd.cu) holds no attn row: on
// an H100 80GB HBM3 (700 W) at 12 x 256 it took 23.5 ms at 30 warps (56
// registers) on a 10M-edge graph, 23.9 at 25, 23.7 at 35 and at 40.
template <int NK>
constexpr int ring_bwd_factored_warps() {
  return NK <= 10 ? 30 : (NK <= 16 ? 20 : 10);
}

// The kernel a forward or src pass runs over its work items, the `kernel`
// argument of the C entry points. ops/cuda/fused.py kernel_of picks one
// (ITEM_KERNELS mirrors these codes); an entry point launches the kernel it
// is handed, or returns cudaErrorInvalidValue where that kernel's
// conditions fail, and never turns one kernel into another.
// The one-warp-a-head template: any width up to 32 * kMaxFeatPerLane.
constexpr int kKernelLanes = 1;
// The ring kernel with its per-edge loop (both fp32 rings, the bf16
// forward's ring): F > 128.
constexpr int kKernelRing = 2;
// The bf16 src pass's ring with its factored loop (relgat_bwd.cu): F > 128.
constexpr int kKernelRingFactored = 3;
// The bf16 pair kernels, two heads a warp: F <= 128, a multiple of 8, the
// rows and outputs 16-byte aligned (and in the src pass the pair block's
// shared memory within kMaxBwdSmemBytes).
constexpr int kKernelPair = 4;
// The ring's bytes a block aims at: 2 to kRingMaxStages stages of this.
constexpr int kRingBytes = 48 * 1024;
constexpr int kRingMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the bulk copies.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Where value 0 of a row slice starting at `row` sits in its stage: the
// slice keeps its offset within a 16-byte block, so that its aligned middle
// lands 16-byte aligned.
template <typename T>
__device__ __forceinline__ int ring_shift(const T* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
}

// Values of T a stage holds for a slice of `len`: the slice, its shift and
// a whole number of 16-byte blocks.
__host__ __device__ constexpr int ring_stage_elems(int len, int size) {
  return (len * size + 16 + 15) / 16 * (16 / size);
}

// Called by all 32 lanes of the producer warp: the slice of `len` values at
// `row` into `stage` (16-byte aligned), value i at stage[ring_shift(row) +
// i]. Its 16-byte-aligned middle goes as one bulk copy that completes on
// `full`; the < 16 bytes before and after it (rows of F = 301, or a bf16
// slice not starting on 16 bytes) are copied by lanes 1-30 with plain loads
// and stores, which the __syncwarp orders before lane 0's arrival (a
// release) on `full`, the stage's one expected arrival.
template <typename T>
__device__ __forceinline__ void ring_load(T* stage, uint64_t* full,
                                          const T* __restrict__ row, int len,
                                          int lane) {
  constexpr uintptr_t kSz = sizeof(T);
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(row);
  const uintptr_t b1 = b0 + static_cast<uintptr_t>(len) * kSz;
  uintptr_t a0 = (b0 + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t a1 = b1 & ~static_cast<uintptr_t>(15);
  if (a1 < a0) a0 = a1 = b1;  // inside one 16-byte block: no middle
  T* dst = stage + ring_shift(row);
  const int nh = static_cast<int>((a0 - b0) / kSz);
  const int nt = static_cast<int>((b1 - a1) / kSz);
  const int i = lane - 1;
  if (i >= 0 && i < nh) {
    dst[i] = row[i];
  } else if (i >= nh && i < nh + nt) {
    const int k = static_cast<int>((a1 - b0) / kSz) + i - nh;
    dst[k] = row[k];
  }
  __syncwarp();
  if (lane == 0) {
    if (a1 > a0) {
      const uint32_t bytes = static_cast<uint32_t>(a1 - a0);
      mbar_arrive_tx(full, bytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + nh)),
          "l"(reinterpret_cast<const void*>(a0)), "r"(bytes),
          "r"(smem_u32(full))
          : "memory");
    } else {
      mbar_arrive(full);
    }
  }
}

// A lane's NK values of an F-wide piece of a row of T (fp32, or bf16
// widened) in shared memory or device memory, in the VW layout above (zeros
// past F).
template <int NK, int VW, typename T>
__device__ __forceinline__ void lane_row(const T* p, int feat, int lane,
                                         float (&v)[NK]) {
  static_assert(VW == 1 || (VW == 2 && NK % 2 == 0), "1 or 2 values a read");
  if constexpr (VW == 1) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int f = lane + 32 * k;
      v[k] = f < feat ? to_float(p[f]) : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NK / 2; ++k) {
      const int f = 2 * (lane + 32 * k);
      if constexpr (std::is_same_v<T, float>) {
        const float2 x = f < feat ? *reinterpret_cast<const float2*>(p + f)
                                  : make_float2(0.f, 0.f);
        v[2 * k] = x.x;
        v[2 * k + 1] = x.y;
      } else {
        const uint32_t x =
            f < feat ? *reinterpret_cast<const uint32_t*>(p + f) : 0u;
        v[2 * k] = bf16_lo(x);
        v[2 * k + 1] = bf16_hi(x);
      }
    }
  }
}

template <int NK, int VW>
__device__ __forceinline__ void lane_store(float* p, int feat, int lane,
                                           const float (&v)[NK]) {
  if constexpr (VW == 1) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int f = lane + 32 * k;
      if (f < feat) p[f] = v[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < NK / 2; ++k) {
      const int f = 2 * (lane + 32 * k);
      if (f < feat)
        *reinterpret_cast<float2*>(p + f) = make_float2(v[2 * k], v[2 * k + 1]);
    }
  }
}

// fmix32 of (seed, canonical edge id, head), bit for bit the hash of
// relgat_projector_tpu/ops/dropout.py: that code works on int32 with wrapping
// multiplies and logical shifts, which are exactly uint32 arithmetic here.
// Returns 1 where the (edge, head) weight is kept.
__device__ __forceinline__ float dropout_keep(int edge_id, int head,
                                              uint32_t seed, uint32_t thr) {
  uint32_t x = static_cast<uint32_t>(edge_id) * 0x9E3779B9u + seed +
               static_cast<uint32_t>(head) * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0x7FFFFFFFu) < thr ? 1.f : 0.f;
}

}  // namespace relgat
