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
// MAX_FEAT); the wrappers reject wider heads. Above 4 a lane (F > 128, or
// F > 512 with 16-byte loads) the kernels drop their occupancy targets and
// take the registers they need: at 32 a lane the backward holds 4 x 32
// floats of rows and sums, 159-173 registers without spills (ptxas), one
// block of 8 warps an SM. Shared memory would hold the sums at a higher
// occupancy, but every
// edge reads and writes all of them, so it would trade a register file
// read for a shared-memory round trip per feature and edge.
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
