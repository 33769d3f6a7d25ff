// The projection head's GELU -> LayerNorm block (models/projection.py): a
// forward kernel and a backward kernel, with a third that sums the
// LayerNorm scale and bias gradients. It replaces no TPU kernel: the JAX
// package leaves this block to XLA, which fuses it; in the port it ran as
// ~11 eager PyTorch passes over the [N, D] fp32 rows forward and ~25-30
// backward.
//
// Bound: bytes. Forward: y (fp32) read once, z (fp32, bf16 or fp16, the
// next product's operand type) written once, a mean and a reciprocal
// standard deviation a row. Backward: dz (z's type) and y read once, dy
// (fp32) written once, and the column sums of dz * xhat and dz. A few dozen
// flops an element (erff, expf) stay well under the card's rate at 3.35
// TB/s.
//
// Design: a block holds whole rows in registers, up to 4 * kChunks values
// a thread (kChunks = 1, 2, 4, 8 covers D <= 8192 at <= 256 threads),
// chunks of 4 adjacent values read with one 16-byte (fp32) or 8-byte (bf16,
// fp16) access where D % 4 == 0 and the rows are aligned, one value at a
// time otherwise. Row sums go through a warp butterfly and shared memory in
// a fixed order. The forward takes one row a block. The backward takes a
// contiguous run of rows a block, as many blocks as fit on the card at
// once, each keeping its columns' partial sums of dz * xhat and dz in
// registers and writing them once; the second kernel adds those partials
// in block order. No atomics: the same inputs on the same card give the
// same bits.
//
// Numerics follow the plain composition (F.gelu, then
// ops/cuda/gelu_layernorm.py:_layer_norm) in fp32: PyTorch's exact-GELU
// formulas (erff, expf), mean as sum * (1 / D), the variance two-pass over
// the row, rsqrtf as torch.rsqrt, and the elementwise steps rounded one by
// one (__fmul_rn, __fadd_rn: no contraction), so that the values differ
// from the plain path only through the order of the row sums.

#include <math.h>

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace projhead {

constexpr int kVec = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChunks = 8;  // D <= kVec * kMaxChunks * kMaxThreads = 8192
constexpr float kEps = 1e-5f;
constexpr unsigned kFullMask = 0xffffffffu;
// PyTorch's GeluCUDAKernelImpl and GeluBackwardCUDAKernelImpl constants.
constexpr float kAlpha = static_cast<float>(M_SQRT1_2);
constexpr float kBeta = static_cast<float>(M_2_SQRTPI * M_SQRT1_2 * 0.5);
// Column sums of the backward: the partial buffer the wrapper allocates
// holds at most this many blocks (ops/cuda/gelu_layernorm.py
// BWD_MAX_BLOCKS).
constexpr int kBwdMaxBlocks = 2048;
// dtype codes of the z and dz rows (ops/cuda/gelu_layernorm.py ROW_TYPES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

__device__ __forceinline__ float gelu_grad(float dy, float x) {
  const float cdf = 0.5f * (1.0f + erff(x * kAlpha));
  const float pdf = expf(-0.5f * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(x);
  } else {
    return __float2half_rn(x);
  }
}

// Column of value j of chunk c of thread t: chunk c * threads + t, 4 values.
__device__ __forceinline__ int col_of(int c, int j) {
  return kVec * (c * static_cast<int>(blockDim.x) +
                 static_cast<int>(threadIdx.x)) + j;
}

// A thread's share of a D-wide row of T, widened to fp32; columns past D
// read as zeros.
template <int kChunks, bool kVecIO, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int d,
                                         float (&v)[kVec * kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int f = col_of(c, 0);
    if constexpr (kVecIO && std::is_same_v<T, float>) {
      const float4 x = f < d ? *reinterpret_cast<const float4*>(p + f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[kVec * c] = x.x;
      v[kVec * c + 1] = x.y;
      v[kVec * c + 2] = x.z;
      v[kVec * c + 3] = x.w;
    } else if constexpr (kVecIO) {
      // four 16-bit values, one 8-byte read; value 2k in word k's low half
      struct alignas(8) Four { T a, b, e, f; };
      Four x;
      if (f < d) {
        x = *reinterpret_cast<const Four*>(p + f);
      } else {
        x.a = x.b = x.e = x.f = narrow<T>(0.f);
      }
      v[kVec * c] = widen(x.a);
      v[kVec * c + 1] = widen(x.b);
      v[kVec * c + 2] = widen(x.e);
      v[kVec * c + 3] = widen(x.f);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[kVec * c + j] = f + j < d ? widen(p[f + j]) : 0.f;
    }
  }
}

template <int kChunks, bool kVecIO, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, int d,
                                          const float (&v)[kVec * kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int f = col_of(c, 0);
    if constexpr (kVecIO && std::is_same_v<T, float>) {
      if (f < d)
        *reinterpret_cast<float4*>(p + f) =
            make_float4(v[kVec * c], v[kVec * c + 1], v[kVec * c + 2],
                        v[kVec * c + 3]);
    } else if constexpr (kVecIO) {
      struct alignas(8) Four { T a, b, e, f; };
      if (f < d) {
        Four x;
        x.a = narrow<T>(v[kVec * c]);
        x.b = narrow<T>(v[kVec * c + 1]);
        x.e = narrow<T>(v[kVec * c + 2]);
        x.f = narrow<T>(v[kVec * c + 3]);
        *reinterpret_cast<Four*>(p + f) = x;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (f + j < d) p[f + j] = narrow<T>(v[kVec * c + j]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The block's sum of each thread's a and b, the same bits in every thread:
// each warp's butterfly sum, then every thread adds the warps' sums in warp
// order. `red` holds 2 * kMaxWarps floats; the closing barrier lets the
// next call reuse it.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = a;
    red[kMaxWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < warps; ++w) {
    a += red[w];
    b += red[kMaxWarps + w];
  }
  __syncthreads();
}

__device__ __forceinline__ float block_sum(float a, float* red) {
  float none = 0.f;
  block_sum2(a, none, red);
  return a;
}

// One row a block: z = (gelu(y) - mean) * rstd * scale + bias, and the
// row's mean and rstd.
template <int kChunks, bool kVecIO, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gelu_ln_fwd_kernel(const float* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ z,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int d) {
  __shared__ float red[2 * kMaxWarps];
  constexpr int kN = kVec * kChunks;
  const size_t row = blockIdx.x;
  const float inv_d = 1.0f / static_cast<float>(d);
  float g[kN], sc[kN], bi[kN];
  load_row<kChunks, kVecIO>(y + row * d, d, g);
  load_row<kChunks, kVecIO>(scale, d, sc);
  load_row<kChunks, kVecIO>(bias, d, bi);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    g[i] = gelu(g[i]);  // gelu(0) = 0 past the row's end
    s += g[i];
  }
  const float mean = __fmul_rn(block_sum(s, red), inv_d);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (col_of(i / kVec, i % kVec) < d) {
      const float c = __fsub_rn(g[i], mean);
      q = __fadd_rn(q, __fmul_rn(c, c));
    }
  }
  const float var = __fmul_rn(block_sum(q, red), inv_d);
  const float rstd = rsqrtf(__fadd_rn(var, kEps));
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float xhat = __fmul_rn(__fsub_rn(g[i], mean), rstd);
    g[i] = __fadd_rn(__fmul_rn(xhat, sc[i]), bi[i]);
  }
  store_row<kChunks, kVecIO>(z + row * d, d, g);
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Rows [b * n / G, (b + 1) * n / G) of block b of G:
//   dxhat = dz * scale
//   dg = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dy = gelu'(y) applied to dg, as PyTorch's GELU backward
// and the block's column sums of dz * xhat and dz into part[b][0 / 1][:].
template <int kChunks, bool kVecIO, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gelu_ln_bwd_kernel(const T* __restrict__ dz, const float* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ mean_in,
                       const float* __restrict__ rstd_in,
                       float* __restrict__ dy, float* __restrict__ part,
                       int n, int d) {
  __shared__ float red[2 * kMaxWarps];
  constexpr int kN = kVec * kChunks;
  const int lo = static_cast<int>(static_cast<int64_t>(blockIdx.x) * n /
                                  gridDim.x);
  const int hi = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * n /
                                  gridDim.x);
  const float inv_d = 1.0f / static_cast<float>(d);
  float sc[kN], dscale[kN], dbias[kN];
  load_row<kChunks, kVecIO>(scale, d, sc);
#pragma unroll
  for (int i = 0; i < kN; ++i) dscale[i] = dbias[i] = 0.f;
  for (int r = lo; r < hi; ++r) {
    const size_t row = r;
    float x[kN], xhat[kN], dxhat[kN];  // dxhat holds dz until scaled
    load_row<kChunks, kVecIO>(y + row * d, d, x);
    load_row<kChunks, kVecIO>(dz + row * d, d, dxhat);
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      // columns past D: dz = 0 and scale = 0 add nothing anywhere
      xhat[i] = __fmul_rn(__fsub_rn(gelu(x[i]), mean), rstd);
      dscale[i] += dxhat[i] * xhat[i];
      dbias[i] += dxhat[i];
      dxhat[i] = __fmul_rn(dxhat[i], sc[i]);
      s1 += dxhat[i];
      s2 += dxhat[i] * xhat[i];
    }
    block_sum2(s1, s2, red);
    const float m1 = __fmul_rn(s1, inv_d);
    const float m2 = __fmul_rn(s2, inv_d);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float dg = rstd * (dxhat[i] - m1 - xhat[i] * m2);
      x[i] = gelu_grad(dg, x[i]);
    }
    store_row<kChunks, kVecIO>(dy + row * d, d, x);
  }
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * d;
  store_row<kChunks, kVecIO>(out, d, dscale);
  store_row<kChunks, kVecIO>(out + d, d, dbias);
}

// dscale[c] and dbias[c]: the blocks' partials summed in block order. A
// block takes 32 of the 2 * D columns; its 8 rows of threads each add every
// 8th partial, then row 0 adds the 8 sums in order.
__global__ void __launch_bounds__(256)
    ln_param_grad_kernel(const float* __restrict__ part, int blocks, int d,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias) {
  __shared__ float sums[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < 2 * d) {
    for (int b = threadIdx.y; b < blocks; b += 8)
      s += part[static_cast<size_t>(b) * 2 * d + col];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += sums[k][threadIdx.x];
    if (col < d) {
      dscale[col] = t;
    } else {
      dbias[col - d] = t;
    }
  }
}

// Chunks a thread and threads a block for width d.
inline bool plan(int d, int* chunks, int* threads) {
  const int vecs = (d + kVec - 1) / kVec;
  for (int c = 1; c <= kMaxChunks; c *= 2) {
    const int t = (vecs + c - 1) / c;
    if (t <= kMaxThreads) {
      *chunks = c;
      *threads = (t + 31) / 32 * 32;
      return true;
    }
  }
  return false;
}

template <int kChunks, bool kVecIO, typename T>
cudaError_t fwd(const float* y, const float* scale, const float* bias,
                void* z, float* mean, float* rstd, int n, int d, int threads,
                cudaStream_t st) {
  gelu_ln_fwd_kernel<kChunks, kVecIO, T><<<n, threads, 0, st>>>(
      y, scale, bias, static_cast<T*>(z), mean, rstd, d);
  return cudaGetLastError();
}

template <int kChunks, bool kVecIO, typename T>
cudaError_t bwd(const void* dz, const float* y, const float* scale,
                const float* mean, const float* rstd, float* dy, float* part,
                float* dscale, float* dbias, int n, int d, int threads,
                cudaStream_t st) {
  auto kernel = gelu_ln_bwd_kernel<kChunks, kVecIO, T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int blocks = sms * per_sm;
  if (blocks > kBwdMaxBlocks) blocks = kBwdMaxBlocks;
  if (blocks > n) blocks = n;
  kernel<<<blocks, threads, 0, st>>>(static_cast<const T*>(dz), y, scale,
                                     mean, rstd, dy, part, n, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ln_param_grad_kernel<<<(2 * d + 31) / 32, dim3(32, 8), 0, st>>>(
      part, blocks, d, dscale, dbias);
  return cudaGetLastError();
}

// The instantiation for (chunks, vec_io, dtype code).
template <template <int, bool, typename> class F, typename... A>
cudaError_t dispatch(int chunks, int vec_io, int dtype, A... args) {
  auto by_type = [&](auto chunk_tag, auto vec_tag) -> cudaError_t {
    constexpr int C = decltype(chunk_tag)::value;
    constexpr bool V = decltype(vec_tag)::value;
    switch (dtype) {
      case kF32: return F<C, V, float>::run(args...);
      case kBF16: return F<C, V, __nv_bfloat16>::run(args...);
      case kF16: return F<C, V, __half>::run(args...);
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_vec = [&](auto chunk_tag) -> cudaError_t {
    return vec_io ? by_type(chunk_tag, std::true_type{})
                  : by_type(chunk_tag, std::false_type{});
  };
  switch (chunks) {
    case 1: return by_vec(std::integral_constant<int, 1>{});
    case 2: return by_vec(std::integral_constant<int, 2>{});
    case 4: return by_vec(std::integral_constant<int, 4>{});
    case 8: return by_vec(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int C, bool V, typename T>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... args) { return fwd<C, V, T>(args...); }
};

template <int C, bool V, typename T>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... args) { return bwd<C, V, T>(args...); }
};

}  // namespace projhead

// z [n, d] (dtype: 0 fp32, 1 bf16, 2 fp16) and mean, rstd [n] from y [n, d]
// fp32 and fp32 scale, bias [d]. vec_io: d % 4 == 0 and every row pointer
// 16-byte aligned (8-byte for 16-bit z).
extern "C" int gelu_ln_fwd(const float* y, const float* scale,
                           const float* bias, void* z, float* mean,
                           float* rstd, int n, int d, int dtype, int vec_io,
                           void* stream) {
  int chunks = 0, threads = 0;
  if (n < 1 || !projhead::plan(d, &chunks, &threads))
    return cudaErrorInvalidValue;
  return projhead::dispatch<projhead::Fwd>(
      chunks, vec_io, dtype, y, scale, bias, z, mean, rstd, n, d, threads,
      static_cast<cudaStream_t>(stream));
}

// dy [n, d] fp32 from dz [n, d] (z's dtype code), y, the fp32 scale and the
// forward's mean and rstd; dscale, dbias [d] fp32 through part, scratch of
// at least min(n, 2048) x 2 x d fp32.
extern "C" int gelu_ln_bwd(const void* dz, const float* y, const float* scale,
                           const float* mean, const float* rstd, float* dy,
                           float* part, float* dscale, float* dbias, int n,
                           int d, int dtype, int vec_io, void* stream) {
  int chunks = 0, threads = 0;
  if (n < 1 || !projhead::plan(d, &chunks, &threads))
    return cudaErrorInvalidValue;
  return projhead::dispatch<projhead::Bwd>(
      chunks, vec_io, dtype, dz, y, scale, mean, rstd, dy, part, dscale,
      dbias, n, d, threads, static_cast<cudaStream_t>(stream));
}
