// The GAT layer's tail (models/layer.py): the output dropout, the ELU where
// another GAT layer follows, and the rounding to the next product's operand
// type, over the propagate's fp32 output agg [N, H*F]. A forward kernel and
// a backward kernel. It replaces no TPU kernel: the JAX package leaves the
// tail to XLA, which fuses it; in the port it ran as three or four eager
// PyTorch passes over the rows forward (agg * keep, * 1 / (1 - rate), the
// ELU, the product's cast) and three or four backward.
//
// Bound: bytes, every element touched once. Forward: agg and keep (fp32)
// read once, out (fp32, bf16 or fp16) written once. Backward: the
// cotangent (out's type) and keep read once, agg read once where the ELU
// ran (its input is recomputed from it), dagg (fp32) written once. An expm1f
// or expf an element stays far under the card's rate at 3.35 TB/s.
//
// Design: elementwise over the flat array, a chunk of 8 values a thread,
// each array read and written with 16-byte accesses (two for fp32, one for
// 16-bit values) where every pointer is 16-byte aligned; the last n % 8
// values, and every value of an unaligned call, one at a time. Each thread
// has its chunk's loads (64 bytes of agg and keep forward) in flight at
// once. No shared memory.
//
// Numerics follow the eager chain op for op in fp32, each step rounded on
// its own (__fmul_rn: no contraction): t = agg * keep, then t * inv with
// inv = 1.0f / (float)(1 - rate) (PyTorch's CUDA division by a host scalar
// multiplies by that reciprocal), then the ELU as PyTorch's CUDA kernel
// computes it with alpha 1 (x > 0 ? x : expm1f(x)), then the rounding to
// nearest even. Backward: x <= 0 ? g * expf(x) : g (elu_backward on the
// ELU's input), then * inv, then * keep. So the values are the eager
// chain's, bit for bit.

#include <math.h>

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace layertail {

constexpr int kChunk = 8;
constexpr int kThreads = 256;
// dtype codes of out and the cotangent (ops/cuda/layer_tail.py ROW_TYPES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

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

// The ELU's input: agg after the dropout.
template <bool kDrop>
__device__ __forceinline__ float dropped(float a, float k, float inv) {
  if constexpr (kDrop) return __fmul_rn(__fmul_rn(a, k), inv);
  return a;
}

template <bool kDrop, bool kElu>
__device__ __forceinline__ float fwd_value(float a, float k, float inv) {
  const float x = dropped<kDrop>(a, k, inv);
  if constexpr (kElu) return x > 0.f ? x : expm1f(x);
  return x;
}

template <bool kDrop, bool kElu>
__device__ __forceinline__ float bwd_value(float g, float a, float k,
                                           float inv) {
  float d = g;
  if constexpr (kElu) {
    const float x = dropped<kDrop>(a, k, inv);
    if (x <= 0.f) d = __fmul_rn(g, expf(x));
  }
  if constexpr (kDrop) d = __fmul_rn(__fmul_rn(d, inv), k);
  return d;
}

// 8 values of T at p (16-byte aligned), widened.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p,
                                      float (&v)[kChunk]) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    struct alignas(16) Eight { T x[kChunk]; };
    const Eight e = *reinterpret_cast<const Eight*>(p);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = widen(e.x[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p,
                                       const float (&v)[kChunk]) {
  if constexpr (std::is_same_v<T, float>) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    struct alignas(16) Eight { T x[kChunk]; };
    Eight e;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) e.x[j] = narrow<T>(v[j]);
    *reinterpret_cast<Eight*>(p) = e;
  }
}

// out = round(elu(agg * keep * inv)); keep unread without kDrop, the ELU
// skipped without kElu.
template <typename T, bool kDrop, bool kElu, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dropout_elu_fwd_kernel(const float* __restrict__ agg,
                           const float* __restrict__ keep,
                           T* __restrict__ out, int64_t n, float inv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t chunks = n / kChunk;
    for (int64_t c = tid; c < chunks; c += stride) {
      const int64_t i = c * kChunk;
      float a[kChunk], k[kChunk];
      load8(agg + i, a);
      if constexpr (kDrop) load8(keep + i, k);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        a[j] = fwd_value<kDrop, kElu>(a[j], kDrop ? k[j] : 1.f, inv);
      store8(out + i, a);
    }
    done = chunks * kChunk;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = narrow<T>(
        fwd_value<kDrop, kElu>(agg[i], kDrop ? keep[i] : 1.f, inv));
}

// dagg = g * elu'(x) * inv * keep, x recomputed from agg (read only with
// kElu).
template <typename T, bool kDrop, bool kElu, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dropout_elu_bwd_kernel(const T* __restrict__ g,
                           const float* __restrict__ keep,
                           const float* __restrict__ agg,
                           float* __restrict__ dagg, int64_t n, float inv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t chunks = n / kChunk;
    for (int64_t c = tid; c < chunks; c += stride) {
      const int64_t i = c * kChunk;
      float d[kChunk], k[kChunk], a[kChunk];
      load8(g + i, d);
      if constexpr (kDrop) load8(keep + i, k);
      if constexpr (kElu) load8(agg + i, a);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        d[j] = bwd_value<kDrop, kElu>(d[j], kElu ? a[j] : 0.f,
                                      kDrop ? k[j] : 1.f, inv);
      store8(dagg + i, d);
    }
    done = chunks * kChunk;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    dagg[i] = bwd_value<kDrop, kElu>(widen(g[i]), kElu ? agg[i] : 0.f,
                                     kDrop ? keep[i] : 1.f, inv);
}

// One chunk (or one value) a thread, as many blocks as that takes: the
// block scheduler keeps every SM full as blocks end. (A single wave of
// blocks striding over the array reached 80-89% of the bound; this 88-93%.)
inline int blocks_for(int64_t work) {
  const int64_t need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < 1 ? 1 : (need < INT_MAX ? need : INT_MAX));
}

template <typename T, bool kDrop, bool kElu, bool kVec>
cudaError_t fwd(const float* agg, const float* keep, void* out, int64_t n,
                float inv, cudaStream_t st) {
  const int blocks = blocks_for(kVec ? n / kChunk + n % kChunk : n);
  dropout_elu_fwd_kernel<T, kDrop, kElu, kVec><<<blocks, kThreads, 0, st>>>(
      agg, keep, static_cast<T*>(out), n, inv);
  return cudaGetLastError();
}

template <typename T, bool kDrop, bool kElu, bool kVec>
cudaError_t bwd(const void* g, const float* keep, const float* agg,
                float* dagg, int64_t n, float inv, cudaStream_t st) {
  const int blocks = blocks_for(kVec ? n / kChunk + n % kChunk : n);
  dropout_elu_bwd_kernel<T, kDrop, kElu, kVec><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(g), keep, agg, dagg, n, inv);
  return cudaGetLastError();
}

template <typename T, bool kDrop, bool kElu, bool kVec>
struct Fwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return fwd<T, kDrop, kElu, kVec>(args...);
  }
};

template <typename T, bool kDrop, bool kElu, bool kVec>
struct Bwd {
  template <typename... A>
  static cudaError_t run(A... args) {
    return bwd<T, kDrop, kElu, kVec>(args...);
  }
};

template <typename T>
struct Tag {
  using type = T;
};

// The instantiation for (dtype code, dropout, ELU, vector accesses).
template <template <typename, bool, bool, bool> class F, typename... A>
cudaError_t dispatch(int dtype, bool drop, bool elu, bool vec, A... args) {
  auto by_flags = [&](auto type_tag) -> cudaError_t {
    using T = typename decltype(type_tag)::type;
    const int code = (drop ? 4 : 0) | (elu ? 2 : 0) | (vec ? 1 : 0);
    switch (code) {
      case 0: return F<T, false, false, false>::run(args...);
      case 1: return F<T, false, false, true>::run(args...);
      case 2: return F<T, false, true, false>::run(args...);
      case 3: return F<T, false, true, true>::run(args...);
      case 4: return F<T, true, false, false>::run(args...);
      case 5: return F<T, true, false, true>::run(args...);
      case 6: return F<T, true, true, false>::run(args...);
      default: return F<T, true, true, true>::run(args...);
    }
  };
  switch (dtype) {
    case kF32: return by_flags(Tag<float>{});
    case kBF16: return by_flags(Tag<__nv_bfloat16>{});
    case kF16: return by_flags(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace layertail

// out [n] (dtype: 0 fp32, 1 bf16, 2 fp16) from agg [n] fp32 and keep [n]
// fp32 0/1 (null: no dropout), with keep_prob = 1 - rate as the host
// computes it in double. elu: apply the ELU. vec: every pointer 16-byte
// aligned.
extern "C" int layer_tail_fwd(const float* agg, const float* keep, void* out,
                              long long n, double keep_prob, int elu,
                              int dtype, int vec, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const float inv = 1.0f / static_cast<float>(keep_prob);
  return layertail::dispatch<layertail::Fwd>(
      dtype, keep != nullptr, elu != 0, vec != 0, agg, keep, out,
      static_cast<int64_t>(n), inv, static_cast<cudaStream_t>(stream));
}

// dagg [n] fp32 from the cotangent g [n] (out's dtype code), keep [n] (null:
// no dropout) and, with elu, the forward's agg [n].
extern "C" int layer_tail_bwd(const void* g, const float* keep,
                              const float* agg, float* dagg, long long n,
                              double keep_prob, int elu, int dtype, int vec,
                              void* stream) {
  if (n < 1 || (elu && agg == nullptr)) return cudaErrorInvalidValue;
  const float inv = 1.0f / static_cast<float>(keep_prob);
  return layertail::dispatch<layertail::Bwd>(
      dtype, keep != nullptr, elu != 0, vec != 0, g, keep, agg, dagg,
      static_cast<int64_t>(n), inv, static_cast<cudaStream_t>(stream));
}
