// RelGAT propagate forward for Hopper (sm_90a).
//
// Replaces the TPU kernel relgat_projector_tpu/ops/pallas/fused.py
// `_fused_kernel` (launched by `fused_relgat_forward`). Per destination row d
// and head h, over d's in-edges in dst-CSR order:
//   e    = LeakyReLU(<h[src], attn[h, etype]>)
//   m, l = running max and sum of exp(e - m)            (true per-dst max)
//   acc  = sum of exp(e - m) * keep / (1 - rate) * h[src]
//   out  = acc / max(l, eps) + sum_e rel_bias[etype]
// and saves m, l and the bias sum for the backward.
//
// What bounds it: the gather of one H*F row of h per edge (E * H*F * 4 bytes,
// about 8.4 GB at 1M edges and H*F = 2048), which is far more than the bytes
// it must move (h and out once each). Logits and weights cost a few flops per
// byte, so the kernel is bound by memory traffic and by the latency of the
// dependent index -> row loads.
//
// What the design does about it: one warp per (dst row, head) walks the row's
// edges and gathers h[src] and attn[etype] itself, so no [E, H*F] array is
// written (the TPU path gathers `ps` to edge size first). Each lane holds
// F/32 features in registers; one butterfly sum gives the logit on every
// lane, so the online softmax needs no shared memory and no second pass.
// Every row is written, rows without in-edges as zeros, so no mask pass is
// needed afterwards. The TPU kernel's per-chunk reference shift and its
// one-hot matmuls (which stand in for gathers and scatters) have no
// counterpart here: the running max is the true per-row max.
#include "relgat_common.cuh"

namespace relgat {

template <int FPL>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
relgat_fwd_kernel(const float* __restrict__ h,         // [N, H*F]
                  const float* __restrict__ attn,      // [H, R, F]
                  const float* __restrict__ rel_bias,  // [R]
                  const int* __restrict__ dst_ptr,     // [N + 1]
                  const int* __restrict__ src,         // [E] dst-sorted
                  const int* __restrict__ etype,       // [E] dst-sorted
                  float* __restrict__ out,             // [N, H*F]
                  float* __restrict__ m_out,           // [N, H]
                  float* __restrict__ l_out,           // [N, H]
                  float* __restrict__ bias_out,        // [N]
                  int heads, int feat, int num_rel, float slope, float eps,
                  int use_dropout, uint32_t seed, uint32_t thr,
                  float keep_prob) {
  const int lane = threadIdx.x & 31;
  const int head = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (head >= heads) return;
  const int d = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int e0 = dst_ptr[d];
  const int e1 = dst_ptr[d + 1];

  float acc[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  // One bias term per in-edge, never rescaled: summed in fp32, a row of a
  // few thousand edges would lose ~1e-5 of it relative, so it is summed in
  // fp64 (one scalar add per edge).
  double bsum = 0.0;

  for (int e = e0; e < e1; ++e) {
    const int s = src[e];
    const int r = etype[e];
    const float* hs = h + s * hf + static_cast<int64_t>(head) * feat;
    const float* ar = attn + (static_cast<int64_t>(head) * num_rel + r) * feat;
    float hv[FPL];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      hv[i] = f < feat ? hs[f] : 0.f;
      dot += f < feat ? hv[i] * ar[f] : 0.f;
    }
    const float ev = leaky_relu(warp_sum(dot), slope);
    const float m_new = fmaxf(m, ev);
    const float scale = expf(m - m_new);  // 0 on the first edge (m = -inf)
    const float p = expf(ev - m_new);
    l = l * scale + p;
    const float pk =
        use_dropout ? p * dropout_keep(e, head, seed, thr) / keep_prob : p;
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = acc[i] * scale + pk * hv[i];
    m = m_new;
    bsum += rel_bias[r];
  }

  const float denom = fmaxf(l, eps);
  const float bias = static_cast<float>(bsum);
  float* o = out + d * hf + static_cast<int64_t>(head) * feat;
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < feat) o[f] = acc[i] / denom + bias;
  }
  if (lane == 0) {
    m_out[static_cast<int64_t>(d) * heads + head] = m;
    l_out[static_cast<int64_t>(d) * heads + head] = l;
    if (head == 0) bias_out[d] = bias;
  }
}

}  // namespace relgat

extern "C" int relgat_fwd(const float* h, const float* attn,
                          const float* rel_bias, const int* dst_ptr,
                          const int* src, const int* etype, float* out,
                          float* m_out, float* l_out, float* bias_out,
                          int num_nodes, int heads, int feat, int num_rel,
                          float slope, float eps, int use_dropout, int seed,
                          unsigned int thr, float keep_prob, void* stream) {
  using namespace relgat;
  const int wpb = heads < kMaxWarpsPerBlock ? heads : kMaxWarpsPerBlock;
  const dim3 block(32 * wpb);
  const dim3 grid(num_nodes, (heads + wpb - 1) / wpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fpl = (feat + 31) / 32;
#define RELGAT_FWD_LAUNCH(FPL)                                              \
  relgat_fwd_kernel<FPL><<<grid, block, 0, st>>>(                           \
      h, attn, rel_bias, dst_ptr, src, etype, out, m_out, l_out, bias_out,  \
      heads, feat, num_rel, slope, eps, use_dropout,                        \
      static_cast<uint32_t>(seed), thr, keep_prob)
  if (fpl <= 1) {
    RELGAT_FWD_LAUNCH(1);
  } else if (fpl <= 2) {
    RELGAT_FWD_LAUNCH(2);
  } else if (fpl <= 4) {
    RELGAT_FWD_LAUNCH(4);
  } else if (fpl <= kMaxFeatPerLane) {
    RELGAT_FWD_LAUNCH(8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RELGAT_FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
