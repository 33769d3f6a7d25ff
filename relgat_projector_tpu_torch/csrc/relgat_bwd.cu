// RelGAT propagate backward for Hopper (sm_90a).
//
// Replaces the TPU kernel relgat_projector_tpu/ops/pallas/fused.py
// `_bwd_src_kernel` (launched by `fused_relgat_backward_src`). Given the
// output cotangent g, the forward's per-(dst, head) max m and sum l, and the
// per-(dst, head) S = <out - bias, g>, each edge (s -> d, relation r) gives
//   alpha = exp(LeakyReLU(<h[s], attn[r]>) - m[d]) / max(l[d], eps)
//   k     = keep / (1 - rate)            (the forward's dropout mask, replayed)
//   de    = alpha * (k * <h[s], g[d]> - S[d]) * LeakyReLU'(.)
//   dh[s]    += alpha * k * g[d] + de * attn[r]
//   dattn[r] += de * h[s]
//   dbias[r] += sum_{h,f} g[d]
//
// The TPU kernel carries dattn and dbias across its sequential grid. Blocks
// on this card run in no order, so the work is split in two kernels, both
// without atomics, hence deterministic:
//   relgat_bwd_src_kernel  one warp per (src row, head) walks the row's
//       out-edges in src-CSR order, keeps h[s] and the dh accumulator in
//       registers, writes every dh row once and stores de[edge, head];
//   relgat_bwd_rel_*       walks the edges grouped by relation in chunks of
//       at most 256 edges (one block per chunk and 256 columns of H*F), writes
//       one partial per chunk, then sums each relation's partials in order.
//
// What bounds them: like the forward, the per-edge gathers of H*F-wide rows
// (g[d] and attn[r] in the first kernel, h[s] in the second), not the bytes
// they must move once; the flops per byte are few. The design gathers inside
// the kernels (no edge-sized [E, H*F] stream is written) and keeps the
// per-row operands in registers.
#include "relgat_common.cuh"

namespace relgat {

constexpr int kColsPerBlock = 256;

template <int FPL>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
relgat_bwd_src_kernel(const float* __restrict__ h,      // [N, H*F]
                      const float* __restrict__ g,      // [N, H*F]
                      const float* __restrict__ attn,   // [H, R, F]
                      const float* __restrict__ m,      // [N, H]
                      const float* __restrict__ l,      // [N, H]
                      const float* __restrict__ s_dot,  // [N, H]
                      const int* __restrict__ src_ptr,  // [N + 1]
                      const int* __restrict__ dst,      // [E] src-sorted
                      const int* __restrict__ etype,    // [E] src-sorted
                      const int* __restrict__ eid,      // [E] src-sorted
                      float* __restrict__ dh,           // [N, H*F]
                      float* __restrict__ de,           // [E, H] by edge id
                      int heads, int feat, int num_rel, float slope,
                      float eps, int use_dropout, uint32_t seed, uint32_t thr,
                      float keep_prob) {
  const int lane = threadIdx.x & 31;
  const int head = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (head >= heads) return;
  const int s = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;

  float hv[FPL];
  float acc[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    hv[i] = f < feat ? h[row + f] : 0.f;
    acc[i] = 0.f;
  }

  const int p1 = src_ptr[s + 1];
  for (int p = src_ptr[s]; p < p1; ++p) {
    const int d = dst[p];
    const int r = etype[p];
    const int id = eid[p];
    const float* gd = g + d * hf + static_cast<int64_t>(head) * feat;
    const float* ar = attn + (static_cast<int64_t>(head) * num_rel + r) * feat;
    float gv[FPL];
    float av[FPL];
    float eraw = 0.f;
    float dalpha = 0.f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int f = lane + 32 * i;
      gv[i] = f < feat ? gd[f] : 0.f;
      av[i] = f < feat ? ar[f] : 0.f;
      eraw += hv[i] * av[i];
      dalpha += hv[i] * gv[i];
    }
    eraw = warp_sum(eraw);
    dalpha = warp_sum(dalpha);
    const int64_t dh_idx = static_cast<int64_t>(d) * heads + head;
    float mv = m[dh_idx];
    if (mv == -INFINITY) mv = 0.f;  // m_safe of fused.py; d has an edge here
    const float alpha = expf(leaky_relu(eraw, slope) - mv) / fmaxf(l[dh_idx], eps);
    const float k =
        use_dropout ? dropout_keep(id, head, seed, thr) / keep_prob : 1.f;
    const float dev =
        alpha * (dalpha * k - s_dot[dh_idx]) * (eraw >= 0.f ? 1.f : slope);
    const float aw = alpha * k;
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] += aw * gv[i] + dev * av[i];
    if (lane == 0) de[static_cast<int64_t>(id) * heads + head] = dev;
  }

#pragma unroll
  for (int i = 0; i < FPL; ++i) {
    const int f = lane + 32 * i;
    if (f < feat) dh[row + f] = acc[i];
  }
}

__global__ void __launch_bounds__(kColsPerBlock)
relgat_bwd_rel_partial_kernel(const float* __restrict__ h,      // [N, H*F]
                              const float* __restrict__ de,     // [E, H]
                              const float* __restrict__ gsum,   // [N]
                              const int* __restrict__ src,      // [E] by id
                              const int* __restrict__ dst,      // [E] by id
                              const int* __restrict__ rel_eid,  // [E]
                              const int* __restrict__ chunk_start,  // [C]
                              const int* __restrict__ chunk_end,    // [C]
                              float* __restrict__ part_attn,    // [C, H*F]
                              float* __restrict__ part_bias,    // [C]
                              int heads, int feat) {
  const int c = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int i0 = chunk_start[c];
  const int i1 = chunk_end[c];
  if (col < hf) {
    const int head = static_cast<int>(col / feat);
    float acc = 0.f;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const int id = rel_eid[i];
      acc += de[static_cast<int64_t>(id) * heads + head] *
             h[static_cast<int64_t>(src[id]) * hf + col];
    }
    part_attn[static_cast<int64_t>(c) * hf + col] = acc;
  }
  if (blockIdx.y == 0 && threadIdx.x < 32) {
    float b = 0.f;
    for (int i = i0 + static_cast<int>(threadIdx.x); i < i1; i += 32)
      b += gsum[dst[rel_eid[i]]];
    b = warp_sum(b);
    if (threadIdx.x == 0) part_bias[c] = b;
  }
}

__global__ void __launch_bounds__(kColsPerBlock)
relgat_bwd_rel_reduce_kernel(const float* __restrict__ part_attn,  // [C, H*F]
                             const float* __restrict__ part_bias,  // [C]
                             const int* __restrict__ rel_chunk_ptr,  // [Rg + 1]
                             float* __restrict__ dattn,  // [H, R, F]
                             float* __restrict__ dbias,  // [R]
                             int heads, int feat, int num_rel,
                             int num_rel_graph) {
  const int r = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  int c0 = 0;
  int c1 = 0;
  if (r < num_rel_graph) {
    c0 = rel_chunk_ptr[r];
    c1 = rel_chunk_ptr[r + 1];
  }
  if (col < hf) {
    float acc = 0.f;
    for (int c = c0; c < c1; ++c) acc += part_attn[static_cast<int64_t>(c) * hf + col];
    const int64_t head = col / feat;
    const int64_t f = col - head * feat;
    dattn[(head * num_rel + r) * feat + f] = acc;
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    float b = 0.f;
    for (int c = c0; c < c1; ++c) b += part_bias[c];
    dbias[r] = b;
  }
}

}  // namespace relgat

extern "C" int relgat_bwd_src(const float* h, const float* g,
                              const float* attn, const float* m,
                              const float* l, const float* s_dot,
                              const int* src_ptr, const int* dst,
                              const int* etype, const int* eid, float* dh,
                              float* de, int num_nodes, int heads, int feat,
                              int num_rel, float slope, float eps,
                              int use_dropout, int seed, unsigned int thr,
                              float keep_prob, void* stream) {
  using namespace relgat;
  const int wpb = heads < kMaxWarpsPerBlock ? heads : kMaxWarpsPerBlock;
  const dim3 block(32 * wpb);
  const dim3 grid(num_nodes, (heads + wpb - 1) / wpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fpl = (feat + 31) / 32;
#define RELGAT_BWD_LAUNCH(FPL)                                               \
  relgat_bwd_src_kernel<FPL><<<grid, block, 0, st>>>(                        \
      h, g, attn, m, l, s_dot, src_ptr, dst, etype, eid, dh, de, heads,      \
      feat, num_rel, slope, eps, use_dropout, static_cast<uint32_t>(seed),   \
      thr, keep_prob)
  if (fpl <= 1) {
    RELGAT_BWD_LAUNCH(1);
  } else if (fpl <= 2) {
    RELGAT_BWD_LAUNCH(2);
  } else if (fpl <= 4) {
    RELGAT_BWD_LAUNCH(4);
  } else if (fpl <= kMaxFeatPerLane) {
    RELGAT_BWD_LAUNCH(8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RELGAT_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int relgat_bwd_rel(const float* h, const float* de,
                              const float* gsum, const int* src,
                              const int* dst, const int* rel_eid,
                              const int* chunk_start, const int* chunk_end,
                              const int* rel_chunk_ptr, float* part_attn,
                              float* part_bias, float* dattn, float* dbias,
                              int num_chunks, int heads, int feat,
                              int num_rel, int num_rel_graph, void* stream) {
  using namespace relgat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const unsigned col_blocks =
      static_cast<unsigned>((hf + kColsPerBlock - 1) / kColsPerBlock);
  if (num_chunks > 0) {
    relgat_bwd_rel_partial_kernel<<<dim3(num_chunks, col_blocks),
                                    kColsPerBlock, 0, st>>>(
        h, de, gsum, src, dst, rel_eid, chunk_start, chunk_end, part_attn,
        part_bias, heads, feat);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  relgat_bwd_rel_reduce_kernel<<<dim3(num_rel, col_blocks), kColsPerBlock, 0,
                                 st>>>(part_attn, part_bias, rel_chunk_ptr,
                                       dattn, dbias, heads, feat, num_rel,
                                       num_rel_graph);
  return static_cast<int>(cudaGetLastError());
}
