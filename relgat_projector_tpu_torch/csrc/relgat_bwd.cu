// RelGAT propagate backward for Hopper (sm_90a).
//
// Replaces the TPU kernel relgat_projector_tpu/ops/pallas/fused.py
// `_bwd_src_kernel` (launched by `fused_relgat_backward_src`). Given the
// output cotangent g, the forward's per-(dst, head) max m and sum l, the
// per-(dst, head) S = <out - bias, g> and the per-dst gsum = sum_{h,f} g,
// each edge (s -> d, relation r) gives
//   alpha = exp(LeakyReLU(<h[s], attn[r]>) - m[d]) / max(l[d], eps)
//   k     = keep / (1 - rate)            (the forward's dropout mask, replayed)
//   de    = alpha * (k * <h[s], g[d]> - S[d]) * LeakyReLU'(.)
//   dh[s]    += alpha * k * g[d] + de * attn[r]
//   dattn[r] += de * h[s]
//   dbias[r] += gsum[d]
//
// dattn needs h once per source row, not once per edge:
//   dattn[hd, r] = sum_s W[s, hd, r] * h[s, hd],  W[s, hd, r] = sum of de[e, hd]
//   dbias[r]     = sum_s B[s, r],                 B[s, r]     = sum of gsum[dst_e]
// over the edges e with src s and relation r. The TPU kernel carries dattn
// and dbias across its sequential grid; blocks on this card run in no order,
// so the work is two kernels, both without atomics, hence deterministic:
//   relgat_bwd_src_kernel   one warp per (work item, head) walks the item's
//       out-edges in src-CSR order with h[s] and the dh accumulator in
//       registers. A work item (data/csr.py build_bwd_plan) is a source row
//       of at most bwd_item_edges out-edges, rows without out-edges
//       included, or one chunk of that many consecutive out-edges of a
//       longer row, so a hub row costs its edges spread over many blocks
//       and not one warp's serial walk. The warp folds each edge's de into
//       a slab of R floats in shared memory that only it touches (the
//       head-0 warp folds gsum[d] into one more), lane 0 adding edge by
//       edge. A whole row's item writes dh[s] and the slabs as W[s, head, :]
//       and B[s, :], zeros included; a chunk writes the same rows at row
//       N + slot of the same arrays, after their N source rows, and
//       relgat_bwd_src_merge_kernel adds each split row's partial rows in
//       chunk order (one thread a value, the first chunk first) into dh[s],
//       W[s] and B[s]. So the bits depend on the
//       plan and not on the run, and a row that no plan splits gets the
//       same bits as before the plan. W costs N*H*R*4 bytes (256 MB at
//       N = 100k, H = 16, R = 40), B N*R*4; no per-edge array is written
//       (the per-edge de [E, H] of the first design was 64 MB at 1M edges).
//   relgat_bwd_rel_*        a streaming reduction over node rows: each block
//       takes a tile of kRelTileRows rows of one head, stages W and h through
//       shared memory with cp.async (kRelStages buffers), accumulates an
//       [R, F] partial in registers and writes it; a second kernel sums the
//       partials in tile order (relgat_bwd_rel_mma_kernel, for bf16 h, does
//       the same on the tensor cores over longer runs of rows).
//
// What bounds them: relgat_bwd_src gathers one F-wide row of g per (edge,
// head) (E * H*F * 4 bytes, 8.2 GB at 1M edges and H*F = 2048), far more
// than the bytes it must move once; it runs near the rate at which this
// card gathers such rows, and that rate rises with the warps in flight.
// So the design keeps registers at 40 (48 warps an SM): the lanes load the
// indices and per-dst scalars of up to 32 edges at once into a per-warp
// table in shared memory, rows are read 16 bytes a lane, and one 6-shuffle
// reduction gives both dot products: 48 warps x 512 bytes is 24 KB of rows
// in flight an SM. relgat_bwd_rel reads h and W once (1.09 GB at those
// shapes) for 2*N*H*R*F flops, close to the card's balance point; each
// thread keeps an RM x 4 tile of the [R, F] sum so shared-memory reads stay
// under the FMA rate.
//
// The bf16 variants (relgat_bwd_src_bf16, relgat_bwd_rel_bf16;
// kernel_precision="default") read h and g as bf16 rows, the TPU kernel's
// `packed_bf16` streams (kernels.py `_packed_stream`, `_bwd_from_packed`):
// half the bytes of the g gather. The statistics m, l, S, gsum stay fp32
// [N, H] arrays read into the edge table (the TPU packs them as bf16
// (hi, lo) pairs only to ride its one wide gather); dh, W, B, dattn and
// dbias, and all arithmetic, stay fp32. As in the forward, where F is a
// multiple of 8 and at most 128, relgat_bwd_src_pair_kernel gives a warp
// two adjacent heads of one source row, a half-warp each, so its load of
// an edge's g row is one contiguous 512-byte piece (F = 128) and a block of
// 8 warps reads the whole 4 KB row; other widths run relgat_bwd_src_kernel
// on bf16 rows. What bounds it is the same gather, 4.1 GB of g rows at
// 1M edges and H*F = 2048 (a 1.22 ms floor at 3.35 TB/s; the bound of the
// bytes each tensor must move once is 0.58 ms). On this card the size of
// each warp's contiguous piece, not the bytes in flight (32 warps x 512
// bytes = 16 KB an SM), set the rate; PERF.md section 6 records the designs
// measured against this one. relgat_bwd_rel_bf16 runs the fp32 tile
// kernel's FMA loop on bf16 h (kRelDesignTile), which that loop bounds, or
// dattn = W^T h on the tensor cores as three exact bf16 products
// (kRelDesignMma, relgat_bwd_rel_mma_kernel below), which the bytes bound;
// ops/cuda/fused.py design_of picks one by width, as measured.
//
// Wider heads (F > 128, up to 1024), fp32 or bf16 rows:
// relgat_bwd_src_ring_kernel gives a block a work item and a group of up to
// kRingBwdGroupHeads heads. A producer warp copies the group's slice of
// g[dst] of each out-edge into a ring of shared-memory stages with one bulk
// copy (cp.async.bulk) on the stage's mbarrier, as the forward's ring does;
// one consumer warp a head keeps h[s] and the dh sum in registers with
// every lane busy, loads the per-edge values of 32 out-edges at a time
// into a table of its own in shared memory, and folds de (head 0 also
// gsum) into its slab as relgat_bwd_src_kernel does: dh, W and B are
// written once, without atomics. On the card it is faster than the
// one-warp-a-head template at most widths (6.40 against 8.59 ms fp32, 4.81
// against 6.87 bf16 at 12 x 300; 6.41 against 6.66 fp32 at 16 x 200) and
// slower at some (fp32 past 520 features, bf16 at 496-512), so the
// dispatch takes it where it measured faster (ops/cuda/fused.py
// RING_RANGES).
//
// On bf16 rows the ring takes an edge's attn terms by (source row, head,
// relation), not by edge: they depend on the edge only through s and its
// relation r, so
//   <h[s], attn[r]>           = P[s, hd, r],  P = h attn^T   [N, H, R]
//   sum_e de_e attn[rel_e]    = sum_r W[s, hd, r] attn[hd, r]
// and the loop loads no attn row (each was 1 KB from L2 an edge and head at
// F = 256, twice the bf16 g slice the stage delivers). Three kernels:
// relgat_bwd_src_logits_kernel writes P into the W buffer (no new array;
// an item reads P[s] into its edge table and writes W[s] only after its
// loop, a chunk of a split row writes rows N + slot, the merge W[s] last),
// the ring loop (dalpha, one dot product, then alpha, de, dh += aw g and
// the slab), the merge, then relgat_bwd_src_fold_kernel adds W attn into
// dh. The two products cost N * H * R * F whatever the edges, so on sparse
// graphs the bf16 ring keeps the per-edge loop (kKernelRing; the
// rule is ops/cuda/fused.py ring_src_loop). The fp32 ring keeps the
// per-edge loop (its g slice is as wide as the attn row, which hides that
// load).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "relgat_common.cuh"

namespace relgat {

// Shared memory relgat_bwd_src may take for its edge tables and slabs.
constexpr int kMaxBwdSmemBytes = 48 * 1024;

// What relgat_bwd_src needs of one edge besides its rows.
struct alignas(16) EdgeEntry {
  float m_safe;  // m[d], -inf read as 0 (m_safe of fused.py; d has an edge)
  float denom;   // max(l[d], eps)
  float s;       // S[d]
  float keep;    // dropout keep / (1 - rate), or 1
  int dst;
  int rel;
  float gsum;  // gsum[d], loaded for the head-0 warp only
  float pad;
};

// Sums a and b over the warp in 6 shuffles, not the 10 of two butterflies:
// the first step leaves lanes 0-15 with pair sums of a and lanes 16-31 with
// pair sums of b, four butterfly steps finish each half, and a last shuffle
// swaps the halves. Every lane ends with the same bits of both sums.
__device__ __forceinline__ void warp_sum2(float& a, float& b, int lane) {
  const bool upper = (lane & 16) != 0;
  float mine = upper ? b : a;
  mine += __shfl_xor_sync(kFullMask, upper ? a : b, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) mine += __shfl_xor_sync(kFullMask, mine, o);
  const float other = __shfl_xor_sync(kFullMask, mine, 16);
  a = upper ? other : mine;
  b = upper ? mine : other;
}

// The row a src-pass work item writes in dh, W and B: an item with slot -1
// is its row's only one and writes row s; a chunk of a split row writes row
// num_rows + slot, one of the partial rows kept after the num_rows source
// rows of the same arrays, which relgat_bwd_src_merge_kernel adds into row
// s. The item is read again here, after the edge loop, by a volatile load
// that the compiler neither merges with the first read nor hoists, so that
// nothing of it stays in registers across the loop.
__device__ __forceinline__ int64_t item_row(const int4* item, int num_rows) {
  int s, p0, p1, slot;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(s), "=r"(p0), "=r"(p1), "=r"(slot)
               : "l"(item));
  return slot < 0 ? s : static_cast<int64_t>(num_rows) + slot;
}

// Six blocks an SM (48 warps, at most 40 registers a thread) where a lane
// holds at most 4 floats of a row; wider rows would spill under that bound.
// T is the element type of h and g.
template <int VEC, int NV, typename T>
__global__ void
__launch_bounds__(32 * kMaxWarpsPerBlock, VEC * NV <= 4 ? 6 : 1)
relgat_bwd_src_kernel(const T* __restrict__ h,          // [N, H*F]
                      const T* __restrict__ g,          // [N, H*F]
                      const float* __restrict__ attn,   // [H, R, F]
                      const float* __restrict__ m,      // [N, H]
                      const float* __restrict__ l,      // [N, H]
                      const float* __restrict__ s_dot,  // [N, H]
                      const float* __restrict__ gsum,   // [N]
                      const int4* __restrict__ items,   // [J] (s, p0, p1, slot)
                      const int* __restrict__ dst,      // [E] src-sorted
                      const int* __restrict__ etype,    // [E] src-sorted
                      const int* __restrict__ eid,      // [E] src-sorted
                      float* __restrict__ dh,           // [N + P, H*F]
                      float* __restrict__ w_out,        // [N + P, H, R]
                      float* __restrict__ b_out,        // [N + P, R]
                      int num_rows,
                      int heads, int feat, int num_rel, float slope,
                      float eps, int use_dropout, uint32_t seed, uint32_t thr,
                      float keep_prob) {
  constexpr int FPL = VEC * NV;
  // One table of 32 edges per warp, then one slab of R floats per warp and
  // the head-0 warp's B slab.
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int head = blockIdx.y * warps + warp;
  if (head >= heads) return;
  // the item's fields one by one, each where it is used: a 16-byte load
  // took four registers at once and pushed the template into spills
  const int* item = reinterpret_cast<const int*>(items + blockIdx.x);
  const int s = item[0];
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;
  EdgeEntry* table = reinterpret_cast<EdgeEntry*>(smem) + warp * 32;
  float* slabs = smem + warps * 32 * (sizeof(EdgeEntry) / sizeof(float));
  float* slab = slabs + warp * num_rel;
  // the head-0 warp also folds gsum[d] into the B slab (a flag, not a
  // null pointer: a generic pointer took registers the loop needs)
  const bool head0 = head == 0;
  float* bslab = slabs + warps * num_rel;
  for (int r = lane; r < num_rel; r += 32) {
    slab[r] = 0.f;
    if (head0) bslab[r] = 0.f;
  }

  float hv[FPL];
  float acc[FPL];
  load_row<VEC, NV>(h + row, feat, lane, hv);
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
  const T* g_head = g + static_cast<int64_t>(head) * feat;
  const float* attn_head = attn + static_cast<int64_t>(head) * num_rel * feat;

  const int p_end = item[2];
  for (int p0 = item[1]; p0 < p_end; p0 += 32) {
    const int cnt = min(32, p_end - p0);
    __syncwarp();  // the last batch's table reads (and slab zeroing) are done
    if (lane < cnt) {
      const int p = p0 + lane;
      EdgeEntry e;
      e.dst = dst[p];
      e.rel = etype[p];
      const int64_t di = static_cast<int64_t>(e.dst) * heads + head;
      const float mv = m[di];
      e.m_safe = mv == -INFINITY ? 0.f : mv;
      e.denom = fmaxf(l[di], eps);
      e.s = s_dot[di];
      e.keep = use_dropout
                   ? dropout_keep(eid[p], head, seed, thr) / keep_prob
                   : 1.f;
      e.gsum = head0 ? gsum[e.dst] : 0.f;
      e.pad = 0.f;
      table[lane] = e;
    }
    __syncwarp();
    for (int j = 0; j < cnt; ++j) {
      const EdgeEntry e = table[j];
      float gv[FPL];
      float av[FPL];
      load_row<VEC, NV>(g_head + e.dst * hf, feat, lane, gv);
      load_row<VEC, NV>(attn_head + static_cast<int64_t>(e.rel) * feat, feat,
                        lane, av);
      float eraw = 0.f;
      float dalpha = 0.f;
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        eraw += hv[i] * av[i];
        dalpha += hv[i] * gv[i];
      }
      warp_sum2(eraw, dalpha, lane);
      const float alpha = expf(leaky_relu(eraw, slope) - e.m_safe) / e.denom;
      const float de =
          alpha * (dalpha * e.keep - e.s) * (eraw >= 0.f ? 1.f : slope);
      const float aw = alpha * e.keep;
#pragma unroll
      for (int i = 0; i < FPL; ++i) acc[i] += aw * gv[i] + de * av[i];
      if (lane == 0) {
        slab[e.rel] += de;
        if (head0) bslab[e.rel] += e.gsum;
      }
    }
  }

  const int64_t orow = item_row(items + blockIdx.x, num_rows);
  store_row<VEC, NV>(dh + orow * hf + static_cast<int64_t>(head) * feat, feat,
                     lane, acc);
  __syncwarp();
  float* wrow = w_out + (orow * heads + head) * num_rel;
  for (int r = lane; r < num_rel; r += 32) {
    wrow[r] = slab[r];
    if (head0) b_out[orow * num_rel + r] = bslab[r];
  }
}

// Four blocks an SM for the pair kernel (32 warps, at most 64 registers): a
// lane holds 8 features of h, of g, of attn and of the dh sum, which fit
// 64 registers without spills.
constexpr int kBwdPairMinBlocks = 4;

// relgat_bwd_src_kernel over bf16 rows of F <= 128 with F % 8 == 0, in
// blocks of (work item, group of up to 16 heads): warp w takes the two
// adjacent heads 2w and 2w + 1 of the group, half-warp `half` the second,
// lane hl features 8*hl .. 8*hl + 7 of its head. So a warp's load of an
// edge's g row is one contiguous 512-byte piece at F = 128, and a block's
// eight warps read the whole 4 KB row of each edge together. The lanes of
// each half load their head's per-edge values of up to 16 edges at once
// into the warp's table; each half walks the row's out-edges in order, and
// its lane 0 folds its head's de (warp 0's lane 0 also gsum) into the
// head's slab edge by edge, so W and B are summed as relgat_bwd_src_kernel
// sums them. Shared memory: the warps' tables of 2 x 16 edges, then one
// slab of R floats per head and the B slab.
__global__ void
__launch_bounds__(32 * kMaxWarpsPerBlock, kBwdPairMinBlocks)
relgat_bwd_src_pair_kernel(const __nv_bfloat16* __restrict__ h,  // [N, H*F]
                           const __nv_bfloat16* __restrict__ g,  // [N, H*F]
                           const float* __restrict__ attn,   // [H, R, F]
                           const float* __restrict__ m,      // [N, H]
                           const float* __restrict__ l,      // [N, H]
                           const float* __restrict__ s_dot,  // [N, H]
                           const float* __restrict__ gsum,   // [N]
                           const int4* __restrict__ items,   // [J] (s, p0, p1, slot)
                           const int* __restrict__ dst,      // [E]
                           const int* __restrict__ etype,    // [E]
                           const int* __restrict__ eid,      // [E]
                           float* __restrict__ dh,           // [N + P, H*F]
                           float* __restrict__ w_out,        // [N + P, H, R]
                           float* __restrict__ b_out,        // [N + P, R]
                           int num_rows,
                           int heads, int feat, int num_rel, float slope,
                           float eps, int use_dropout, uint32_t seed,
                           uint32_t thr, float keep_prob) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int hl = lane & 15;
  const int f = 8 * hl;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int pair = blockIdx.y * warps + warp;
  if (2 * pair >= heads) return;
  // an odd head count leaves the last warp's second half without a head:
  // it reads nothing and writes nothing, but joins the shuffles
  const int head = 2 * pair + half;
  const bool active = head < heads;
  const bool in_row = active && f < feat;
  const int* item = reinterpret_cast<const int*>(items + blockIdx.x);
  const int s = item[0];
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;
  EdgeEntry* table = reinterpret_cast<EdgeEntry*>(smem) + warp * 32 + 16 * half;
  float* slabs = smem + warps * 32 * (sizeof(EdgeEntry) / sizeof(float));
  float* slab = slabs + (2 * warp + half) * num_rel;
  const bool head0 = head == 0;  // as in relgat_bwd_src_kernel
  float* bslab = slabs + 2 * warps * num_rel;
  if (active) {
    for (int r = hl; r < num_rel; r += 16) {
      slab[r] = 0.f;
      if (head0) bslab[r] = 0.f;
    }
  }

  float hv[8];
  float acc[8];
  widen8(in_row ? *reinterpret_cast<const uint4*>(h + row + f)
                : make_uint4(0u, 0u, 0u, 0u),
         hv);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const __nv_bfloat16* g_head = g + static_cast<int64_t>(head) * feat + f;
  const float* attn_head =
      attn + static_cast<int64_t>(head) * num_rel * feat + f;

  const int p_end = item[2];
  for (int p0 = item[1]; p0 < p_end; p0 += 16) {
    const int cnt = min(16, p_end - p0);
    __syncwarp();  // the last batch's table reads (and slab zeroing) are done
    if (active && hl < cnt) {
      const int p = p0 + hl;
      EdgeEntry e;
      e.dst = dst[p];
      e.rel = etype[p];
      const int64_t di = static_cast<int64_t>(e.dst) * heads + head;
      const float mv = m[di];
      e.m_safe = mv == -INFINITY ? 0.f : mv;
      e.denom = fmaxf(l[di], eps);
      e.s = s_dot[di];
      e.keep = use_dropout
                   ? dropout_keep(eid[p], head, seed, thr) / keep_prob
                   : 1.f;
      e.gsum = head0 ? gsum[e.dst] : 0.f;
      e.pad = 0.f;
      table[hl] = e;
    }
    __syncwarp();
    for (int j = 0; j < cnt; ++j) {
      EdgeEntry e = table[j];
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 a1 = a0;
      if (in_row) {
        x = *reinterpret_cast<const uint4*>(g_head + e.dst * hf);
        const float* ap = attn_head + static_cast<int64_t>(e.rel) * feat;
        a0 = *reinterpret_cast<const float4*>(ap);
        a1 = *reinterpret_cast<const float4*>(ap + 4);
      }
      float gv[8];
      widen8(x, gv);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float eraw = 0.f;
      float dalpha = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        eraw += hv[i] * av[i];
        dalpha += hv[i] * gv[i];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {  // within the half-warp
        eraw += __shfl_xor_sync(kFullMask, eraw, o);
        dalpha += __shfl_xor_sync(kFullMask, dalpha, o);
      }
      if (!active) continue;
      const float alpha = expf(leaky_relu(eraw, slope) - e.m_safe) / e.denom;
      const float de =
          alpha * (dalpha * e.keep - e.s) * (eraw >= 0.f ? 1.f : slope);
      const float aw = alpha * e.keep;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += aw * gv[i] + de * av[i];
      if (hl == 0) {
        slab[e.rel] += de;
        if (head0) bslab[e.rel] += e.gsum;
      }
    }
  }

  const int64_t orow = item_row(items + blockIdx.x, num_rows);
  if (in_row) {
    float* dst_row = dh + orow * hf + static_cast<int64_t>(head) * feat + f;
    *reinterpret_cast<float4*>(dst_row) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst_row + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncwarp();
  if (!active) return;
  float* wrow = w_out + (orow * heads + head) * num_rel;
  for (int r = hl; r < num_rel; r += 16) {
    wrow[r] = slab[r];
    if (head0) b_out[orow * num_rel + r] = bslab[r];
  }
}

// What a ring consumer warp needs of one out-edge besides its rows, for its
// head: a per-warp table of 32 in shared memory.
struct alignas(16) RingEntry {
  float m_safe;     // m[d], -inf read as 0
  float inv_denom;  // 1 / max(l[d], eps)
  float s;          // S[d]
  float keep;       // dropout keep / (1 - rate), or 1
  int dst;
  int rel;
  float gsum;   // gsum[d], for the head-0 warp only
  float logit;  // P[s, head, rel] in the factored loop, else unused
};

// Heads wider than 128 features, fp32 or bf16 rows. Block (work item of src
// row s, group of up to kRingBwdGroupHeads heads): warps 0 .. G-1 are the
// group's heads, one each, and warp G the producer, which streams the group's
// slice of g[dst] of each of the item's out-edges, in src-CSR order, through
// `stages` ring stages of
// `stage_elems` values with one bulk copy an edge. A head's warp keeps h[s]
// and the dh sum in registers, all lanes busy (the VW layout of
// relgat_common.cuh); its lanes load the
// per-edge values of 32 out-edges at a time (dst, relation, m, 1 / l, S,
// the dropout keep, and gsum for head 0) into the warp's RingEntry table.
// Per edge it loads its attn row, waits for the stage, reads its F values
// of g[dst] and releases the stage, then computes alpha and de as
// relgat_bwd_src_kernel does and folds de (and, head 0, gsum[dst]) into its
// slab in shared memory. dh, W and B are written once, as there.
// FACTORED (bf16 rows): the table also takes each edge's logit P[s, head,
// rel] from w_out (relgat_bwd_src_logits_kernel's), and the loop loads no
// attn row: one dot product, <h[s], g[d]>, and dh += aw g only; the de
// attn[rel] terms come later, summed by relation (the fold kernel).
template <int NK, int VW, typename T, bool FACTORED>
__global__ void __launch_bounds__(32 * (kRingBwdGroupHeads + 1),
                                  (FACTORED ? ring_bwd_factored_warps<NK>()
                                            : ring_bwd_warps<NK>()) /
                                      (kRingBwdGroupHeads + 1))
relgat_bwd_src_ring_kernel(const T* __restrict__ h,          // [N, H*F]
                           const T* __restrict__ g,          // [N, H*F]
                           const float* __restrict__ attn,   // [H, R, F]
                           const float* __restrict__ m,      // [N, H]
                           const float* __restrict__ l,      // [N, H]
                           const float* __restrict__ s_dot,  // [N, H]
                           const float* __restrict__ gsum,   // [N]
                           const int4* __restrict__ items,   // [J] (s, p0, p1, slot)
                           const int* __restrict__ dst,      // [E]
                           const int* __restrict__ etype,    // [E]
                           const int* __restrict__ eid,      // [E]
                           float* __restrict__ dh,           // [N + P, H*F]
                           float* __restrict__ w_out,        // [N + P, H, R]
                           float* __restrict__ b_out,        // [N + P, R]
                           int num_rows,
                           int head_groups, int group_heads, int heads,
                           int feat, int num_rel, int stages, int stage_elems,
                           float slope, float eps, int use_dropout,
                           uint32_t seed, uint32_t thr, float keep_prob) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  T* ring = reinterpret_cast<T*>(ring_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_elems);
  uint64_t* empty = full + stages;
  // a table of 32 out-edges a consumer warp, then one slab of R floats a
  // head of the group and the B slab
  RingEntry* tables = reinterpret_cast<RingEntry*>(empty + stages);
  float* slabs = reinterpret_cast<float*>(tables + group_heads * 32);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int4 item = items[blockIdx.x / head_groups];
  const int s = item.x;
  const int h0 = (blockIdx.x % head_groups) * group_heads;
  const int gh = min(group_heads, heads - h0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], gh);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < (group_heads + 1) * num_rel; i += blockDim.x)
    slabs[i] = 0.f;
  __syncthreads();
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const T* g_group = g + static_cast<int64_t>(h0) * feat;
  const int p_begin = item.y;
  const int p_end = item.z;

  if (warp == group_heads) {  // the producer
    int st = 0;
    uint32_t ph = 0;
    for (int p0 = p_begin; p0 < p_end; p0 += 32) {
      const int cnt = min(32, p_end - p0);
      const int my_dst = lane < cnt ? dst[p0 + lane] : 0;
      for (int j = 0; j < cnt; ++j) {
        const int d = __shfl_sync(kFullMask, my_dst, j);
        mbar_wait(&empty[st], ph ^ 1);  // the first round passes at once
        ring_load(ring + st * stage_elems, &full[st], g_group + d * hf,
                  gh * feat, lane);
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  if (warp >= gh) return;

  const int head = h0 + warp;
  float* slab = slabs + warp * num_rel;
  float* bslab = head == 0 ? slabs + group_heads * num_rel : nullptr;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;
  const float* attn_head = attn + static_cast<int64_t>(head) * num_rel * feat;
  float hv[NK];
  float acc[NK];
  lane_row<NK, VW>(h + row, feat, lane, hv);
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = 0.f;
  RingEntry* table = tables + warp * 32;
  int st = 0;
  uint32_t ph = 0;
  for (int p0 = p_begin; p0 < p_end; p0 += 32) {
    const int cnt = min(32, p_end - p0);
    __syncwarp();  // the last batch's table reads are done
    if (lane < cnt) {  // lane j: out-edge p0 + j
      const int p = p0 + lane;
      RingEntry e;
      e.dst = dst[p];
      e.rel = etype[p];
      const int64_t di = static_cast<int64_t>(e.dst) * heads + head;
      const float mv = m[di];
      e.m_safe = mv == -INFINITY ? 0.f : mv;  // m_safe of fused.py
      e.inv_denom = 1.f / fmaxf(l[di], eps);
      e.s = s_dot[di];
      e.keep = use_dropout
                   ? dropout_keep(eid[p], head, seed, thr) / keep_prob
                   : 1.f;
      e.gsum = bslab != nullptr ? gsum[e.dst] : 0.f;
      // w_out row s holds P until this item's (or the merge's) W lands
      e.logit = FACTORED ? w_out[(static_cast<int64_t>(s) * heads + head) *
                                     num_rel + e.rel]
                         : 0.f;
      table[lane] = e;
    }
    __syncwarp();
    for (int j = 0; j < cnt; ++j) {
      const RingEntry e = table[j];
      const int d = e.dst;
      const int rel = e.rel;
      float av[NK];
      if constexpr (!FACTORED)
        lane_row<NK, VW>(attn_head + static_cast<int64_t>(rel) * feat, feat,
                         lane, av);
      const T* grow = ring + st * stage_elems +
                      ring_shift(g_group + d * hf) + warp * feat;
      mbar_wait(&full[st], ph);
      float gv[NK];
      lane_row<NK, VW>(grow, feat, lane, gv);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
      float eraw = 0.f;
      float dalpha = 0.f;
      if constexpr (FACTORED) {
#pragma unroll
        for (int k = 0; k < NK; ++k) dalpha += hv[k] * gv[k];
        dalpha = warp_sum(dalpha);
        eraw = e.logit;
      } else {
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          eraw += hv[k] * av[k];
          dalpha += hv[k] * gv[k];
        }
        warp_sum2(eraw, dalpha, lane);
      }
      const float alpha = expf(leaky_relu(eraw, slope) - e.m_safe) * e.inv_denom;
      const float de =
          alpha * (dalpha * e.keep - e.s) * (eraw >= 0.f ? 1.f : slope);
      const float aw = alpha * e.keep;
      if constexpr (FACTORED) {
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[k] += aw * gv[k];
      } else {
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[k] += aw * gv[k] + de * av[k];
      }
      if (lane == 0) {
        slab[rel] += de;
        if (bslab != nullptr) bslab[rel] += e.gsum;
      }
    }
  }

  const int64_t orow = item_row(items + blockIdx.x / head_groups, num_rows);
  lane_store<NK, VW>(dh + orow * hf + static_cast<int64_t>(head) * feat, feat,
                     lane, acc);
  __syncwarp();
  float* wrow = w_out + (orow * heads + head) * num_rel;
  for (int r = lane; r < num_rel; r += 32) {
    wrow[r] = slab[r];
    if (bslab != nullptr) b_out[orow * num_rel + r] = bslab[r];
  }
}

// Threads of a merge block.
constexpr int kBwdMergeThreads = 256;

// Block (split source row, tile of kBwdMergeThreads values of its dh, W and
// B rows, H*F + H*R + R in all): thread i adds value i of the row's partial
// rows num_rows + [c0, c1) in chunk order and writes the sum once into row
// s, so every value has one fixed order of additions and no atomics.
__global__ void __launch_bounds__(kBwdMergeThreads)
relgat_bwd_src_merge_kernel(const int* __restrict__ merge,  // [T, 3] (s, c0, c1)
                            float* __restrict__ dh,         // [N + P, H*F]
                            float* __restrict__ w_out,      // [N + P, H, R]
                            float* __restrict__ b_out,      // [N + P, R]
                            int num_rows, int hf, int hr, int num_rel) {
  const int s = merge[3 * blockIdx.x];
  const int c0 = num_rows + merge[3 * blockIdx.x + 1];
  const int c1 = num_rows + merge[3 * blockIdx.x + 2];
  int j = blockIdx.y * kBwdMergeThreads + threadIdx.x;
  float* out = dh;
  int width = hf;
  if (j >= hf) {
    j -= hf;
    out = w_out;
    width = hr;
    if (j >= hr) {
      j -= hr;
      out = b_out;
      width = num_rel;
      if (j >= num_rel) return;
    }
  }
  float sum = 0.f;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) sum += out[static_cast<int64_t>(c) * width + j];
  out[static_cast<int64_t>(s) * width + j] = sum;
}

// ---------------------------------------------------------------------------
// dattn = W^T h per head and dbias = sum_s B[s], over node rows.

constexpr int kRelWarps = 4;
constexpr int kRelThreads = 32 * kRelWarps;
constexpr int kRelStageRows = 16;  // node rows per shared-memory stage
constexpr int kRelStages = 3;      // shared-memory buffers in flight
constexpr int kRelTileRows = 512;  // node rows per block, one partial each
constexpr int kRelCols = 128;      // features per block, 4 per lane

// cp.async of VEC floats into shared memory; with valid false it writes
// zeros there and reads nothing (src-size 0). 16-byte copies bypass L1.
template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// The same for VEC bf16 values: 8 (16 bytes) or 4 (8 bytes) as raw bits,
// converted where they are read; one value (2 bytes, below cp.async's
// smallest size) by a plain load and store, which the stage's wait and
// barrier order as well.
template <int VEC>
__device__ __forceinline__ void cp_async(__nv_bfloat16* smem,
                                         const __nv_bfloat16* gmem,
                                         bool valid) {
  if constexpr (VEC == 8) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (VEC == 4) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    static_assert(VEC == 1, "bf16 copies are of 8 values, 4 or 1");
    *smem = valid ? *gmem : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (tile, head, relation tile x feature tile): warp w sums relations
// r0 + w*RM .. r0 + w*RM + RM - 1, lane i features f0 + i + 32*j (j < 4),
// over the tile's rows. Blocks of head 0 and the first feature tile also
// sum B over the tile's rows, one relation per thread. VH and VW are the
// copy widths of h and of W/B rows (16 bytes where rows are 16-byte
// aligned: VH 4 of fp32 h, 8 of bf16; VW 4), and TH the element type of h.
template <int RM, int VH, int VW, typename TH>
__global__ void __launch_bounds__(kRelThreads)
relgat_bwd_rel_tile_kernel(const TH* __restrict__ h,  // [N, H*F]
                           const float* __restrict__ w,  // [N, H, R]
                           const float* __restrict__ b,  // [N, R]
                           float* __restrict__ part_attn,  // [T, H, R, F]
                           float* __restrict__ part_bias,  // [T, R]
                           int num_nodes, int heads, int feat, int num_rel,
                           int col_tiles) {
  constexpr int RT = kRelWarps * RM;  // relations per block
  constexpr int HC = kRelCols / VH;   // copies per h row
  constexpr int HR = kRelThreads / HC;  // h rows per pass of the block
  constexpr int WC = RT / VW;         // copies per W row
  // Width of a warp's read of its RM relations of a W row.
  constexpr int RV = RM % 4 == 0 ? 4 : (RM % 2 == 0 ? 2 : 1);
  static_assert(RT % VW == 0 && kRelStageRows % HR == 0, "tile shapes");
  __shared__ __align__(16) TH hs[kRelStages][kRelStageRows][kRelCols];
  __shared__ __align__(16) float ws[kRelStages][kRelStageRows][RT];
  __shared__ __align__(16) float bs[kRelStages][kRelStageRows][RT];

  const int tile = blockIdx.x;
  const int head = blockIdx.y;
  const int r0 = (blockIdx.z / col_tiles) * RT;
  const int f0 = (blockIdx.z % col_tiles) * kRelCols;
  const bool with_bias = head == 0 && f0 == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = tile * kRelTileRows;
  const int n1 = min(n0 + kRelTileRows, num_nodes);
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  // This thread's h copies: column hc of rows hk, hk + HR, ...
  const int hc = threadIdx.x % HC;
  const int hk = threadIdx.x / HC;
  const bool h_col_ok = f0 + VH * hc < feat;
  const TH* h_col = h + static_cast<int64_t>(head) * feat + f0 + VH * hc;

  // Rows nb .. nb + kRelStageRows into buffer buf; rows past the tile and
  // columns past F or R read as zeros, so they add exactly nothing.
  auto stage = [&](int buf, int nb) {
#pragma unroll
    for (int k = hk; k < kRelStageRows; k += HR) {
      const int n = nb + k;
      const bool ok = h_col_ok && n < n1;
      cp_async<VH>(&hs[buf][k][VH * hc], ok ? h_col + n * hf : h, ok);
    }
#pragma unroll
    for (int i = threadIdx.x; i < kRelStageRows * WC; i += kRelThreads) {
      const int k = i / WC;
      const int c = VW * (i % WC);
      const int n = nb + k;
      const bool ok = n < n1 && r0 + c < num_rel;
      const int64_t wi =
          (static_cast<int64_t>(n) * heads + head) * num_rel + r0 + c;
      cp_async<VW>(&ws[buf][k][c], ok ? w + wi : w, ok);
      if (with_bias) {
        const int64_t bi = static_cast<int64_t>(n) * num_rel + r0 + c;
        cp_async<VW>(&bs[buf][k][c], ok ? b + bi : b, ok);
      }
    }
    cp_async_commit();
  };

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;

  const int steps = (n1 - n0 + kRelStageRows - 1) / kRelStageRows;
#pragma unroll
  for (int q = 0; q < kRelStages - 1; ++q) {
    if (q < steps) stage(q, n0 + q * kRelStageRows);
    else cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    const int buf = st % kRelStages;
    const int next = st + kRelStages - 1;
    if (next < steps) stage(next % kRelStages, n0 + next * kRelStageRows);
    else cp_async_commit();
    cp_async_wait<kRelStages - 1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRelStageRows; ++k) {
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = to_float(hs[buf][k][lane + 32 * j]);
      float wv[RM];
      const float* wr = &ws[buf][k][warp * RM];
#pragma unroll
      for (int q = 0; q < RM / RV; ++q) {
        if constexpr (RV == 4) {
          const float4 v = *reinterpret_cast<const float4*>(wr + 4 * q);
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        } else if constexpr (RV == 2) {
          const float2 v = *reinterpret_cast<const float2*>(wr + 2 * q);
          wv[2 * q] = v.x;
          wv[2 * q + 1] = v.y;
        } else {
          wv[q] = wr[q];
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], hv[j], acc[i][j]);
    }
    if (with_bias && threadIdx.x < RT) {
#pragma unroll
      for (int k = 0; k < kRelStageRows; ++k) bacc += bs[buf][k][threadIdx.x];
    }
    __syncthreads();  // a later stage's copies overwrite this buffer
  }

  float* pa = part_attn +
              (static_cast<int64_t>(tile) * heads + head) * num_rel * feat;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + warp * RM + i;
    if (r >= num_rel) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + lane + 32 * j;
      if (f < feat) pa[static_cast<int64_t>(r) * feat + f] = acc[i][j];
    }
  }
  if (with_bias && threadIdx.x < RT && r0 + static_cast<int>(threadIdx.x) < num_rel)
    part_bias[static_cast<int64_t>(tile) * num_rel + r0 + threadIdx.x] = bacc;
}

// Sums the partials of every tile in tile order: dattn [H, R, F] is the
// flat sum of part_attn [T, H*R*F], dbias [R] that of part_bias
// [bias_parts, R] (T of them in the tile design).
__global__ void __launch_bounds__(256)
relgat_bwd_rel_reduce_kernel(const float* __restrict__ part_attn,
                             const float* __restrict__ part_bias,
                             float* __restrict__ dattn,
                             float* __restrict__ dbias, int num_tiles,
                             int64_t total, int num_rel, int bias_parts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) {
    float a = 0.f;
#pragma unroll 8
    for (int t = 0; t < num_tiles; ++t) a += part_attn[t * total + i];
    dattn[i] = a;
  }
  if (i < num_rel) {
    float s = 0.f;
    for (int t = 0; t < bias_parts; ++t) s += part_bias[t * num_rel + i];
    dbias[i] = s;
  }
}

// ---------------------------------------------------------------------------
// relgat_bwd_rel_bf16 on the tensor cores (kRelDesignMma).
//
// The TPU kernel computes this sum as a matrix-unit dot with
// precision=HIGHEST (fused.py `_bwd_src_kernel`, the `onehot_r.T @ deps`
// dot): several bf16 passes. Here, per head, dattn = W^T h is a GEMM with
// M = relations, N = features and K = node rows, and h is already bf16.
// Each fp32 W value is split exactly into three bf16 pieces by truncation,
//   hi = trunc(W), mid = trunc(W - hi), lo = W - hi - mid,
// (3 x 8 significand bits hold fp32's 24; truncation never rounds up to
// inf at |W| near FLT_MAX; exact for |W| >= 2^-110 and for 0), and
// mma.sync m16n8k16 bf16 x bf16 -> fp32 runs lo x h, mid x h and hi x h.
// Each product piece x h is exact in fp32 (8 x 8 significand bits), so
// only the sums round. The tensor cores truncate as they add, so the three
// products of each 16 rows go into a fresh sum, which FADD adds to the
// warp's fp32 sum with round-to-nearest, as the SIMT kernel adds. This is
// not TF32. A non-finite W keeps hi = W (NaN as a quiet NaN) and mid = lo
// = 0, so inf and NaN spread as in the plain version (inf - inf would turn
// an inf W into NaN).
//
// What bounds it: the bytes of h (bf16) and W (fp32), read once: 0.68 GB
// at 100k rows, H x F = 16 x 128, R = 40, 0.20 ms at 3.35 TB/s; the three
// products are 49 GFLOP, 0.05 ms at the dense bf16 rate. So a block
// streams h and W rows through kMmaStages shared-memory buffers, 64 rows a
// stage, over a run of node rows, and leaves one partial [R, F] a run,
// which relgat_bwd_rel_reduce_kernel sums in run order. The launcher picks
// the number of runs that fills whole waves of blocks on this card best
// (rel_mma_runs, from the SM count and the kernel's occupancy; 33 runs of
// 3,072 rows at 16 x 128: 10.8 MB of partials, the tile design's 64 MB).
// The blocks of a run are adjacent in the grid, head fastest, so a run's h
// and W rows are read together.
//
// A block: one head, a tile of 16 x MT relations (MT m-tiles, up to 4) and
// of up to 128 features (wider heads: feature tiles, balanced, whose blocks
// are adjacent too, so W comes from L2 after the first; the TMA kernel's
// tiles reach 248 features at F <= 384, two warps along them); warp (mt,
// kw) takes m-tile mt and rows 32 kw .. 32 kw + 31 of each stage,
// splitting its own W values in registers (the A fragments) and reading h
// with ldmatrix.trans (the B fragments). The two warps of an m-tile add
// their sums in a fixed order at the end. The first blocks of a run also sum B
// (dbias) over slices of the run's rows while their first stages land,
// coalesced and in a fixed order. No atomics: the same bits every call.
//
// Two ways to stage: where the rows allow 2-D boxes (every model width),
// relgat_bwd_rel_mma_tma_kernel has one thread copy each stage with the
// TMA on mbarriers, with no block barrier a stage; elsewhere (F = 301,
// R = 7) relgat_bwd_rel_mma_kernel's threads copy it with cp.async between
// two block barriers. On an H100 80GB HBM3 at 700 W the TMA staging was
// the faster at 16 x 128, 12 x 300 and 16 x 200 (PERF.md section 6).
// Measured and dropped, each slower at those widths: 8 n-tiles a warp with
// up to 4 warps along the features (more warps an SM), 32-row stages with
// one warp an m-tile, and 4 or 5 stages.

constexpr int kRelDesignTile = 1;  // relgat_bwd_rel_tile_kernel (SIMT)
constexpr int kRelDesignMma = 2;   // relgat_bwd_rel_mma_kernel

constexpr int kMmaKSteps = 2;  // k16 steps a warp takes of each stage
constexpr int kMmaKWarps = 2;  // warps of an m-tile along a stage's rows
constexpr int kMmaStageRows = 16 * kMmaKSteps * kMmaKWarps;  // 64
constexpr int kMmaStages = 3;
constexpr int kMmaMaxMTiles = 4;   // 16 to 64 relations a block
constexpr int kMmaNTiles = 16;     // n-tiles of 8 features a block, at most
constexpr int kMmaMaxThreads = 32 * kMmaKWarps * kMmaMaxMTiles;  // 256
// The TMA kernel's blocks also have up to kMmaMaxNWarps warps along the
// features, a warp up to kMmaNTiles n-tiles, a block up to
// kMmaMaxTmaNTiles (its box: at most 256 columns).
constexpr int kMmaMaxNWarps = 2;
constexpr int kMmaMaxTmaNTiles = 31;
constexpr int kMmaWideNTiles = 48;
constexpr int kMmaMaxTmaThreads = kMmaMaxThreads * kMmaMaxNWarps;  // 512
// Partials of dbias a run: its first kMmaBiasSlices blocks (or all, if
// fewer) each sum B over a slice of the run's rows.
constexpr int kMmaBiasSlices = 16;

// Floats of a staged W row of 16 x mt relations: 16 mt + 4, so that the
// lanes' loads of an A fragment (rows 2t, columns g) fall in 32 banks.
__host__ __device__ constexpr int mma_w_stride(int mt) { return 16 * mt + 4; }

// bf16 values of a staged h row of `cols` features: a multiple of 64 and
// 8 more, so that the 8 rows one ldmatrix reads start 16 bytes apart
// modulo 128 bytes (distinct banks).
__host__ __device__ constexpr int mma_h_stride(int cols) {
  return (cols + 63) / 64 * 64 + 8;
}

__host__ __device__ constexpr int mma_stage_bytes(int mt, int cols) {
  return kMmaStageRows * (mma_h_stride(cols) * 2 + mma_w_stride(mt) * 4);
}

// The three bf16 pieces of x (each in the upper half of a word).
__device__ __forceinline__ void split_bf16x3(float x, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const uint32_t u = __float_as_uint(x);
  if (fabsf(x) < INFINITY) {
    hi = u & 0xffff0000u;
    const float r = x - __uint_as_float(hi);  // exact (Sterbenz)
    mid = __float_as_uint(r) & 0xffff0000u;
    lo = __float_as_uint(r - __uint_as_float(mid)) & 0xffff0000u;
  } else {
    hi = x != x ? 0x7fc00000u : u;
    mid = 0u;
    lo = 0u;
  }
}

// Two pieces into one bf16x2 register: a (the lower k) in the low half.
__device__ __forceinline__ uint32_t pack_hi16(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid: runs of `run` rows (a multiple of kMmaStageRows; a run past the
// last row writes zeros) x rel_tiles x col_tiles x heads blocks, head
// fastest. A block: mtiles x kMmaKWarps warps; warp (mt, kw) takes
// relations r0 + 16 mt .. + 15 and rows 32 kw .. 32 kw + 31 of each stage,
// over the block's tile_ntiles n-tiles (8 features each). The first
// min(per_run, kMmaBiasSlices) blocks of a run also sum B over a slice of
// its rows into part_bias[run * slices + slice].
struct MmaBlock {
  int head, ct, rt, tile, slice, per_run;
};

__device__ __forceinline__ MmaBlock mma_block(int heads, int rel_tiles,
                                              int col_tiles) {
  MmaBlock k;
  k.per_run = heads * rel_tiles * col_tiles;
  k.slice = blockIdx.x % k.per_run;
  int id = blockIdx.x;
  k.head = id % heads;
  id /= heads;
  k.ct = id % col_tiles;
  id /= col_tiles;
  k.rt = id % rel_tiles;
  k.tile = id / rel_tiles;
  return k;
}

// dbias over this block's slice of the run's rows n0 .. n1 - 1: column c
// summed over rows b0 + gb, b0 + gb + groups, ... by thread (gb, c), then
// the groups in order (red: smem for groups x R floats). Every thread of
// the block calls it.
__device__ __forceinline__ void mma_bias_slice(
    const float* __restrict__ b, float* __restrict__ part_bias, float* red,
    const MmaBlock& k, int n0, int n1, int run, int num_rel) {
  const int nthreads = blockDim.x;
  const int slices = k.per_run < kMmaBiasSlices ? k.per_run : kMmaBiasSlices;
  if (k.slice >= slices) return;  // the same for every thread of the block
  const int sub = (run + slices - 1) / slices;
  const int b0 = min(n0 + k.slice * sub, n1);
  const int b1 = min(b0 + sub, n1);
  const int span = num_rel < nthreads ? num_rel : nthreads;
  const int groups = num_rel < nthreads ? nthreads / num_rel : 1;
  const int gb = threadIdx.x / span;
  if (gb < groups) {
    for (int c = threadIdx.x % span; c < num_rel; c += span) {
      float s = 0.f;
#pragma unroll 8
      for (int n = b0 + gb; n < b1; n += groups)
        s += b[static_cast<int64_t>(n) * num_rel + c];
      red[gb * num_rel + c] = s;
    }
  }
  __syncthreads();
  float* pb = part_bias +
              (static_cast<int64_t>(k.tile) * slices + k.slice) * num_rel;
  for (int c = threadIdx.x; c < num_rel; c += nthreads) {
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += red[q * num_rel + c];
    pb[c] = s;
  }
}

// One warp's share of a staged stage: hrow is its lane's row (32 kw + lane)
// of h at the block's first feature, wr the stage's row 32 kw of W at
// relation 16 mt + g. A fragments [k-step][piece: lo, mid, hi][register]:
// register q holds relations g (q even) or g + 8 (q odd) at rows 2t,
// 2t + 1 (+ 8 for q >= 2) of the k-step. Two n-tiles at a time, each over
// both k-steps: one ldmatrix a tile gives its B fragments for the 32 rows
// (rows 0-7, 8-15: k-step 0; 16-23, 24-31: k-step 1). The three products
// of a (tile, k-step) run into a fresh sum (the tensor cores truncate as
// they add; four such chains in flight), which FADD adds to acc. An odd
// last tile's partner reads staged columns past the tile and is never
// written.
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* hrow,
                                          const float* wr, int ws_stride,
                                          int t, int nt,
                                          float (&acc)[kMmaNTiles][4]) {
  uint32_t a[kMmaKSteps][3][4];
#pragma unroll
  for (int ks = 0; ks < kMmaKSteps; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * ks + 2 * t + 8 * (q >> 1);
      const int m = 8 * (q & 1);
      uint32_t h0, m0, l0, h1, m1, l1;
      split_bf16x3(wr[k * ws_stride + m], h0, m0, l0);
      split_bf16x3(wr[(k + 1) * ws_stride + m], h1, m1, l1);
      a[ks][0][q] = pack_hi16(l0, l1);
      a[ks][1][q] = pack_hi16(m0, m1);
      a[ks][2][q] = pack_hi16(h0, h1);
    }
  }
#pragma unroll
  for (int j = 0; j < kMmaNTiles; j += 2) {
    if (j < nt) {
      uint32_t b0[4], b1[4];
      ldmatrix_x4_trans(b0, hrow + 8 * j);
      ldmatrix_x4_trans(b1, hrow + 8 * (j + 1));
      float d0[kMmaKSteps][4], d1[kMmaKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kMmaKSteps; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) d0[ks][q] = d1[ks][q] = 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int ks = 0; ks < kMmaKSteps; ++ks) {
          mma_bf16(d0[ks], a[ks][p], b0[2 * ks], b0[2 * ks + 1]);
          mma_bf16(d1[ks], a[ks][p], b1[2 * ks], b1[2 * ks + 1]);
        }
#pragma unroll
      for (int ks = 0; ks < kMmaKSteps; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][q] += d0[ks][q];
          acc[j + 1][q] += d1[ks][q];
        }
    }
  }
}

// The second warp (kw = 1) of each m-tile and n-tile range hands its sums
// to the first (through red, shared memory the stages no longer use, at
// `slot`), which adds them (first + second) and writes the block's
// partial: its column c is feature f0 + c, written where 0 <= f0 + c < F.
// Every thread of the block calls it.
__device__ __forceinline__ void mma_write_partial(
    float (&acc)[kMmaNTiles][4], float4* red, float* __restrict__ part_attn,
    const MmaBlock& k, int heads, int feat, int num_rel, int r0, int f0,
    int nt, int mt, int kw, int slot) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  red += slot * kMmaNTiles * 32 + lane;
  if (kw == 1) {
#pragma unroll
    for (int j = 0; j < kMmaNTiles; ++j)
      if (j < nt)
        red[j * 32] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();
  if (kw != 0) return;
  float* pa = part_attn + (static_cast<int64_t>(k.tile) * heads + k.head) *
                              num_rel * feat;
  const int ra = r0 + 16 * mt + g;
#pragma unroll
  for (int j = 0; j < kMmaNTiles; ++j) {
    if (j >= nt) continue;
    const float4 o = red[j * 32];
    const float v[4] = {acc[j][0] + o.x, acc[j][1] + o.y, acc[j][2] + o.z,
                        acc[j][3] + o.w};
    const int f = f0 + 8 * j + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = ra + 8 * (q >> 1);
      const int fq = f + (q & 1);
      if (r < num_rel && fq >= 0 && fq < feat)
        pa[static_cast<int64_t>(r) * feat + fq] = v[q];
    }
  }
}

// The mma design staged by the block's threads with cp.async, for any
// width and alignment: VH and VW are the copy widths of h and of W rows
// (as in the tile kernel). A stage is waited on with one block barrier and
// released with another.
template <int VH, int VW>
__global__ void __launch_bounds__(kMmaMaxThreads, 2)
relgat_bwd_rel_mma_kernel(const __nv_bfloat16* __restrict__ h,  // [N, H*F]
                          const float* __restrict__ w,  // [N, H, R]
                          const float* __restrict__ b,  // [N, R]
                          float* __restrict__ part_attn,  // [T, H, R, F]
                          float* __restrict__ part_bias,  // [T * slices, R]
                          int num_nodes, int heads, int feat, int num_rel,
                          int run, int mtiles, int rel_tiles, int col_tiles,
                          int tile_ntiles) {
  extern __shared__ __align__(128) unsigned char rel_smem[];
  const int nthreads = blockDim.x;
  const MmaBlock blk = mma_block(heads, rel_tiles, col_tiles);
  const int head = blk.head;
  const int cols = 8 * tile_ntiles;  // the staged width, zeros past F
  const int hstride = mma_h_stride(cols);
  const int ws_stride = mma_w_stride(mtiles);
  const int rel_cols = 16 * mtiles;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(rel_smem);
  float* ws = reinterpret_cast<float*>(
      rel_smem + kMmaStages * kMmaStageRows * hstride * 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mt = warp % mtiles;
  const int kw = warp / mtiles;
  const int n0 = blk.tile * run;
  const int n1 = min(n0 + run, num_nodes);
  const int r0 = blk.rt * rel_cols;
  const int f0 = blk.ct * cols;
  const int nt = min(tile_ntiles, (feat - f0 + 7) / 8);  // n-tiles in F
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const __nv_bfloat16* h_head = h + static_cast<int64_t>(head) * feat + f0;

  // Rows nb .. nb + 63 into buffer buf; rows past the run, features past F
  // and relations past R read as zeros (rows must: 0 x anything finite).
  // Copy i of a stage is (row i / copies, column i % copies); a thread's
  // copies step by nthreads, so their rows and columns step by the
  // quotient and remainder of nthreads, without a division each.
  const int hcopies = cols / VH;
  const int wcopies = rel_cols / VW;
  const int hdk = nthreads / hcopies, hdc = nthreads % hcopies;
  const int wdk = nthreads / wcopies, wdc = nthreads % wcopies;
  const int hk0 = threadIdx.x / hcopies, hc0 = threadIdx.x % hcopies;
  const int wk0 = threadIdx.x / wcopies, wc0 = threadIdx.x % wcopies;
  auto stage = [&](int buf, int nb) {
    __nv_bfloat16* hb = hs + buf * kMmaStageRows * hstride;
    float* wb = ws + buf * kMmaStageRows * ws_stride;
    for (int k = hk0, c = hc0; k < kMmaStageRows;) {
      const int n = nb + k;
      const bool ok = n < n1 && f0 + VH * c < feat;
      cp_async<VH>(hb + k * hstride + VH * c,
                   ok ? h_head + n * hf + VH * c : h, ok);
      k += hdk;
      c += hdc;
      if (c >= hcopies) {
        c -= hcopies;
        ++k;
      }
    }
    for (int k = wk0, c = wc0; k < kMmaStageRows;) {
      const int n = nb + k;
      const bool ok = n < n1 && r0 + VW * c < num_rel;
      const int64_t wi =
          (static_cast<int64_t>(n) * heads + head) * num_rel + r0 + VW * c;
      cp_async<VW>(wb + k * ws_stride + VW * c, ok ? w + wi : w, ok);
      k += wdk;
      c += wdc;
      if (c >= wcopies) {
        c -= wcopies;
        ++k;
      }
    }
    cp_async_commit();
  };

  const int steps = n1 > n0 ? (n1 - n0 + kMmaStageRows - 1) / kMmaStageRows
                            : 0;
#pragma unroll
  for (int q = 0; q < kMmaStages - 1; ++q) {
    if (q < steps) stage(q, n0 + q * kMmaStageRows);
    else cp_async_commit();
  }
  // dbias while the first stages land
  mma_bias_slice(b, part_bias,
                 reinterpret_cast<float*>(
                     rel_smem + kMmaStages * mma_stage_bytes(mtiles, cols)),
                 blk, n0, n1, run, num_rel);

  float acc[kMmaNTiles][4];
#pragma unroll
  for (int j = 0; j < kMmaNTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int g = lane >> 2;
  const int t = lane & 3;
  for (int st = 0; st < steps; ++st) {
    const int buf = st % kMmaStages;
    const int next = st + kMmaStages - 1;
    if (next < steps) stage(next % kMmaStages, n0 + next * kMmaStageRows);
    else cp_async_commit();
    cp_async_wait<kMmaStages - 1>();
    __syncthreads();
    const int row = buf * kMmaStageRows + 32 * kw;
    mma_stage(hs + (row + lane) * hstride,
              ws + row * ws_stride + 16 * mt + g, ws_stride, t, nt, acc);
    __syncthreads();  // a later stage's copies overwrite this buffer
  }
  cp_async_wait<0>();
  __syncthreads();
  mma_write_partial(acc, reinterpret_cast<float4*>(rel_smem), part_attn, blk,
                    heads, feat, num_rel, r0, f0, nt, mt, kw, mt);
}

// The mma design staged by the tensor memory accelerator, where h's and
// W's rows are 16-byte multiples (H*F a multiple of 8, H*R of 4): lane 0
// of warp 0 copies each stage as two 2-D boxes (64 rows of h's hstride
// features from the head's first feature of the tile, 64 rows of W's
// ws_stride relations; columns past the head read its neighbour's values,
// which land in outputs never written, and rows past N read as zeros) on
// the stage's "full" mbarrier, and each warp arrives on its "empty" one
// when it has read it. No block barrier a stage: a warp waits only for the
// stage it needs, and warp 0 for the buffer it refills. A run is a
// multiple of 64 rows, so only the last stage of the last run is short.
// A box starts on 16 bytes: where a head's first feature does not (F = 300,
// odd heads), the box starts `shift` features before it, and staged column
// c is feature c - shift of the tile (the columns before 0 are the previous
// head's, never written).
__global__ void __launch_bounds__(kMmaMaxTmaThreads, 1)
relgat_bwd_rel_mma_tma_kernel(const __grid_constant__ CUtensorMap hmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const float* __restrict__ b,  // [N, R]
                              float* __restrict__ part_attn,
                              float* __restrict__ part_bias,
                              int num_nodes, int heads, int feat,
                              int num_rel, int run, int mtiles,
                              int rel_tiles, int col_tiles, int tile_ntiles,
                              int warp_ntiles, int hstride, int ws_stride) {
  extern __shared__ __align__(128) unsigned char rel_smem[];
  const MmaBlock blk = mma_block(heads, rel_tiles, col_tiles);
  const int cols = 8 * tile_ntiles;
  const int rel_cols = 16 * mtiles;
  const int hbytes = kMmaStageRows * hstride * 2;  // a multiple of 128
  const int wbytes = kMmaStageRows * ws_stride * 4;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(rel_smem);
  float* ws = reinterpret_cast<float*>(rel_smem + kMmaStages * hbytes);
  unsigned char* after = rel_smem + kMmaStages * (hbytes + wbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(after);
  uint64_t* empty = full + kMmaStages;
  float* red_bias = reinterpret_cast<float*>(empty + kMmaStages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int mt = warp % mtiles;
  const int kw = (warp / mtiles) % kMmaKWarps;
  const int wn = warp / (mtiles * kMmaKWarps);  // n-tiles j0 .. j0 + nt - 1
  const int j0 = wn * warp_ntiles;
  const int n0 = blk.tile * run;
  const int n1 = min(n0 + run, num_nodes);
  const int r0 = blk.rt * rel_cols;
  const int shift = (blk.head * feat) & 7;
  const int f0 = blk.ct * cols - shift;  // the feature of staged column 0
  const int nt = max(0, min(warp_ntiles,
                            min(tile_ntiles, (feat - f0 + 7) / 8) - j0));
  const int hx = blk.head * feat + f0;  // the boxes' first columns
  const int wx = blk.head * num_rel + r0;
  const int steps = n1 > n0 ? (n1 - n0 + kMmaStageRows - 1) / kMmaStageRows
                            : 0;
  const bool producer = threadIdx.x == 0;

  if (producer) {
    for (int s = 0; s < kMmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int st) {  // stage st into buffer st % kMmaStages
    const int buf = st % kMmaStages;
    const int y = n0 + st * kMmaStageRows;
    mbar_arrive_tx(&full[buf], hbytes + wbytes);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(reinterpret_cast<unsigned char*>(hs) + buf * hbytes)),
        "l"(reinterpret_cast<uint64_t>(&hmap)), "r"(hx), "r"(y),
        "r"(smem_u32(&full[buf]))
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(reinterpret_cast<unsigned char*>(ws) + buf * wbytes)),
        "l"(reinterpret_cast<uint64_t>(&wmap)), "r"(wx), "r"(y),
        "r"(smem_u32(&full[buf]))
        : "memory");
  };
  if (producer) {
    for (int st = 0; st < kMmaStages - 1 && st < steps; ++st) load(st);
  }
  // dbias while the first stages land
  mma_bias_slice(b, part_bias, red_bias, blk, n0, n1, run, num_rel);

  float acc[kMmaNTiles][4];
#pragma unroll
  for (int j = 0; j < kMmaNTiles; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int g = lane >> 2;
  const int t = lane & 3;
  for (int st = 0; st < steps; ++st) {
    const int next = st + kMmaStages - 1;
    if (producer && next < steps) {
      // the buffer's previous stage, next - kMmaStages, read by every warp
      if (next >= kMmaStages)
        mbar_wait(&empty[next % kMmaStages],
                  (next / kMmaStages - 1) & 1);
      load(next);
    }
    __syncwarp();
    const int buf = st % kMmaStages;
    mbar_wait(&full[buf], (st / kMmaStages) & 1);
    const int row = buf * kMmaStageRows + 32 * kw;
    mma_stage(hs + (row + lane) * hstride + 8 * j0,
              ws + row * ws_stride + 16 * mt + g, ws_stride, t, nt, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[buf]);
  }
  __syncthreads();  // every stage landed and read: the buffers are free
  mma_write_partial(acc, reinterpret_cast<float4*>(rel_smem), part_attn, blk,
                    heads, feat, num_rel, r0, f0 + 8 * j0, nt, mt, kw,
                    wn * mtiles + mt);
}

// ---------------------------------------------------------------------------
// The bf16 ring src pass's products by (source row, head, relation).
//
// relgat_bwd_src_logits_kernel: P[s, hd, r] = <h[s, hd], attn[hd, r]> for
// every source row, into the W buffer [N + parts, H, R] (rows < N). A GEMM
// per head with M = rows, N = relations, K = features; h is bf16 and so
// exact, and each fp32 attn value splits exactly into three bf16 pieces
// (split_bf16x3), so mma.sync m16n8k16 runs lo, mid and hi x h, each
// product exact in fp32, into a fresh sum a k-step (16 features) that FADD
// adds to the fp32 sum, as relgat_bwd_rel_mma_kernel does for W: not TF32.
// A block takes one head, a group of up to kLogitMaxNTiles n-tiles of 8
// relations and a run of rows: it splits the group's attn rows once into
// shared memory (three bf16 planes, zeros past R and F), then each warp
// takes 32 rows (two m-tiles) at a time, loading its A fragments straight
// from h two k-steps ahead and its B fragments from the planes. The k order
// within a step is permuted so that a lane's four values are adjacent
// features, 4t .. 4t + 3 of the step (A: one 8-byte load of each of its
// rows; B: one 8-byte shared load a piece): logical k 2t, 2t + 1 are
// features 4t, 4t + 1 and logical 2t + 8, 2t + 9 are 4t + 2, 4t + 3, on
// both operands. VH: 4 values a load (F a multiple of 4, rows aligned), or
// 1.
//
// What bounds it: 3 x 2 N H R F tensor FLOPs (0.19 PFLOP at N = 100k,
// 12 x 256, R = 100: 0.19 ms at 989 TFLOP/s) and P written (0.48 GB there,
// 0.14 ms). It took 0.98 ms there on an H100 80GB HBM3 (700 W); the first
// design, which split attn in registers for every (warp, n-tile, k-step),
// 3.4 ms; A one k-step ahead, 1.12 ms; two n-tiles' product chains
// interleaved, 1.10 ms.
constexpr int kLogitWarps = 8;
constexpr int kLogitRows = 32;       // rows a warp takes at a time
constexpr int kLogitMaxNTiles = 7;   // n-tiles of 8 relations a block
constexpr int kLogitSmemBytes = 104 * 1024;  // the planes; two blocks an SM

// bf16 values of a plane's row of `feat` features: the k-steps' features
// rounded up to 64 and 16 more, so that the 8 rows one B fragment read
// touches start 32 bytes apart modulo 128 (two wavefronts, the least).
__host__ __device__ constexpr int logit_stride(int feat) {
  return ((feat + 15) / 16 * 16 + 63) / 64 * 64 + 16;
}

// A lane's four bf16 values at features f .. f + 3 of a row, as two words
// (f, f + 1 and f + 2, f + 3; zeros past F or for a row out of range).
template <int VH>
__device__ __forceinline__ uint2 load4_bf16(const __nv_bfloat16* row, int f,
                                            int feat, bool ok) {
  if constexpr (VH == 4) {
    return ok && f < feat ? *reinterpret_cast<const uint2*>(row + f)
                          : make_uint2(0u, 0u);
  } else {
    static_assert(VH == 1, "4 values a load, or 1");
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = ok && f + q < feat ? r[f + q] : 0u;
    return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
  }
}

template <int VH>
__device__ __forceinline__ float4 load4_f32(const float* row, int f, int feat,
                                            bool ok) {
  if constexpr (VH == 4) {
    return ok && f < feat ? *reinterpret_cast<const float4*>(row + f)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = ok && f + q < feat ? row[f + q] : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Grid: runs x relation groups x heads blocks; a run is `run` rows (a
// multiple of kLogitRows).
template <int VH>
__global__ void __launch_bounds__(32 * kLogitWarps, 2)
relgat_bwd_src_logits_kernel(const __nv_bfloat16* __restrict__ h,  // [N, H*F]
                             const float* __restrict__ attn,  // [H, R, F]
                             float* __restrict__ p,           // [N, H, R]
                             int num_rows, int heads, int feat, int num_rel,
                             int group_ntiles, int run) {
  extern __shared__ __align__(16) unsigned char logit_smem[];
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(logit_smem);
  const int stride = logit_stride(feat);
  const int rels = 8 * group_ntiles;
  const int plane = rels * stride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int head = blockIdx.z;
  const int r0 = blockIdx.y * rels;
  const int nt = min(group_ntiles, (num_rel - r0 + 7) / 8);
  const int ksteps = (feat + 15) / 16;

  // the planes: relation r0 + i, features 4c .. 4c + 3, split once
  const float* attn_head = attn + static_cast<int64_t>(head) * num_rel * feat;
  for (int idx = threadIdx.x; idx < rels * 4 * ksteps; idx += blockDim.x) {
    const int i = idx / (4 * ksteps);
    const int f = 4 * (idx % (4 * ksteps));
    const float4 x = load4_f32<VH>(
        attn_head + static_cast<int64_t>(r0 + i) * feat, f, feat,
        r0 + i < num_rel);
    uint32_t pc[4][3];  // [value][piece: hi, mid, lo]
    split_bf16x3(x.x, pc[0][0], pc[0][1], pc[0][2]);
    split_bf16x3(x.y, pc[1][0], pc[1][1], pc[1][2]);
    split_bf16x3(x.z, pc[2][0], pc[2][1], pc[2][2]);
    split_bf16x3(x.w, pc[3][0], pc[3][1], pc[3][2]);
#pragma unroll
    for (int piece = 0; piece < 3; ++piece)
      *reinterpret_cast<uint2*>(planes + piece * plane + i * stride + f) =
          make_uint2(pack_hi16(pc[0][piece], pc[1][piece]),
                     pack_hi16(pc[2][piece], pc[3][piece]));
  }
  __syncthreads();

  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int n1 = min(num_rows, (blockIdx.x + 1) * run);
  // lane (g, t)'s B fragments: plane row 8 j + g, features k0 + 4t ..
  const __nv_bfloat16* bbase = planes + g * stride + 4 * t;
  for (int row0 = blockIdx.x * run + warp * kLogitRows; row0 < n1;
       row0 += kLogitWarps * kLogitRows) {
    // row q of this lane: row0 + g + 8 q (m-tile q / 2, its rows g or g + 8)
    const __nv_bfloat16* hrow[4];
    bool rok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + g + 8 * q;
      rok[q] = row < n1;
      hrow[q] = h + (rok[q] ? row : 0) * hf + static_cast<int64_t>(head) * feat;
    }
    float acc[2][kLogitMaxNTiles][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < kLogitMaxNTiles; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
    // k-step ks's A words, loaded two k-steps ahead: cur holds step ks
    // and is refilled with step ks + 2 once read
    auto step = [&](int ks, uint2 (&cur)[4]) {
      uint32_t a[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q >> 1][q & 1] = cur[q].x;        // logical k 2t, 2t + 1
        a[q >> 1][2 + (q & 1)] = cur[q].y;  // logical k 2t + 8, 2t + 9
      }
      if (ks + 2 < ksteps) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cur[q] = load4_bf16<VH>(hrow[q], 16 * (ks + 2) + 4 * t, feat,
                                  rok[q]);
      }
      const __nv_bfloat16* bk = bbase + 16 * ks;
#pragma unroll
      for (int j = 0; j < kLogitMaxNTiles; ++j) {
        if (j >= nt) continue;
        uint2 b[3];
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)
          b[piece] = *reinterpret_cast<const uint2*>(bk + piece * plane +
                                                     8 * j * stride);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int piece = 2; piece >= 0; --piece)  // lo, mid, hi
            mma_bf16(d, a[mi], b[piece].x, b[piece].y);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][j][q] += d[q];
        }
      }
    };
    uint2 even[4], odd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      even[q] = load4_bf16<VH>(hrow[q], 4 * t, feat, rok[q]);
      odd[q] = load4_bf16<VH>(hrow[q], 16 + 4 * t, feat, rok[q]);
    }
    for (int ks = 0; ks < ksteps; ks += 2) {
      step(ks, even);
      if (ks + 1 < ksteps) step(ks + 1, odd);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < kLogitMaxNTiles; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + 16 * mi + g + 8 * (q >> 1);
          const int r = r0 + 8 * j + 2 * t + (q & 1);
          if (row < n1 && r < num_rel)
            p[(static_cast<int64_t>(row) * heads + head) * num_rel + r] =
                acc[mi][j][q];
        }
      }
  }
}

// relgat_bwd_src_fold_kernel: dh[s, hd, :] += sum_r W[s, hd, r] attn[hd, r]
// over rows s < N, after the merge: the attn term of dh that the factored
// loop leaves out, in fp32 FMAs over r in order. A GEMM per head with M =
// rows, N = features, K = relations: a block takes kFoldRows x kFoldCols,
// stages kFoldK relations of W (transposed) and of attn in shared memory
// (two buffers, the next stage's loads in registers while this one is
// used), copies its tile of dh into shared memory with cp.async a share a
// stage, and a thread an 8 x 8 tile (rows 8 ty .., features 4 tx .. and
// 64 + 4 tx ..), whose sum it adds to the staged dh and writes once. What
// bounds it: 2 N H R F FLOPs at the fp32 rate (61 GFLOP at N = 100k,
// 12 x 256, R = 100: 0.92 ms at 67 TFLOP/s) and dh read and written (2.5 GB
// there, 0.73 ms); it took 1.90 ms there and 1.10 ms at R = 40 on an H100
// 80GB HBM3 (700 W). Measured and dropped: the whole dh tile copied as the
// block starts (2.05 / 1.24 ms), or read in the epilogue (2.07 / 1.49);
// 64-row tiles (2.12 / 1.16); 16 relations a stage (2.09 / 1.12); the
// tensor cores, W and attn each split into three bf16 pieces and all nine
// products taken (2.70 ms at R = 100 with 128 features a block, 3.10 with
// 64 and chains interleaved). VEC: 16-byte accesses of attn and dh (F a
// multiple of 4, aligned).
constexpr int kFoldRows = 128;
constexpr int kFoldCols = 128;
constexpr int kFoldK = 8;
constexpr int kFoldThreads = 256;
constexpr int kFoldSmemBytes = kFoldRows * kFoldCols * 4;  // the dh tile

template <bool VEC>
__global__ void __launch_bounds__(kFoldThreads, 2)
relgat_bwd_src_fold_kernel(const float* __restrict__ w,     // [N, H, R]
                           const float* __restrict__ attn,  // [H, R, F]
                           float* __restrict__ dh,          // [N, H*F]
                           int num_rows, int heads, int feat, int num_rel,
                           int col_tiles) {
  __shared__ __align__(16) float ws[2][kFoldK][kFoldRows];
  __shared__ __align__(16) float as[2][kFoldK][kFoldCols];
  extern __shared__ __align__(16) float dh_tile[];  // [kFoldRows][kFoldCols]
  const int tid = threadIdx.x;
  const int head = blockIdx.y / col_tiles;
  const int f0 = (blockIdx.y % col_tiles) * kFoldCols;
  const int s0 = blockIdx.x * kFoldRows;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  float* dh_head = dh + static_cast<int64_t>(head) * feat;

  // dh's tile, zeros past the rows and F (never written back), copied a
  // share of it with each stage of relations, so that every block reads
  // dh while it computes
  constexpr int kV = VEC ? 4 : 1;
  constexpr int kCopies = kFoldRows * kFoldCols / kV / kFoldThreads;
  const int steps = (num_rel + kFoldK - 1) / kFoldK;
  const int per_step = (kCopies + steps - 1) / steps;
  auto copy_dh = [&](int q0, int q1) {
    for (int q = q0; q < q1 && q < kCopies; ++q) {
      const int i = tid + q * kFoldThreads;
      const int r = i / (kFoldCols / kV);
      const int c = kV * (i % (kFoldCols / kV));
      const bool ok = s0 + r < num_rows && f0 + c < feat;
      cp_async<kV>(dh_tile + r * kFoldCols + c,
                   ok ? dh_head + (s0 + r) * hf + f0 + c : dh, ok);
    }
    cp_async_commit();
  };

  // the staging: W rows s0 + wi, relations r0 + wk .. + 3; attn relation
  // r0 + ak, features f0 + ac .. + 3
  const int wi = tid >> 1;
  const int wk = 4 * (tid & 1);
  const bool w_ok = s0 + wi < num_rows;
  const float* wrow =
      w + (static_cast<int64_t>(w_ok ? s0 + wi : 0) * heads + head) * num_rel;
  const int ak = tid >> 5;
  const int ac = 4 * (tid & 31);
  const float* attn_head = attn + static_cast<int64_t>(head) * num_rel * feat;
  float wv[4];
  float4 av;
  auto fetch = [&](int r0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + wk + q;
      wv[q] = w_ok && r < num_rel ? wrow[r] : 0.f;
    }
    const int r = r0 + ak;
    av = load4_f32<kV>(attn_head + static_cast<int64_t>(r) * feat, f0 + ac,
                       feat, r < num_rel);
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) ws[buf][wk + q][wi] = wv[q];
    *reinterpret_cast<float4*>(&as[buf][ak][ac]) = av;
  };

  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) fetch((kt + 1) * kFoldK);
    copy_dh(kt * per_step, (kt + 1) * per_step);
#pragma unroll
    for (int k = 0; k < kFoldK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&ws[buf][k][8 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&ws[buf][k][8 * ty + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&as[buf][k][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step kt - 1, before this step's
    // barrier
    if (kt + 1 < steps) stage(buf ^ 1);
    __syncthreads();
  }

  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * ty + i;
    if (s0 + r >= num_rows) break;
    float* row = dh_head + (s0 + r) * hf;
    const float* tile = dh_tile + r * kFoldCols;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 64 * half + 4 * tx;
      if constexpr (VEC) {
        if (f0 + c < feat) {
          float4 x = *reinterpret_cast<const float4*>(tile + c);
          x.x += acc[i][4 * half];
          x.y += acc[i][4 * half + 1];
          x.z += acc[i][4 * half + 2];
          x.w += acc[i][4 * half + 3];
          *reinterpret_cast<float4*>(row + f0 + c) = x;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (f0 + c + q < feat)
            row[f0 + c + q] = tile[c + q] + acc[i][4 * half + q];
      }
    }
  }
}

}  // namespace relgat

namespace {

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// What every src-pass kernel takes after its rows: the edge tables, the work
// plan (data/csr.py build_bwd_plan) and the outputs with the partial rows.
struct SrcArgs {
  const float* attn;
  const float* m;
  const float* l;
  const float* s_dot;
  const float* gsum;
  const int4* items;
  const int* merge;
  const int* dst;
  const int* etype;
  const int* eid;
  float* dh;
  float* w_out;
  float* b_out;
  int num_rows;
  int num_items;
  int num_split;
  int heads;
  int feat;
  int num_rel;
  float slope;
  float eps;
  int use_dropout;
  uint32_t seed;
  uint32_t thr;
  float keep_prob;
  cudaStream_t st;
};

// P = h attn^T into W's rows 0 .. N - 1 (relgat_bwd_src_logits_kernel):
// relation groups as large as kLogitSmemBytes of planes hold (balanced),
// and runs of rows for about four blocks an SM.
cudaError_t launch_src_logits(const __nv_bfloat16* h, const SrcArgs& a) {
  using namespace relgat;
  const int plane_tile = 3 * 8 * logit_stride(a.feat) * 2;  // an n-tile
  const int most = kLogitSmemBytes / plane_tile < kLogitMaxNTiles
                       ? kLogitSmemBytes / plane_tile
                       : kLogitMaxNTiles;
  const int ntiles = (a.num_rel + 7) / 8;
  const int groups = (ntiles + most - 1) / most;
  const int group_ntiles = (ntiles + groups - 1) / groups;
  const int smem = group_ntiles * plane_tile;
  const bool vec4 = a.feat % 4 == 0 && aligned(h, 8) && aligned(a.attn, 16);
  auto kernel = vec4 ? relgat_bwd_src_logits_kernel<4>
                     : relgat_bwd_src_logits_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t pairs = static_cast<int64_t>(a.heads) * groups;
  const int64_t tiles = (a.num_rows + kLogitRows - 1) / kLogitRows;
  int64_t runs = (4 * static_cast<int64_t>(sms) + pairs - 1) / pairs;
  runs = runs > tiles ? tiles : runs;
  const int run = static_cast<int>((tiles + runs - 1) / runs) * kLogitRows;
  const dim3 grid((a.num_rows + run - 1) / run, groups, a.heads);
  kernel<<<grid, 32 * kLogitWarps, smem, a.st>>>(
      h, a.attn, a.w_out, a.num_rows, a.heads, a.feat, a.num_rel,
      group_ntiles, run);
  return cudaGetLastError();
}

// dh += W attn over rows 0 .. N - 1, after the merge
// (relgat_bwd_src_fold_kernel).
cudaError_t launch_src_fold(const SrcArgs& a) {
  using namespace relgat;
  const int col_tiles = (a.feat + kFoldCols - 1) / kFoldCols;
  const dim3 grid((a.num_rows + kFoldRows - 1) / kFoldRows,
                  a.heads * col_tiles);
  const bool vec4 =
      a.feat % 4 == 0 && aligned(a.dh, 16) && aligned(a.attn, 16);
  auto kernel = vec4 ? relgat_bwd_src_fold_kernel<true>
                     : relgat_bwd_src_fold_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFoldSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFoldThreads, kFoldSmemBytes, a.st>>>(
      a.w_out, a.attn, a.dh, a.num_rows, a.heads, a.feat, a.num_rel,
      col_tiles);
  return cudaGetLastError();
}

// The ring kernel, NK features a lane in the VW layout, in blocks of (work
// item, group of up to kRingBwdGroupHeads heads) (the groups balanced, as in
// the forward); on bf16 rows its factored loop where `factored`.
template <int NK, int VW, typename T>
cudaError_t launch_bwd_ring(const T* h, const T* g, const SrcArgs& a,
                            bool factored) {
  using namespace relgat;
  constexpr int kG = kRingBwdGroupHeads;
  const int groups = (a.heads + kG - 1) / kG;
  const int gh = (a.heads + groups - 1) / groups;
  const int elems = ring_stage_elems(gh * a.feat, sizeof(T));
  const int stage_bytes = elems * static_cast<int>(sizeof(T));
  const int fit = kRingBytes / stage_bytes;
  const int stages = fit < 2 ? 2 : (fit > kRingMaxStages ? kRingMaxStages : fit);
  const size_t smem =
      static_cast<size_t>(stages) * (stage_bytes + 2 * sizeof(uint64_t)) +
      static_cast<size_t>(gh) * 32 * sizeof(RingEntry) +
      static_cast<size_t>(gh + 1) * a.num_rel * sizeof(float);
  auto kernel = relgat_bwd_src_ring_kernel<NK, VW, T, false>;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (factored) kernel = relgat_bwd_src_ring_kernel<NK, VW, T, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.num_items * groups, 32 * (gh + 1), smem, a.st>>>(
      h, g, a.attn, a.m, a.l, a.s_dot, a.gsum, a.items, a.dst, a.etype, a.eid,
      a.dh, a.w_out, a.b_out, a.num_rows, groups, gh,
      a.heads, a.feat, a.num_rel, stages, elems, a.slope, a.eps,
      a.use_dropout, a.seed, a.thr, a.keep_prob);
  return cudaGetLastError();
}

// The split rows' chunks, added in chunk order into dh, W and B.
cudaError_t launch_bwd_merge(const SrcArgs& a) {
  using namespace relgat;
  if (a.num_split == 0) return cudaSuccess;
  const int hf = a.heads * a.feat;
  const int hr = a.heads * a.num_rel;
  const dim3 grid(a.num_split,
                  (hf + hr + a.num_rel + kBwdMergeThreads - 1) /
                      kBwdMergeThreads);
  relgat_bwd_src_merge_kernel<<<grid, kBwdMergeThreads, 0, a.st>>>(
      a.merge, a.dh, a.w_out, a.b_out, a.num_rows, hf, hr, a.num_rel);
  return cudaGetLastError();
}

// One kernel over the work items: kernel is kKernelLanes, kKernelRing,
// or (bf16 rows) kKernelRingFactored or kKernelPair (relgat_common.cuh).
template <typename T>
cudaError_t launch_src_items(const T* h, const T* g, const SrcArgs& a,
                             int kernel) {
  using namespace relgat;
  const int heads = a.heads;
  const int feat = a.feat;
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  // 4 values a vector: 16 bytes of an fp32 row, 8 of a bf16 one
  const bool vec4 = feat % 4 == 0 && aligned(h, 4 * sizeof(T)) &&
                    aligned(g, 4 * sizeof(T)) && aligned(a.attn, 16) &&
                    aligned(a.dh, 16);
  if (kernel == kKernelPair) {
    // two heads a warp, up to 16 heads a block; a table of 2 x 16 edges a
    // warp, one slab a head and one more
    const int pairs = (heads + 1) / 2;
    const int wpb2 = pairs < kMaxWarpsPerBlock ? pairs : kMaxWarpsPerBlock;
    const size_t pair_smem =
        static_cast<size_t>(wpb2) * 32 * sizeof(EdgeEntry) +
        static_cast<size_t>(2 * wpb2 + 1) * a.num_rel * sizeof(float);
    if (!kBf16 || !vec4 || feat % 8 != 0 || feat > 128 || !aligned(h, 16) ||
        !aligned(g, 16) || pair_smem > static_cast<size_t>(kMaxBwdSmemBytes))
      return cudaErrorInvalidValue;
    const dim3 grid2(a.num_items, (pairs + wpb2 - 1) / wpb2);
    relgat_bwd_src_pair_kernel<<<grid2, 32 * wpb2, pair_smem, a.st>>>(
        reinterpret_cast<const __nv_bfloat16*>(h),
        reinterpret_cast<const __nv_bfloat16*>(g), a.attn, a.m, a.l, a.s_dot,
        a.gsum, a.items, a.dst, a.etype, a.eid, a.dh, a.w_out, a.b_out,
        a.num_rows, heads, feat, a.num_rel, a.slope, a.eps, a.use_dropout,
        a.seed, a.thr, a.keep_prob);
    return cudaGetLastError();
  }
  if (kernel == kKernelRing || kernel == kKernelRingFactored) {
    const bool fac = kernel == kKernelRingFactored;
    if (feat <= 128 || (fac && !kBf16)) return cudaErrorInvalidValue;
    if constexpr (kBf16) {
      if (fac) {
        const cudaError_t err = launch_src_logits(h, a);
        if (err != cudaSuccess) return err;
      }
    }
    // two values a read where every head's piece of a row is 2-value aligned
    if (feat % 2 == 0 && aligned(h, 2 * sizeof(T)) &&
        aligned(g, 2 * sizeof(T)) && aligned(a.attn, 8) && aligned(a.dh, 8)) {
      return feat <= 256   ? launch_bwd_ring<8, 2>(h, g, a, fac)
             : feat <= 320 ? launch_bwd_ring<10, 2>(h, g, a, fac)
             : feat <= 512 ? launch_bwd_ring<16, 2>(h, g, a, fac)
                           : launch_bwd_ring<32, 2>(h, g, a, fac);
    }
    return feat <= 256   ? launch_bwd_ring<8, 1>(h, g, a, fac)
           : feat <= 320 ? launch_bwd_ring<10, 1>(h, g, a, fac)
           : feat <= 512 ? launch_bwd_ring<16, 1>(h, g, a, fac)
                         : launch_bwd_ring<32, 1>(h, g, a, fac);
  }
  if (kernel != kKernelLanes) return cudaErrorInvalidValue;
  const int wpb = heads < kMaxWarpsPerBlock ? heads : kMaxWarpsPerBlock;
  const size_t smem = static_cast<size_t>(wpb) * 32 * sizeof(EdgeEntry) +
                      static_cast<size_t>(wpb + 1) * a.num_rel * sizeof(float);
  if (smem > static_cast<size_t>(kMaxBwdSmemBytes)) return cudaErrorInvalidValue;
  const dim3 block(32 * wpb);
  const dim3 grid(a.num_items, (heads + wpb - 1) / wpb);
#define RELGAT_BWD_LAUNCH(VEC, NV)                                           \
  relgat_bwd_src_kernel<VEC, NV, T><<<grid, block, smem, a.st>>>(            \
      h, g, a.attn, a.m, a.l, a.s_dot, a.gsum, a.items, a.dst, a.etype,      \
      a.eid, a.dh, a.w_out, a.b_out, a.num_rows, heads, feat, a.num_rel,     \
      a.slope, a.eps, a.use_dropout, a.seed, a.thr, a.keep_prob)
  if (vec4 && feat <= 128) {
    RELGAT_BWD_LAUNCH(4, 1);
  } else if (vec4 && feat <= 256) {
    RELGAT_BWD_LAUNCH(4, 2);
  } else if (vec4 && feat <= 512) {
    RELGAT_BWD_LAUNCH(4, 4);
  } else if (vec4) {
    RELGAT_BWD_LAUNCH(4, 8);
  } else if (feat <= 32) {
    RELGAT_BWD_LAUNCH(1, 1);
  } else if (feat <= 64) {
    RELGAT_BWD_LAUNCH(1, 2);
  } else if (feat <= 128) {
    RELGAT_BWD_LAUNCH(1, 4);
  } else if (feat <= 256) {
    RELGAT_BWD_LAUNCH(1, 8);
  } else if (feat <= 512) {
    RELGAT_BWD_LAUNCH(1, 16);
  } else {
    RELGAT_BWD_LAUNCH(1, 32);
  }
#undef RELGAT_BWD_LAUNCH
  return cudaGetLastError();
}

// items [J, 4] and merge [T, 3] are data/csr.py's src-pass work plan; dh, W
// and B have num_rows source rows and then a partial row for each chunk of a
// split row.
template <typename T>
int launch_bwd_src(const T* h, const T* g, const float* attn, const float* m,
                   const float* l, const float* s_dot, const float* gsum,
                   const int* items, const int* merge, const int* dst,
                   const int* etype, const int* eid, float* dh, float* w_out,
                   float* b_out, int num_rows, int num_items, int num_split,
                   int heads, int feat, int num_rel, float slope, float eps,
                   int use_dropout, int seed, unsigned int thr,
                   float keep_prob, int kernel, void* stream) {
  if (!aligned(items, 16) || heads < 1 ||
      feat > 32 * relgat::kMaxFeatPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const SrcArgs a{attn, m, l, s_dot, gsum,
                  reinterpret_cast<const int4*>(items), merge, dst, etype,
                  eid, dh, w_out, b_out, num_rows, num_items, num_split,
                  heads, feat, num_rel, slope, eps, use_dropout,
                  static_cast<uint32_t>(seed), thr, keep_prob,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaSuccess;
  if (num_items > 0) err = launch_src_items(h, g, a, kernel);
  if (err == cudaSuccess) err = launch_bwd_merge(a);
  // the factored loop's W attn, added into dh after the merge
  if (err == cudaSuccess && num_items > 0 &&
      kernel == relgat::kKernelRingFactored)
    err = launch_src_fold(a);
  return static_cast<int>(err);
}

template <int RM, int VH, int VW, typename TH>
void launch_rel_tiles(dim3 grid, cudaStream_t st, const TH* h,
                      const float* w, const float* b, float* part_attn,
                      float* part_bias, int num_nodes, int heads, int feat,
                      int num_rel, int col_tiles) {
  relgat::relgat_bwd_rel_tile_kernel<RM, VH, VW, TH>
      <<<grid, relgat::kRelThreads, 0, st>>>(h, w, b, part_attn, part_bias,
                                             num_nodes, heads, feat, num_rel,
                                             col_tiles);
}

// vh: the values of h in one copy (8 or 4 of bf16 h, 16 or 8 bytes; 4 of
// fp32 h, 16 bytes; or 1).
template <int RM, typename TH>
void launch_rel_tiles_rm(int vh, bool vw, dim3 grid, cudaStream_t st,
                         const TH* h, const float* w, const float* b,
                         float* part_attn, float* part_bias, int num_nodes,
                         int heads, int feat, int num_rel, int col_tiles) {
  if constexpr (sizeof(TH) == 2) {
    if (vh == 8 && vw) {
      launch_rel_tiles<RM, 8, 4>(grid, st, h, w, b, part_attn, part_bias,
                                 num_nodes, heads, feat, num_rel, col_tiles);
      return;
    }
    if (vh == 8) {
      launch_rel_tiles<RM, 8, 1>(grid, st, h, w, b, part_attn, part_bias,
                                 num_nodes, heads, feat, num_rel, col_tiles);
      return;
    }
  }
  if (vh == 4 && vw) {
    launch_rel_tiles<RM, 4, 4>(grid, st, h, w, b, part_attn, part_bias,
                               num_nodes, heads, feat, num_rel, col_tiles);
  } else if (vh == 4) {
    launch_rel_tiles<RM, 4, 1>(grid, st, h, w, b, part_attn, part_bias,
                               num_nodes, heads, feat, num_rel, col_tiles);
  } else {
    launch_rel_tiles<RM, 1, 1>(grid, st, h, w, b, part_attn, part_bias,
                               num_nodes, heads, feat, num_rel, col_tiles);
  }
}

// The mma design's grid over one run of rows (see the kernel): m-tiles a
// block (16 relations each), relation tiles, feature tiles of up to
// kMmaNTiles n-tiles (balanced) and n-tiles a feature tile.
struct RelMmaShape {
  int mtiles, rel_tiles, col_tiles, tile_ntiles;
  int nwarps = 1, warp_ntiles = 0;  // warps along the features, n-tiles each
  int threads() const { return 32 * relgat::kMmaKWarps * mtiles * nwarps; }
};

// pad: features staged before a head's first (the TMA kernel's shift).
RelMmaShape rel_mma_shape(int feat, int num_rel, int pad) {
  using namespace relgat;
  RelMmaShape s;
  const int need = (num_rel + 15) / 16;
  s.mtiles = need < kMmaMaxMTiles ? need : kMmaMaxMTiles;
  s.rel_tiles = (num_rel + 16 * s.mtiles - 1) / (16 * s.mtiles);
  const int ntiles_all = (feat + pad + 7) / 8;
  s.col_tiles = (ntiles_all + kMmaNTiles - 1) / kMmaNTiles;
  s.tile_ntiles = (ntiles_all + s.col_tiles - 1) / s.col_tiles;
  return s;
}

// The TMA kernel's: where a head has at most kMmaWideNTiles n-tiles
// (F <= 384; the staged features start up to 7 before a head's first),
// feature tiles of up to kMmaMaxTmaNTiles n-tiles (balanced) over
// kMmaMaxNWarps warps of an even number of n-tiles each, so that a block
// stages and splits W once for up to 248 features; wider heads keep tiles
// of kMmaNTiles, one warp each. On an H100 80GB HBM3 at 700 W the wide
// tiles were faster at 12 x 300, 16 x 200 and 8 x 384 and slower at
// 4 x 512 and 2 x 1024 (PERF.md section 6).
RelMmaShape rel_mma_tma_shape(int feat, int num_rel) {
  using namespace relgat;
  RelMmaShape s = rel_mma_shape(feat, num_rel, feat % 8 ? 7 : 0);
  const int ntiles_all = (feat + (feat % 8 ? 7 : 0) + 7) / 8;
  const int most = ntiles_all <= kMmaWideNTiles ? kMmaMaxTmaNTiles
                                                : kMmaNTiles;
  s.col_tiles = (ntiles_all + most - 1) / most;
  s.tile_ntiles = (ntiles_all + s.col_tiles - 1) / s.col_tiles;
  s.nwarps = (s.tile_ntiles + kMmaNTiles - 1) / kMmaNTiles;
  s.warp_ntiles = 2 * ((s.tile_ntiles + 2 * s.nwarps - 1) / (2 * s.nwarps));
  if (s.warp_ntiles > kMmaNTiles) s.warp_ntiles = kMmaNTiles;
  return s;
}

// Runs of rows for `blocks` blocks a run when `slots` blocks fit the card
// at once: for each count of waves from 2 to 8, the most runs that fit
// (at most max_runs), costed as waves x rows a run (whole stages); the
// cheapest, and of equal costs the fewest runs.
int rel_mma_runs(int num_nodes, int blocks, int slots, int max_runs) {
  using namespace relgat;
  int best_runs = 1;
  int64_t best_cost = -1;
  for (int waves = 2; waves <= 8; ++waves) {
    int runs = static_cast<int>(static_cast<int64_t>(waves) * slots / blocks);
    runs = runs < 1 ? 1 : (runs > max_runs ? max_runs : runs);
    const int per = (num_nodes + runs - 1) / runs;
    const int64_t rows = (per + kMmaStageRows - 1) / kMmaStageRows;
    const int64_t used =
        (static_cast<int64_t>(runs) * blocks + slots - 1) / slots;
    const int64_t cost = used * rows;
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && runs < best_runs)) {
      best_cost = cost;
      best_runs = runs;
    }
  }
  return best_runs;
}

// The rows a run: the node rows spread over `runs`, whole stages.
int rel_mma_run_rows(int num_nodes, int runs) {
  using namespace relgat;
  const int per = (num_nodes + runs - 1) / runs;
  return (per + kMmaStageRows - 1) / kMmaStageRows * kMmaStageRows;
}

// Runs for `kernel` at `threads` threads and `smem` bytes a block, from the
// card's SM count and the kernel's occupancy (rel_mma_runs).
template <typename K>
cudaError_t rel_mma_plan(K kernel, int threads, int smem, int num_nodes,
                         int blocks_per_run, int max_runs, int* runs) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *runs = rel_mma_runs(num_nodes, blocks_per_run, per_sm * sms, max_runs);
  if (static_cast<int64_t>(*runs) * blocks_per_run > 0x7fffffff)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int VH, int VW>
cudaError_t launch_rel_mma_v(const __nv_bfloat16* h, const float* w,
                             const float* b, float* part_attn,
                             float* part_bias, int num_nodes, int heads,
                             int feat, int num_rel, int max_runs,
                             int* runs_out, int* blocks_out,
                             cudaStream_t st) {
  using namespace relgat;
  const RelMmaShape s = rel_mma_shape(feat, num_rel, 0);
  // the stages, then the dbias groups' sums
  const int smem = kMmaStages * mma_stage_bytes(s.mtiles, 8 * s.tile_ntiles) +
                   4 * (num_rel > kMmaMaxThreads ? num_rel : kMmaMaxThreads);
  auto kernel = relgat_bwd_rel_mma_kernel<VH, VW>;
  const int blocks_per_run = heads * s.rel_tiles * s.col_tiles;
  int runs = 0;
  cudaError_t err = rel_mma_plan(kernel, s.threads(), smem, num_nodes,
                                 blocks_per_run, max_runs, &runs);
  if (err != cudaSuccess) return err;
  kernel<<<runs * blocks_per_run, s.threads(), smem, st>>>(
      h, w, b, part_attn, part_bias, num_nodes, heads, feat, num_rel,
      rel_mma_run_rows(num_nodes, runs), s.mtiles, s.rel_tiles, s.col_tiles,
      s.tile_ntiles);
  *runs_out = runs;
  *blocks_out = blocks_per_run;
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda).
cudaError_t encode_tiled_fn(PFN_cuTensorMapEncodeTiled_v12000* fn) {
  static PFN_cuTensorMapEncodeTiled_v12000 cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 2-D map of a [rows, cols] row-major tensor in boxes of box_rows x
// box_cols, zeros outside it.
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                      int elem_bytes, const void* base, int64_t rows,
                      int64_t cols, int box_rows, int box_cols) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The mma design staged by the TMA (relgat_bwd_rel_mma_tma_kernel). Its
// staged h rows are hstride = 8 x an odd number of features wide (the tile
// and more), so that the 8 rows one ldmatrix reads start on 8 distinct
// 16-byte banks; W rows mma_w_stride relations, as the cp.async kernel's.
cudaError_t launch_rel_mma_tma(const __nv_bfloat16* h, const float* w,
                               const float* b, float* part_attn,
                               float* part_bias, int num_nodes, int heads,
                               int feat, int num_rel, int max_runs,
                               int* runs_out, int* blocks_out,
                               cudaStream_t st) {
  using namespace relgat;
  const RelMmaShape s = rel_mma_tma_shape(feat, num_rel);
  const int hstride = 8 * (s.tile_ntiles | 1);
  // W boxes as wide as the relations a block takes (R = 40: 40 of 48; its
  // A-fragment loads meet 2-way bank conflicts there, and read relations
  // past R from the next row, never written out)
  const int ws_stride = num_rel >= 16 * s.mtiles ? mma_w_stride(s.mtiles)
                                                 : (num_rel + 3) / 4 * 4;
  const int smem =
      kMmaStages * kMmaStageRows * (hstride * 2 + ws_stride * 4) +
      2 * kMmaStages * static_cast<int>(sizeof(uint64_t)) +
      4 * (num_rel > kMmaMaxTmaThreads ? num_rel : kMmaMaxTmaThreads);
  CUtensorMap hmap, wmap;
  cudaError_t err =
      encode_2d(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, num_nodes,
                static_cast<int64_t>(heads) * feat, kMmaStageRows, hstride);
  if (err != cudaSuccess) return err;
  err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, num_nodes,
                  static_cast<int64_t>(heads) * num_rel, kMmaStageRows,
                  ws_stride);
  if (err != cudaSuccess) return err;
  const int blocks_per_run = heads * s.rel_tiles * s.col_tiles;
  int runs = 0;
  err = rel_mma_plan(relgat_bwd_rel_mma_tma_kernel, s.threads(), smem,
                     num_nodes, blocks_per_run, max_runs, &runs);
  if (err != cudaSuccess) return err;
  relgat_bwd_rel_mma_tma_kernel<<<runs * blocks_per_run, s.threads(), smem,
                                  st>>>(
      hmap, wmap, b, part_attn, part_bias, num_nodes, heads, feat, num_rel,
      rel_mma_run_rows(num_nodes, runs), s.mtiles, s.rel_tiles, s.col_tiles,
      s.tile_ntiles, s.warp_ntiles, hstride, ws_stride);
  *runs_out = runs;
  *blocks_out = blocks_per_run;
  return cudaGetLastError();
}

// The tensor-core design over at most max_runs runs of rows (it picks how
// many, *runs_out, of *blocks_out blocks each). Staged by the TMA where a
// box can start on 16 bytes and h's and W's rows are 16-byte multiples (H*F
// a multiple of 8, R of 4, the bases 16-byte aligned: every model width);
// else by the block's threads with cp.async:
// 16-byte copies of h where F % 8 == 0, 8-byte where F % 4 == 0, else one
// value; W as the tile kernel.
int launch_rel_mma(const __nv_bfloat16* h, const float* w, const float* b,
                   float* part_attn, float* part_bias, int num_nodes,
                   int heads, int feat, int num_rel, int max_runs,
                   int* runs_out, int* blocks_out, cudaStream_t st) {
  if (static_cast<int64_t>(heads) * feat % 8 == 0 && aligned(h, 16) &&
      num_rel % 4 == 0 && aligned(w, 16)) {
    return static_cast<int>(launch_rel_mma_tma(h, w, b, part_attn, part_bias,
                                               num_nodes, heads, feat,
                                               num_rel, max_runs, runs_out,
                                               blocks_out, st));
  }
  const int vh = feat % 8 == 0 && aligned(h, 16)  ? 8
                 : feat % 4 == 0 && aligned(h, 8) ? 4
                                                  : 1;
  const bool vw = num_rel % 4 == 0 && aligned(w, 16);
#define RELGAT_REL_MMA(VH, VW)                                               \
  launch_rel_mma_v<VH, VW>(h, w, b, part_attn, part_bias, num_nodes, heads, \
                           feat, num_rel, max_runs, runs_out, blocks_out, st)
  const cudaError_t err = vh == 8 ? (vw ? RELGAT_REL_MMA(8, 4)
                                        : RELGAT_REL_MMA(8, 1))
                          : vh == 4 ? (vw ? RELGAT_REL_MMA(4, 4)
                                          : RELGAT_REL_MMA(4, 1))
                                    : RELGAT_REL_MMA(1, 1);
#undef RELGAT_REL_MMA
  return static_cast<int>(err);
}

// design: kRelDesignTile, or kRelDesignMma (bf16 h only). The tile design
// takes num_tiles = ceil(N / kRelTileRows) runs of rows and as many dbias
// partials. The mma design takes num_tiles as the most runs its buffers
// hold (part_attn [num_tiles, H, R, F], part_bias [num_tiles *
// kMmaBiasSlices, R]; at least one when N > 0) and uses as many as fill
// the card's waves best (rel_mma_runs).
template <typename TH>
int launch_bwd_rel(const TH* h, const float* w, const float* b,
                   float* part_attn, float* part_bias, float* dattn,
                   float* dbias, int num_nodes, int heads, int feat,
                   int num_rel, int num_tiles, int design, void* stream) {
  using namespace relgat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int runs = num_tiles;
  int bias_parts = num_tiles;
  if (design == kRelDesignMma) {
    if constexpr (sizeof(TH) != 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if ((num_nodes > 0) != (num_tiles > 0) || num_tiles < 0)
        return static_cast<int>(cudaErrorInvalidValue);
      if (num_tiles > 0) {
        int per_run = 0;
        const int err = launch_rel_mma(h, w, b, part_attn, part_bias,
                                       num_nodes, heads, feat, num_rel,
                                       num_tiles, &runs, &per_run, st);
        if (err != 0) return err;
        bias_parts = runs * (per_run < kMmaBiasSlices ? per_run
                                                      : kMmaBiasSlices);
      }
    }
  } else if (design != kRelDesignTile ||
             num_tiles != (num_nodes + kRelTileRows - 1) / kRelTileRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (num_tiles > 0) {
    const int rm_need = (num_rel + kRelWarps - 1) / kRelWarps;
    const int rm = rm_need <= 1    ? 1
                   : rm_need <= 2  ? 2
                   : rm_need <= 4  ? 4
                   : rm_need <= 6  ? 6
                   : rm_need <= 8  ? 8
                   : rm_need <= 10 ? 10
                   : rm_need <= 12 ? 12
                                   : 16;
    const int col_tiles = (feat + kRelCols - 1) / kRelCols;
    const int rel_tiles = (num_rel + kRelWarps * rm - 1) / (kRelWarps * rm);
    const dim3 grid(num_tiles, heads, rel_tiles * col_tiles);
    // 16-byte copies where every row starts 16-byte aligned.
    // 16-byte copies where every row starts 16-byte aligned; for bf16 h
    // with F a multiple of 4 and not of 8 (F = 300), 8-byte copies.
    const int vh16 = 16 / sizeof(TH);
    const int vh = feat % vh16 == 0 && aligned(h, 16)      ? vh16
                   : sizeof(TH) == 2 && feat % 4 == 0 && aligned(h, 8) ? 4
                                                                       : 1;
    const bool vw = vh > 1 && num_rel % 4 == 0 && aligned(w, 16) &&
                    aligned(b, 16);
#define RELGAT_REL_LAUNCH(RM)                                                \
  launch_rel_tiles_rm<RM>(vh, vw, grid, st, h, w, b, part_attn, part_bias,   \
                          num_nodes, heads, feat, num_rel, col_tiles)
    switch (rm) {
      case 1: RELGAT_REL_LAUNCH(1); break;
      case 2: RELGAT_REL_LAUNCH(2); break;
      case 4: RELGAT_REL_LAUNCH(4); break;
      case 6: RELGAT_REL_LAUNCH(6); break;
      case 8: RELGAT_REL_LAUNCH(8); break;
      case 10: RELGAT_REL_LAUNCH(10); break;
      case 12: RELGAT_REL_LAUNCH(12); break;
      default: RELGAT_REL_LAUNCH(16); break;
    }
#undef RELGAT_REL_LAUNCH
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = static_cast<int64_t>(heads) * num_rel * feat;
  const int64_t threads = total > num_rel ? total : num_rel;
  relgat_bwd_rel_reduce_kernel<<<static_cast<unsigned>((threads + 255) / 256),
                                 256, 0, st>>>(part_attn, part_bias, dattn,
                                               dbias, runs, total, num_rel,
                                               bias_parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int relgat_bwd_src(
    const float* h, const float* g, const float* attn, const float* m,
    const float* l, const float* s_dot, const float* gsum, const int* items,
    const int* merge, const int* dst, const int* etype, const int* eid,
    float* dh, float* w_out, float* b_out, int num_rows, int num_items,
    int num_split, int heads, int feat, int num_rel, float slope, float eps,
    int use_dropout, int seed, unsigned int thr, float keep_prob, int kernel,
    void* stream) {
  return launch_bwd_src(h, g, attn, m, l, s_dot, gsum, items, merge, dst,
                        etype, eid, dh, w_out, b_out, num_rows, num_items,
                        num_split, heads, feat, num_rel, slope, eps,
                        use_dropout, seed, thr, keep_prob, kernel, stream);
}

// The same with h and g in bf16 (kernel_precision="default").
extern "C" int relgat_bwd_src_bf16(
    const __nv_bfloat16* h, const __nv_bfloat16* g, const float* attn,
    const float* m, const float* l, const float* s_dot, const float* gsum,
    const int* items, const int* merge, const int* dst, const int* etype,
    const int* eid, float* dh, float* w_out, float* b_out, int num_rows,
    int num_items, int num_split, int heads, int feat, int num_rel,
    float slope, float eps, int use_dropout, int seed, unsigned int thr,
    float keep_prob, int kernel, void* stream) {
  return launch_bwd_src(h, g, attn, m, l, s_dot, gsum, items, merge, dst,
                        etype, eid, dh, w_out, b_out, num_rows, num_items,
                        num_split, heads, feat, num_rel, slope, eps,
                        use_dropout, seed, thr, keep_prob, kernel, stream);
}

extern "C" int relgat_bwd_rel(const float* h, const float* w, const float* b,
                              float* part_attn, float* part_bias,
                              float* dattn, float* dbias, int num_nodes,
                              int heads, int feat, int num_rel, int num_tiles,
                              void* stream) {
  return launch_bwd_rel(h, w, b, part_attn, part_bias, dattn, dbias,
                        num_nodes, heads, feat, num_rel, num_tiles,
                        relgat::kRelDesignTile, stream);
}

// The same with h in bf16 (kernel_precision="default"), in either design:
// kRelDesignTile (the SIMT tile kernel) or kRelDesignMma (tensor cores).
extern "C" int relgat_bwd_rel_bf16(const __nv_bfloat16* h, const float* w,
                                   const float* b, float* part_attn,
                                   float* part_bias, float* dattn,
                                   float* dbias, int num_nodes, int heads,
                                   int feat, int num_rel, int num_tiles,
                                   int design, void* stream) {
  return launch_bwd_rel(h, w, b, part_attn, part_bias, dattn, dbias,
                        num_nodes, heads, feat, num_rel, num_tiles, design,
                        stream);
}
