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
//   relgat_bwd_src_kernel   one warp per (src row, head) walks the row's
//       out-edges in src-CSR order with h[s] and the dh accumulator in
//       registers and writes every dh row once. It folds each edge's de into
//       a slab of R floats in shared memory that only this warp touches (the
//       head-0 warp folds gsum[d] into one more), lane 0 adding edge by edge,
//       and writes the slabs out as W[s, head, :] and B[s, :], zeros
//       included. W costs N*H*R*4 bytes (256 MB at N = 100k, H = 16,
//       R = 40), B N*R*4; no per-edge array is written (the per-edge de
//       [E, H] of the first design was 64 MB at 1M edges).
//   relgat_bwd_rel_*        a streaming reduction over node rows: each block
//       takes a tile of kRelTileRows rows of one head, stages W and h through
//       shared memory with cp.async (kRelStages buffers), accumulates an
//       [R, F] partial in registers and writes it; a second kernel sums the
//       partials in tile order.
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
// measured against this one. relgat_bwd_rel_bf16 is bounded by its FMA
// loop, not its bytes, as in fp32.
//
// Wider heads (F > 128, up to 1024), fp32 or bf16 rows:
// relgat_bwd_src_ring_kernel gives a block a source row and a group of up to
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
                      const int* __restrict__ src_ptr,  // [N + 1]
                      const int* __restrict__ dst,      // [E] src-sorted
                      const int* __restrict__ etype,    // [E] src-sorted
                      const int* __restrict__ eid,      // [E] src-sorted
                      float* __restrict__ dh,           // [N, H*F]
                      float* __restrict__ w_out,        // [N, H, R]
                      float* __restrict__ b_out,        // [N, R]
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
  const int s = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;
  EdgeEntry* table = reinterpret_cast<EdgeEntry*>(smem) + warp * 32;
  float* slabs = smem + warps * 32 * (sizeof(EdgeEntry) / sizeof(float));
  float* slab = slabs + warp * num_rel;
  float* bslab = head == 0 ? slabs + warps * num_rel : nullptr;
  for (int r = lane; r < num_rel; r += 32) {
    slab[r] = 0.f;
    if (bslab != nullptr) bslab[r] = 0.f;
  }

  float hv[FPL];
  float acc[FPL];
  load_row<VEC, NV>(h + row, feat, lane, hv);
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
  const T* g_head = g + static_cast<int64_t>(head) * feat;
  const float* attn_head = attn + static_cast<int64_t>(head) * num_rel * feat;

  const int p_end = src_ptr[s + 1];
  for (int p0 = src_ptr[s]; p0 < p_end; p0 += 32) {
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
      e.gsum = bslab != nullptr ? gsum[e.dst] : 0.f;
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
        if (bslab != nullptr) bslab[e.rel] += e.gsum;
      }
    }
  }

  store_row<VEC, NV>(dh + row, feat, lane, acc);
  __syncwarp();
  float* wrow = w_out + (static_cast<int64_t>(s) * heads + head) * num_rel;
  for (int r = lane; r < num_rel; r += 32) {
    wrow[r] = slab[r];
    if (bslab != nullptr) b_out[static_cast<int64_t>(s) * num_rel + r] = bslab[r];
  }
}

// Four blocks an SM for the pair kernel (32 warps, at most 64 registers): a
// lane holds 8 features of h, of g, of attn and of the dh sum, which fit
// 64 registers without spills.
constexpr int kBwdPairMinBlocks = 4;

// relgat_bwd_src_kernel over bf16 rows of F <= 128 with F % 8 == 0, in
// blocks of (src row, group of up to 16 heads): warp w takes the two
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
                           const int* __restrict__ src_ptr,  // [N + 1]
                           const int* __restrict__ dst,      // [E]
                           const int* __restrict__ etype,    // [E]
                           const int* __restrict__ eid,      // [E]
                           float* __restrict__ dh,           // [N, H*F]
                           float* __restrict__ w_out,        // [N, H, R]
                           float* __restrict__ b_out,        // [N, R]
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
  const int s = blockIdx.x;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const int64_t row = s * hf + static_cast<int64_t>(head) * feat;
  EdgeEntry* table = reinterpret_cast<EdgeEntry*>(smem) + warp * 32 + 16 * half;
  float* slabs = smem + warps * 32 * (sizeof(EdgeEntry) / sizeof(float));
  float* slab = slabs + (2 * warp + half) * num_rel;
  float* bslab = head == 0 ? slabs + 2 * warps * num_rel : nullptr;
  if (active) {
    for (int r = hl; r < num_rel; r += 16) {
      slab[r] = 0.f;
      if (bslab != nullptr) bslab[r] = 0.f;
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

  const int p_end = src_ptr[s + 1];
  for (int p0 = src_ptr[s]; p0 < p_end; p0 += 16) {
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
      e.gsum = bslab != nullptr ? gsum[e.dst] : 0.f;
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
        if (bslab != nullptr) bslab[e.rel] += e.gsum;
      }
    }
  }

  if (in_row) {
    *reinterpret_cast<float4*>(dh + row + f) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dh + row + f + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncwarp();
  if (!active) return;
  float* wrow = w_out + (static_cast<int64_t>(s) * heads + head) * num_rel;
  for (int r = hl; r < num_rel; r += 16) {
    wrow[r] = slab[r];
    if (bslab != nullptr) b_out[static_cast<int64_t>(s) * num_rel + r] = bslab[r];
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
  float gsum;  // gsum[d], for the head-0 warp only
  float pad;
};

// Heads wider than 128 features, fp32 or bf16 rows. Block (src row s, group
// of up to kRingBwdGroupHeads heads): warps 0 .. G-1 are the group's heads, one
// each, and warp G the producer, which streams the group's slice of g[dst]
// of each out-edge, in src-CSR order, through `stages` ring stages of
// `stage_elems` values with one bulk copy an edge. A head's warp keeps h[s]
// and the dh sum in registers, all lanes busy (the VW layout of
// relgat_common.cuh); its lanes load the
// per-edge values of 32 out-edges at a time (dst, relation, m, 1 / l, S,
// the dropout keep, and gsum for head 0) into the warp's RingEntry table.
// Per edge it loads its attn row, waits for the stage, reads its F values
// of g[dst] and releases the stage, then computes alpha and de as
// relgat_bwd_src_kernel does and folds de (and, head 0, gsum[dst]) into its
// slab in shared memory. dh, W and B are written once, as there.
template <int NK, int VW, typename T>
__global__ void __launch_bounds__(32 * (kRingBwdGroupHeads + 1),
                                  ring_bwd_warps<NK>() / (kRingBwdGroupHeads + 1))
relgat_bwd_src_ring_kernel(const T* __restrict__ h,          // [N, H*F]
                           const T* __restrict__ g,          // [N, H*F]
                           const float* __restrict__ attn,   // [H, R, F]
                           const float* __restrict__ m,      // [N, H]
                           const float* __restrict__ l,      // [N, H]
                           const float* __restrict__ s_dot,  // [N, H]
                           const float* __restrict__ gsum,   // [N]
                           const int* __restrict__ src_ptr,  // [N + 1]
                           const int* __restrict__ dst,      // [E]
                           const int* __restrict__ etype,    // [E]
                           const int* __restrict__ eid,      // [E]
                           float* __restrict__ dh,           // [N, H*F]
                           float* __restrict__ w_out,        // [N, H, R]
                           float* __restrict__ b_out,        // [N, R]
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
  const int s = blockIdx.x / head_groups;
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
  const int p_begin = src_ptr[s];
  const int p_end = src_ptr[s + 1];

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
      e.pad = 0.f;
      table[lane] = e;
    }
    __syncwarp();
    for (int j = 0; j < cnt; ++j) {
      const RingEntry e = table[j];
      const int d = e.dst;
      const int rel = e.rel;
      float av[NK];
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
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        eraw += hv[k] * av[k];
        dalpha += hv[k] * gv[k];
      }
      warp_sum2(eraw, dalpha, lane);
      const float alpha = expf(leaky_relu(eraw, slope) - e.m_safe) * e.inv_denom;
      const float de =
          alpha * (dalpha * e.keep - e.s) * (eraw >= 0.f ? 1.f : slope);
      const float aw = alpha * e.keep;
#pragma unroll
      for (int k = 0; k < NK; ++k) acc[k] += aw * gv[k] + de * av[k];
      if (lane == 0) {
        slab[rel] += de;
        if (bslab != nullptr) bslab[rel] += e.gsum;
      }
    }
  }

  lane_store<NK, VW>(dh + row, feat, lane, acc);
  __syncwarp();
  float* wrow = w_out + (static_cast<int64_t>(s) * heads + head) * num_rel;
  for (int r = lane; r < num_rel; r += 32) {
    wrow[r] = slab[r];
    if (bslab != nullptr) b_out[static_cast<int64_t>(s) * num_rel + r] = bslab[r];
  }
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
// flat sum of part_attn [T, H*R*F], dbias [R] that of part_bias [T, R].
__global__ void __launch_bounds__(256)
relgat_bwd_rel_reduce_kernel(const float* __restrict__ part_attn,
                             const float* __restrict__ part_bias,
                             float* __restrict__ dattn,
                             float* __restrict__ dbias, int num_tiles,
                             int64_t total, int num_rel) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) {
    float a = 0.f;
#pragma unroll 8
    for (int t = 0; t < num_tiles; ++t) a += part_attn[t * total + i];
    dattn[i] = a;
  }
  if (i < num_rel) {
    float s = 0.f;
    for (int t = 0; t < num_tiles; ++t) s += part_bias[t * num_rel + i];
    dbias[i] = s;
  }
}

}  // namespace relgat

namespace {

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The ring kernel, NK features a lane in the VW layout, in blocks of up to
// kRingBwdGroupHeads heads (the groups balanced, as in the forward).
template <int NK, int VW, typename T>
cudaError_t launch_bwd_ring(const T* h, const T* g, const float* attn,
                            const float* m, const float* l,
                            const float* s_dot, const float* gsum,
                            const int* src_ptr, const int* dst,
                            const int* etype, const int* eid, float* dh,
                            float* w_out, float* b_out, int num_nodes,
                            int heads, int feat, int num_rel, float slope,
                            float eps, int use_dropout, int seed,
                            unsigned int thr, float keep_prob,
                            cudaStream_t st) {
  using namespace relgat;
  constexpr int kG = kRingBwdGroupHeads;
  const int groups = (heads + kG - 1) / kG;
  const int gh = (heads + groups - 1) / groups;
  const int elems = ring_stage_elems(gh * feat, sizeof(T));
  const int stage_bytes = elems * static_cast<int>(sizeof(T));
  const int fit = kRingBytes / stage_bytes;
  const int stages = fit < 2 ? 2 : (fit > kRingMaxStages ? kRingMaxStages : fit);
  const size_t smem =
      static_cast<size_t>(stages) * (stage_bytes + 2 * sizeof(uint64_t)) +
      static_cast<size_t>(gh) * 32 * sizeof(RingEntry) +
      static_cast<size_t>(gh + 1) * num_rel * sizeof(float);
  auto kernel = relgat_bwd_src_ring_kernel<NK, VW, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_nodes * groups, 32 * (gh + 1), smem, st>>>(
      h, g, attn, m, l, s_dot, gsum, src_ptr, dst, etype, eid, dh, w_out,
      b_out, groups, gh, heads, feat, num_rel, stages, elems, slope, eps,
      use_dropout, static_cast<uint32_t>(seed), thr, keep_prob);
  return cudaGetLastError();
}

// design: kDesignLanes or kDesignRing (relgat_common.cuh), at F > 128.
template <typename T>
int launch_bwd_src(const T* h, const T* g, const float* attn, const float* m,
                   const float* l, const float* s_dot, const float* gsum,
                   const int* src_ptr, const int* dst, const int* etype,
                   const int* eid, float* dh, float* w_out, float* b_out,
                   int num_nodes, int heads, int feat, int num_rel,
                   float slope, float eps, int use_dropout, int seed,
                   unsigned int thr, float keep_prob, int design,
                   void* stream) {
  using namespace relgat;
  const int wpb = heads < kMaxWarpsPerBlock ? heads : kMaxWarpsPerBlock;
  const size_t smem = static_cast<size_t>(wpb) * 32 * sizeof(EdgeEntry) +
                      static_cast<size_t>(wpb + 1) * num_rel * sizeof(float);
  if (smem > static_cast<size_t>(kMaxBwdSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * wpb);
  const dim3 grid(num_nodes, (heads + wpb - 1) / wpb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 4 values a vector: 16 bytes of an fp32 row, 8 of a bf16 one
  const bool vec4 = feat % 4 == 0 && aligned(h, 4 * sizeof(T)) &&
                    aligned(g, 4 * sizeof(T)) && aligned(attn, 16) &&
                    aligned(dh, 16);
#define RELGAT_BWD_LAUNCH(VEC, NV)                                           \
  relgat_bwd_src_kernel<VEC, NV, T><<<grid, block, smem, st>>>(              \
      h, g, attn, m, l, s_dot, gsum, src_ptr, dst, etype, eid, dh, w_out,    \
      b_out, heads, feat, num_rel, slope, eps, use_dropout,                  \
      static_cast<uint32_t>(seed), thr, keep_prob)
#define RELGAT_BWD_RING(NK, VW)                                              \
  static_cast<int>(launch_bwd_ring<NK, VW>(                                  \
      h, g, attn, m, l, s_dot, gsum, src_ptr, dst, etype, eid, dh, w_out,    \
      b_out, num_nodes, heads, feat, num_rel, slope, eps, use_dropout, seed, \
      thr, keep_prob, st))
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  // The pair kernel: two heads a warp, up to 16 heads a block; a table of
  // 2 x 16 edges a warp, one slab a head and one more.
  const int pairs = (heads + 1) / 2;
  const int wpb2 = pairs < kMaxWarpsPerBlock ? pairs : kMaxWarpsPerBlock;
  const size_t pair_smem =
      static_cast<size_t>(wpb2) * 32 * sizeof(EdgeEntry) +
      static_cast<size_t>(2 * wpb2 + 1) * num_rel * sizeof(float);
  if (kBf16 && vec4 && feat % 8 == 0 && feat <= 128 && aligned(h, 16) &&
      aligned(g, 16) && pair_smem <= static_cast<size_t>(kMaxBwdSmemBytes)) {
    const dim3 grid2(num_nodes, (pairs + wpb2 - 1) / wpb2);
    relgat_bwd_src_pair_kernel<<<grid2, 32 * wpb2, pair_smem, st>>>(
        reinterpret_cast<const __nv_bfloat16*>(h),
        reinterpret_cast<const __nv_bfloat16*>(g), attn, m, l, s_dot, gsum,
        src_ptr, dst, etype, eid, dh, w_out, b_out, heads, feat, num_rel,
        slope, eps, use_dropout, static_cast<uint32_t>(seed), thr,
        keep_prob);
  } else if (feat > 32 * kMaxFeatPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (feat > 128 && design == kDesignRing) {
    // two values a read where every head's piece of a row is 2-value aligned
    const bool pairs = feat % 2 == 0 && aligned(h, 2 * sizeof(T)) &&
                       aligned(g, 2 * sizeof(T)) && aligned(attn, 8) &&
                       aligned(dh, 8);
    if (pairs) {
      return feat <= 256   ? RELGAT_BWD_RING(8, 2)
             : feat <= 320 ? RELGAT_BWD_RING(10, 2)
             : feat <= 512 ? RELGAT_BWD_RING(16, 2)
                           : RELGAT_BWD_RING(32, 2);
    }
    return feat <= 256   ? RELGAT_BWD_RING(8, 1)
           : feat <= 320 ? RELGAT_BWD_RING(10, 1)
           : feat <= 512 ? RELGAT_BWD_RING(16, 1)
                         : RELGAT_BWD_RING(32, 1);
  } else if (vec4 && feat <= 128) {
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
#undef RELGAT_BWD_RING
#undef RELGAT_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
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

template <typename TH>
int launch_bwd_rel(const TH* h, const float* w, const float* b,
                   float* part_attn, float* part_bias, float* dattn,
                   float* dbias, int num_nodes, int heads, int feat,
                   int num_rel, int num_tiles, void* stream) {
  using namespace relgat;
  if (num_tiles != (num_nodes + kRelTileRows - 1) / kRelTileRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
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
                                               dbias, num_tiles, total,
                                               num_rel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int relgat_bwd_src(const float* h, const float* g,
                              const float* attn, const float* m,
                              const float* l, const float* s_dot,
                              const float* gsum, const int* src_ptr,
                              const int* dst, const int* etype, const int* eid,
                              float* dh, float* w_out, float* b_out,
                              int num_nodes, int heads, int feat, int num_rel,
                              float slope, float eps, int use_dropout,
                              int seed, unsigned int thr, float keep_prob,
                              int design, void* stream) {
  return launch_bwd_src(h, g, attn, m, l, s_dot, gsum, src_ptr, dst, etype,
                        eid, dh, w_out, b_out, num_nodes, heads, feat,
                        num_rel, slope, eps, use_dropout, seed, thr,
                        keep_prob, design, stream);
}

// The same with h and g in bf16 (kernel_precision="default").
extern "C" int relgat_bwd_src_bf16(
    const __nv_bfloat16* h, const __nv_bfloat16* g, const float* attn,
    const float* m, const float* l, const float* s_dot, const float* gsum,
    const int* src_ptr, const int* dst, const int* etype, const int* eid,
    float* dh, float* w_out, float* b_out, int num_nodes, int heads,
    int feat, int num_rel, float slope, float eps, int use_dropout, int seed,
    unsigned int thr, float keep_prob, int design, void* stream) {
  return launch_bwd_src(h, g, attn, m, l, s_dot, gsum, src_ptr, dst, etype,
                        eid, dh, w_out, b_out, num_nodes, heads, feat,
                        num_rel, slope, eps, use_dropout, seed, thr,
                        keep_prob, design, stream);
}

extern "C" int relgat_bwd_rel(const float* h, const float* w, const float* b,
                              float* part_attn, float* part_bias,
                              float* dattn, float* dbias, int num_nodes,
                              int heads, int feat, int num_rel, int num_tiles,
                              void* stream) {
  return launch_bwd_rel(h, w, b, part_attn, part_bias, dattn, dbias,
                        num_nodes, heads, feat, num_rel, num_tiles, stream);
}

// The same with h in bf16 (kernel_precision="default").
extern "C" int relgat_bwd_rel_bf16(const __nv_bfloat16* h, const float* w,
                                   const float* b, float* part_attn,
                                   float* part_bias, float* dattn,
                                   float* dbias, int num_nodes, int heads,
                                   int feat, int num_rel, int num_tiles,
                                   void* stream) {
  return launch_bwd_rel(h, w, b, part_attn, part_bias, dattn, dbias,
                        num_nodes, heads, feat, num_rel, num_tiles, stream);
}
