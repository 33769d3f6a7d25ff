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
// What bounds it: the gather of one H*F row of h per edge, E * H*F * 4 bytes
// (8.19 GB at 1M edges and H*F = 2048), five times the 1.66 GB it must move
// once. At 100k rows h is 819 MB, far beyond the 50 MB L2, and a uniform
// random graph has no order that reuses rows, so the kernel runs at the rate
// this card gathers 8 KB rows. On an H100 80GB HBM3 (700 W) the first design,
// one warp per (row, head), moved 2.86 TB/s on such a graph, against 2.90
// TB/s for an index_select of whole rows and 3.02 TB/s for a copy.
//
// What the design does about it:
// - Work items, not rows. data/csr.py cuts the dst-CSR once per graph: a row
//   of at most kItemEdges in-edges is one item (rows without in-edges too),
//   a longer row is kItemEdges-edge chunks in order. A chunk writes its
//   partial (m_c, l_c, acc_c per head, fp64 bias sum) to scratch, and
//   relgat_fwd_merge_kernel combines each split row's chunks in one fixed
//   order: m = max m_c, l = sum l_c e^(m_c - m), acc = sum acc_c e^(m_c - m),
//   eight warps a (row, head), each over a contiguous run of chunks. So no
//   warp walks more than kItemEdges edges one after the other: a hub row with
//   83k in-edges (the head of a zipf graph at 100k nodes and 1M edges) is 323
//   items spread over the card, not one warp's serial walk that outlasts the
//   rest of the grid (49 ms for that graph against 3.15 ms for a uniform one
//   in the first design, on the card above). Nothing is atomic, so two calls
//   give the same bits. Dropout stays keyed by the canonical edge id, read
//   from `eid` (the dst-CSR position for a whole graph; a halo shard's local
//   or remote subset carries its position in the shard's edge list), into
//   the block's table beside (src, etype) when dropout is on.
// - The source rows h[src] may be another space than the destination rows:
//   a halo shard's remote subset gathers from the received halo buffer.
// - One warp per head, 8 to a block, and the blocks of an item's head groups
//   adjacent in the grid, so the 16 heads' 512-byte segments of a source row
//   (8 KB) are requested together. The block loads the item's (src, etype)
//   pairs once into a shared table, which takes the index loads off each
//   edge's dependent chain; a lane reads its share of a row 16 bytes at a
//   time (F = 128).
// - Registers capped at 32 so 64 warps fit an SM: on this card the warps in
//   flight, not the instructions per edge, set the rate of a gather-bound
//   kernel; 64 warps x 512 bytes is 32 KB of rows in flight an SM.
//
// The bf16 variant (relgat_fwd_bf16, kernel_precision="default") reads h as
// bf16 rows, the TPU kernel's bf16 `ps` stream (kernels.py `_stream_dtype`):
// half the gathered bytes (4.1 GB at the shapes above, a 1.22 ms floor; the
// bound of the bytes each tensor must move once is 0.37 ms). All arithmetic,
// attn, out, the statistics and the merge stay fp32. Where F is a multiple
// of 8 and at most 128, relgat_fwd_pair_kernel gives a warp two adjacent
// heads of the item, a half-warp each, 16 bytes a lane, so a warp's load of
// an edge's row is one contiguous 512-byte piece and a block of 8 warps
// reads the whole 4 KB row: on this card the size of each warp's contiguous
// piece, not the bytes in flight (48 warps x 512 bytes = 24 KB an SM), set
// the rate. Other widths run relgat_fwd_kernel on bf16 rows.
//
// Wider heads (F > 128, up to 1024; the library's default 12 x 300, the
// reference's doc-scale 16 x 200), fp32 or bf16 rows: relgat_fwd_kernel
// holds a head in a bucket of 8, 16 or 32 features a lane (F <= 256, 512,
// 1024), so at F = 300 a warp's load of a head's row keeps 19 of 32 lanes
// busy and its accumulators cap the warps in flight. relgat_fwd_ring_kernel
// gives a block an item and a group of up to kRingFwdGroupHeads heads: a
// producer warp copies each edge's slice of h[src] (the group's heads,
// contiguous in the row, 4.8 KB fp32 / 2.4 KB bf16 at four heads of 300)
// into a ring of shared-memory stages with one bulk copy (cp.async.bulk,
// the TMA's 1-D copy) that completes on the stage's mbarrier, the < 16
// bytes a misaligned slice starts or ends with copied by the producer's
// lanes; one consumer warp a head reads its F features from the stage with
// every lane busy (two values a read where F is even) and releases the
// stage on a second mbarrier. Its attn row for the next edge is loaded
// while it finishes this one, and its sums are rescaled only where the
// running max grows. The split rows, the merge, the dropout hash, the fp32
// statistics and the absence of atomics are relgat_fwd_kernel's. On the
// card the ring is faster where F fills little of the template's bucket
// (5.78 against 6.97 ms fp32, 3.61 against 5.12 bf16 at 12 x 300, TRAIN's
// graph) and slower where it fills most of it (200, 256, 512) or past 512
// features, so the dispatch takes it at the widths where it measured
// faster (ops/cuda/fused.py RING_RANGES: fp32 257-448, bf16 257-368).
// PERF.md section 6 records the designs measured against this one.
#include "relgat_common.cuh"

namespace relgat {

// Most edges of one work item (data/csr.py FWD_ITEM_EDGES): the size of the
// block's shared edge table.
constexpr int kItemEdges = 256;
// Warps of a forward block: one per head of its item, up to this many; the
// blocks of one item's head groups are adjacent in the grid.
constexpr int kFwdWarps = 8;
// Blocks of kFwdWarps an SM: 8 caps registers at 32 a thread, 64 warps.
constexpr int kFwdMinBlocks = 8;
// The pair kernel holds 8 features a lane: 6 blocks, 40 registers.
constexpr int kFwdPairMinBlocks = 6;
// Warps that merge one (split row, head), each a contiguous run of chunks.
constexpr int kMergeWarps = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Block (item, head group): warp w takes head group * warps + w over the
// item's edges [e0, e1) of row d. slot < 0: the item is the whole row, and
// the warp writes out, m, l (and bias) itself; else it writes its partial to
// slot `slot` of the scratch. T is the element type of h.
template <int VEC, int NV, typename T>
__global__ void
__launch_bounds__(32 * kFwdWarps, VEC * NV <= 4 ? kFwdMinBlocks : 1)
relgat_fwd_kernel(const T* __restrict__ h,             // [N, H*F]
                  const float* __restrict__ attn,      // [H, R, F]
                  const float* __restrict__ rel_bias,  // [R]
                  const int4* __restrict__ items,      // [I] (d, e0, e1, slot)
                  const int* __restrict__ src,         // [E] dst-sorted
                  const int* __restrict__ etype,       // [E] dst-sorted
                  const int* __restrict__ eid,         // [E] canonical ids
                  float* __restrict__ out,             // [N, H*F]
                  float* __restrict__ m_out,           // [N, H]
                  float* __restrict__ l_out,           // [N, H]
                  float* __restrict__ bias_out,        // [N]
                  float* __restrict__ part_acc,        // [P, H, F]
                  float2* __restrict__ part_ml,        // [P, H] (m_c, l_c)
                  double* __restrict__ part_bias,      // [P]
                  int head_groups, int heads, int feat, int num_rel,
                  float slope, float eps, int use_dropout, uint32_t seed,
                  uint32_t thr, float keep_prob) {
  constexpr int FPL = VEC * NV;
  __shared__ __align__(16) int2 table[kItemEdges];  // (src, etype)
  __shared__ int ids[kItemEdges];                   // canonical edge ids
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int4 item = items[blockIdx.x / head_groups];
  const int d = item.x;
  const int e0 = item.y;
  const int cnt = item.z - item.y;
  const int slot = item.w;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    table[i] = make_int2(src[e0 + i], etype[e0 + i]);
    if (use_dropout) ids[i] = eid[e0 + i];
  }
  __syncthreads();
  const int head = (blockIdx.x % head_groups) * warps + (threadIdx.x >> 5);
  if (head >= heads) return;

  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const T* h_head = h + static_cast<int64_t>(head) * feat;
  const float* a_head = attn + static_cast<int64_t>(head) * num_rel * feat;
  float acc[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  // One bias term per in-edge, never rescaled: summed in fp64 (in fp32 a
  // row of a few thousand edges would lose ~1e-5 of it), edge by edge, off
  // the chain of the row gather.
  double bsum = 0.0;
  for (int j = 0; j < cnt; ++j) {
    const int2 t = table[j];
    bsum += rel_bias[t.y];
    float hv[FPL];
    float av[FPL];
    load_row<VEC, NV>(h_head + t.x * hf, feat, lane, hv);
    load_row<VEC, NV>(a_head + static_cast<int64_t>(t.y) * feat, feat, lane,
                      av);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) dot += hv[i] * av[i];
    const float ev = leaky_relu(warp_sum(dot), slope);
    const float m_new = fmaxf(m, ev);
    const float scale = expf(m - m_new);  // 0 on the first edge (m = -inf)
    const float p = expf(ev - m_new);
    l = l * scale + p;
    const float pk =
        use_dropout ? p * dropout_keep(ids[j], head, seed, thr) / keep_prob : p;
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = acc[i] * scale + pk * hv[i];
    m = m_new;
  }

  if (slot < 0) {
    const float denom = fmaxf(l, eps);
    const float bias = static_cast<float>(bsum);
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] = acc[i] / denom + bias;
    store_row<VEC, NV>(out + d * hf + static_cast<int64_t>(head) * feat, feat,
                       lane, acc);
    if (lane == 0) {
      m_out[static_cast<int64_t>(d) * heads + head] = m;
      l_out[static_cast<int64_t>(d) * heads + head] = l;
      if (head == 0) bias_out[d] = bias;
    }
  } else {
    const int64_t ps = static_cast<int64_t>(slot) * heads + head;
    store_row<VEC, NV>(part_acc + ps * feat, feat, lane, acc);
    if (lane == 0) {
      part_ml[ps] = make_float2(m, l);
      if (head == 0) part_bias[slot] = bsum;
    }
  }
}

// Block (item, group of up to 16 heads) as relgat_fwd_kernel, over bf16 rows
// of F <= 128 with F % 8 == 0: warp w takes the two adjacent heads 2w and
// 2w + 1 of the group, half-warp `half` the second, lane hl features
// 8*hl .. 8*hl + 7 of its head (one 16-byte load). So a warp's load of an
// edge's row is one contiguous 512-byte piece at F = 128 (two 256-byte
// head segments), and a block's eight warps read the whole 4 KB row of
// each edge together. Each half walks all of the item's edges in order
// with its own running (m, l, acc), as relgat_fwd_kernel does for one head.
__global__ void
__launch_bounds__(32 * kFwdWarps, kFwdPairMinBlocks)
relgat_fwd_pair_kernel(const __nv_bfloat16* __restrict__ h,  // [N, H*F]
                       const float* __restrict__ attn,       // [H, R, F]
                       const float* __restrict__ rel_bias,   // [R]
                       const int4* __restrict__ items,
                       const int* __restrict__ src,
                       const int* __restrict__ etype,
                       const int* __restrict__ eid,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       float* __restrict__ bias_out,
                       float* __restrict__ part_acc,
                       float2* __restrict__ part_ml,
                       double* __restrict__ part_bias, int head_groups,
                       int heads, int feat, int num_rel, float slope,
                       float eps, int use_dropout, uint32_t seed,
                       uint32_t thr, float keep_prob) {
  __shared__ __align__(16) int2 table[kItemEdges];  // (src, etype)
  __shared__ int ids[kItemEdges];                   // canonical edge ids
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int f = 8 * (lane & 15);
  const int warps = blockDim.x >> 5;
  const int4 item = items[blockIdx.x / head_groups];
  const int d = item.x;
  const int e0 = item.y;
  const int cnt = item.z - item.y;
  const int slot = item.w;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    table[i] = make_int2(src[e0 + i], etype[e0 + i]);
    if (use_dropout) ids[i] = eid[e0 + i];
  }
  __syncthreads();
  const int pair = (blockIdx.x % head_groups) * warps + (threadIdx.x >> 5);
  if (2 * pair >= heads) return;
  // an odd head count leaves the last warp's second half without a head:
  // it reads nothing and writes nothing, but joins the shuffles
  const int head = 2 * pair + half;
  const bool active = head < heads;
  const bool in_row = active && f < feat;

  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const __nv_bfloat16* h_head = h + static_cast<int64_t>(head) * feat + f;
  const float* a_head = attn + static_cast<int64_t>(head) * num_rel * feat + f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  double bsum = 0.0;
  for (int j = 0; j < cnt; ++j) {
    const int2 t = table[j];
    bsum += rel_bias[t.y];
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a1 = a0;
    if (in_row) {
      x = *reinterpret_cast<const uint4*>(h_head + t.x * hf);
      const float* ap = a_head + static_cast<int64_t>(t.y) * feat;
      a0 = *reinterpret_cast<const float4*>(ap);
      a1 = *reinterpret_cast<const float4*>(ap + 4);
    }
    float hv[8];
    widen8(x, hv);
    float dot = hv[0] * a0.x + hv[1] * a0.y + hv[2] * a0.z + hv[3] * a0.w +
                hv[4] * a1.x + hv[5] * a1.y + hv[6] * a1.z + hv[7] * a1.w;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)  // within the half-warp
      dot += __shfl_xor_sync(kFullMask, dot, o);
    const float ev = leaky_relu(dot, slope);
    const float m_new = fmaxf(m, ev);
    const float scale = expf(m - m_new);  // 0 on the first edge (m = -inf)
    const float p = expf(ev - m_new);
    l = l * scale + p;
    const float pk =
        use_dropout ? p * dropout_keep(ids[j], head, seed, thr) / keep_prob : p;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] * scale + pk * hv[i];
    m = m_new;
  }
  if (!active) return;

  float* dst_row;
  const int hl = lane & 15;
  if (slot < 0) {
    const float denom = fmaxf(l, eps);
    const float bias = static_cast<float>(bsum);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] / denom + bias;
    dst_row = out + d * hf + static_cast<int64_t>(head) * feat;
    if (hl == 0) {
      m_out[static_cast<int64_t>(d) * heads + head] = m;
      l_out[static_cast<int64_t>(d) * heads + head] = l;
      if (head == 0) bias_out[d] = bias;
    }
  } else {
    const int64_t ps = static_cast<int64_t>(slot) * heads + head;
    dst_row = part_acc + ps * feat;
    if (hl == 0) {
      part_ml[ps] = make_float2(m, l);
      if (head == 0) part_bias[slot] = bsum;
    }
  }
  if (in_row) {
    *reinterpret_cast<float4*>(dst_row + f) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst_row + f + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// Heads wider than 128 features, fp32 or bf16 rows. Block (item, group of
// up to kRingFwdGroupHeads heads): warps 0 .. G-1 are the group's heads, one
// each, and warp G the producer. The producer streams each edge's slice of
// h[src] (the group's heads, contiguous in the row) through `stages` ring
// stages of `stage_elems` values with one bulk copy an edge; each head's
// warp reads its F features from the stage, all lanes busy (the VW layout
// of relgat_common.cuh), and runs relgat_fwd_kernel's online softmax over
// the item's edges in order, rescaling its sums only where the running max
// grows (elsewhere the scale is exactly 1). Outputs as relgat_fwd_kernel's.
template <int NK, int VW, typename T>
__global__ void __launch_bounds__(32 * (kRingFwdGroupHeads + 1),
                                  ring_fwd_warps<NK>() / (kRingFwdGroupHeads + 1))
relgat_fwd_ring_kernel(const T* __restrict__ h,             // [N, H*F]
                       const float* __restrict__ attn,      // [H, R, F]
                       const float* __restrict__ rel_bias,  // [R]
                       const int4* __restrict__ items,
                       const int* __restrict__ src,
                       const int* __restrict__ etype,
                       const int* __restrict__ eid,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out,
                       float* __restrict__ bias_out,
                       float* __restrict__ part_acc,
                       float2* __restrict__ part_ml,
                       double* __restrict__ part_bias, int head_groups,
                       int group_heads, int heads, int feat, int num_rel,
                       int stages, int stage_elems, float slope, float eps,
                       int use_dropout, uint32_t seed, uint32_t thr,
                       float keep_prob) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  __shared__ __align__(16) int2 table[kItemEdges];  // (src, etype)
  __shared__ int ids[kItemEdges];                   // canonical edge ids
  T* ring = reinterpret_cast<T*>(ring_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_elems);
  uint64_t* empty = full + stages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int4 item = items[blockIdx.x / head_groups];
  const int d = item.x;
  const int e0 = item.y;
  const int cnt = item.z - item.y;
  const int slot = item.w;
  const int h0 = (blockIdx.x % head_groups) * group_heads;
  const int gh = min(group_heads, heads - h0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], gh);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    table[i] = make_int2(src[e0 + i], etype[e0 + i]);
    if (use_dropout) ids[i] = eid[e0 + i];
  }
  __syncthreads();
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  const T* h_group = h + static_cast<int64_t>(h0) * feat;

  if (warp == group_heads) {  // the producer
    int st = 0;
    uint32_t ph = 0;
    for (int j = 0; j < cnt; ++j) {
      mbar_wait(&empty[st], ph ^ 1);  // the first round passes at once
      ring_load(ring + st * stage_elems, &full[st], h_group + table[j].x * hf,
                gh * feat, lane);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }
  if (warp >= gh) return;

  const int head = h0 + warp;
  const float* a_head = attn + static_cast<int64_t>(head) * num_rel * feat;
  float acc[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  double bsum = 0.0;  // fp64, off the chain: see relgat_fwd_kernel
  int st = 0;
  uint32_t ph = 0;
  // av holds the attn row of the edge at hand; once its dot product is
  // taken it is loaded with the next edge's, whose L2 latency then passes
  // during the rest of this edge's work
  float av[NK];
  if (cnt > 0)
    lane_row<NK, VW>(a_head + static_cast<int64_t>(table[0].y) * feat, feat,
                     lane, av);
  for (int j = 0; j < cnt; ++j) {
    const int2 t = table[j];
    bsum += rel_bias[t.y];
    const T* row = ring + st * stage_elems +
                   ring_shift(h_group + t.x * hf) + warp * feat;
    mbar_wait(&full[st], ph);
    float hv[NK];
    lane_row<NK, VW>(row, feat, lane, hv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k) dot += hv[k] * av[k];
    if (j + 1 < cnt)
      lane_row<NK, VW>(a_head + static_cast<int64_t>(table[j + 1].y) * feat,
                       feat, lane, av);
    const float ev = leaky_relu(warp_sum(dot), slope);
    if (ev > m) {  // the same on every lane
      const float scale = expf(m - ev);  // 0 on the first edge (m = -inf)
      l *= scale;
#pragma unroll
      for (int k = 0; k < NK; ++k) acc[k] *= scale;
      m = ev;
    }
    const float p = expf(ev - m);
    l += p;
    const float pk =
        use_dropout ? p * dropout_keep(ids[j], head, seed, thr) / keep_prob : p;
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[k] += pk * hv[k];
  }

  float* dst_row;
  if (slot < 0) {
    const float denom = fmaxf(l, eps);
    const float bias = static_cast<float>(bsum);
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[k] = acc[k] / denom + bias;
    dst_row = out + d * hf + static_cast<int64_t>(head) * feat;
    if (lane == 0) {
      m_out[static_cast<int64_t>(d) * heads + head] = m;
      l_out[static_cast<int64_t>(d) * heads + head] = l;
      if (head == 0) bias_out[d] = bias;
    }
  } else {
    const int64_t ps = static_cast<int64_t>(slot) * heads + head;
    dst_row = part_acc + ps * feat;
    if (lane == 0) {
      part_ml[ps] = make_float2(m, l);
      if (head == 0) part_bias[slot] = bsum;
    }
  }
  lane_store<NK, VW>(dst_row, feat, lane, acc);
}

// Block (split row, head): the row's slots [c0, c1) hold its chunks in
// order. Warp w sums the w-th contiguous run of them in order, and warp 0
// adds the warps' sums in warp order, so the result has one fixed order.
template <int VEC, int NV>
__global__ void __launch_bounds__(32 * kMergeWarps)
relgat_fwd_merge_kernel(const int* __restrict__ merge,  // [S, 3] (d, c0, c1)
                        const float* __restrict__ part_acc,
                        const float2* __restrict__ part_ml,
                        const double* __restrict__ part_bias,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out,
                        float* __restrict__ bias_out, int heads, int feat,
                        float eps) {
  constexpr int FPL = VEC * NV;
  __shared__ float s_max[kMergeWarps];
  __shared__ float s_l[kMergeWarps];
  __shared__ double s_bias[kMergeWarps];
  __shared__ float s_acc[kMergeWarps][32 * FPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x / heads;
  const int head = blockIdx.x % heads;
  const int d = merge[3 * row];
  const int c0 = merge[3 * row + 1];
  const int c1 = merge[3 * row + 2];

  // m = max m_c. Every chunk holds an edge, so every m_c is finite.
  float m = -INFINITY;
  for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x)
    m = fmaxf(m, part_ml[static_cast<int64_t>(c) * heads + head].x);
  m = warp_max(m);
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  m = s_max[0];
  for (int w = 1; w < kMergeWarps; ++w) m = fmaxf(m, s_max[w]);

  // l = sum l_c e^(m_c - m), acc = sum acc_c e^(m_c - m), bias = sum bias_c
  const int run = (c1 - c0 + kMergeWarps - 1) / kMergeWarps;
  const int a = min(c1, c0 + warp * run);
  const int b = min(c1, a + run);
  float acc[FPL];
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = 0.f;
  float l = 0.f;
  double bsum = 0.0;
#pragma unroll 4
  for (int c = a; c < b; ++c) {
    const int64_t ps = static_cast<int64_t>(c) * heads + head;
    const float2 ml = part_ml[ps];
    const float w = expf(ml.x - m);
    l += ml.y * w;
    bsum += part_bias[c];
    float cv[FPL];
    load_row<VEC, NV>(part_acc + ps * feat, feat, lane, cv);
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] += cv[i] * w;
  }
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < FPL; ++i) s_acc[warp][FPL * lane + i] = acc[i];
    if (lane == 0) {
      s_l[warp] = l;
      s_bias[warp] = bsum;
    }
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < kMergeWarps; ++w) {
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] += s_acc[w][FPL * lane + i];
    l += s_l[w];
    bsum += s_bias[w];
  }

  const float denom = fmaxf(l, eps);
  const float bias = static_cast<float>(bsum);
#pragma unroll
  for (int i = 0; i < FPL; ++i) acc[i] = acc[i] / denom + bias;
  const int64_t hf = static_cast<int64_t>(heads) * feat;
  store_row<VEC, NV>(out + d * hf + static_cast<int64_t>(head) * feat, feat,
                     lane, acc);
  if (lane == 0) {
    m_out[static_cast<int64_t>(d) * heads + head] = m;
    l_out[static_cast<int64_t>(d) * heads + head] = l;
    if (head == 0) bias_out[d] = bias;
  }
}

}  // namespace relgat

namespace {

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The arguments every forward kernel takes after its rows.
struct FwdArgs {
  const float* attn;
  const float* rel_bias;
  const int4* items;
  const int* src;
  const int* etype;
  const int* eid;
  const int* merge;
  float* out;
  float* m_out;
  float* l_out;
  float* bias_out;
  float* part_acc;
  float2* part_ml;
  double* part_bias;
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

template <int VEC, int NV>
cudaError_t launch_merge(const FwdArgs& a) {
  if (a.num_split > 0) {
    relgat::relgat_fwd_merge_kernel<VEC, NV>
        <<<a.num_split * a.heads, 32 * relgat::kMergeWarps, 0, a.st>>>(
            a.merge, a.part_acc, a.part_ml, a.part_bias, a.out, a.m_out,
            a.l_out, a.bias_out, a.heads, a.feat, a.eps);
  }
  return cudaGetLastError();
}

// The one-warp-a-head template, VEC * NV features a lane, and the merge.
template <int VEC, int NV, typename T>
cudaError_t launch_lanes(const T* h, const FwdArgs& a) {
  using namespace relgat;
  const int wpb = a.heads < kFwdWarps ? a.heads : kFwdWarps;
  const int groups = (a.heads + wpb - 1) / wpb;
  if (a.num_items > 0) {
    relgat_fwd_kernel<VEC, NV, T><<<a.num_items * groups, 32 * wpb, 0, a.st>>>(
        h, a.attn, a.rel_bias, a.items, a.src, a.etype, a.eid, a.out, a.m_out,
        a.l_out, a.bias_out, a.part_acc, a.part_ml, a.part_bias, groups,
        a.heads, a.feat, a.num_rel, a.slope, a.eps, a.use_dropout, a.seed,
        a.thr, a.keep_prob);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_merge<VEC, NV>(a);
}

// The ring kernel, NK features a lane in the VW layout, in blocks of up to
// kRingFwdGroupHeads heads (the groups balanced: 12 heads are three groups of
// 4, 5 heads two of 3 and 2), then the merge (VEC * NV features a lane).
template <int NK, int VW, int VEC, int NV, typename T>
cudaError_t launch_ring(const T* h, const FwdArgs& a) {
  using namespace relgat;
  constexpr int kG = kRingFwdGroupHeads;
  const int groups = (a.heads + kG - 1) / kG;
  const int gh = (a.heads + groups - 1) / groups;
  const int elems = ring_stage_elems(gh * a.feat, sizeof(T));
  const int stage_bytes = elems * static_cast<int>(sizeof(T));
  const int fit = kRingBytes / stage_bytes;
  const int stages = fit < 2 ? 2 : (fit > kRingMaxStages ? kRingMaxStages : fit);
  const size_t smem = static_cast<size_t>(stages) *
                      (stage_bytes + 2 * sizeof(uint64_t));
  if (a.num_items > 0) {
    auto kernel = relgat_fwd_ring_kernel<NK, VW, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<a.num_items * groups, 32 * (gh + 1), smem, a.st>>>(
        h, a.attn, a.rel_bias, a.items, a.src, a.etype, a.eid, a.out, a.m_out,
        a.l_out, a.bias_out, a.part_acc, a.part_ml, a.part_bias, groups, gh,
        a.heads, a.feat, a.num_rel, stages, elems, a.slope, a.eps,
        a.use_dropout, a.seed, a.thr, a.keep_prob);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_merge<VEC, NV>(a);
}

// items [I, 4] and merge [S, 3] are data/csr.py's work plan; part_acc,
// part_ml and part_bias have a slot for each chunk of a split row.
// kernel: kKernelLanes, kKernelRing or (bf16 h) kKernelPair
// (relgat_common.cuh).
template <typename T>
int launch_fwd(const T* h, const float* attn, const float* rel_bias,
               const int* items, const int* src, const int* etype,
               const int* eid, const int* merge, float* out, float* m_out,
               float* l_out, float* bias_out, float* part_acc, float* part_ml,
               double* part_bias, int num_items, int num_split,
               int item_edges, int heads, int feat, int num_rel, float slope,
               float eps, int use_dropout, int seed, unsigned int thr,
               float keep_prob, int kernel, void* stream) {
  using namespace relgat;
  if (item_edges > kItemEdges || !aligned(items, 16) || heads < 1 ||
      feat > 32 * kMaxFeatPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{attn, rel_bias, reinterpret_cast<const int4*>(items), src,
                  etype, eid, merge, out, m_out, l_out, bias_out, part_acc,
                  reinterpret_cast<float2*>(part_ml), part_bias, num_items,
                  num_split, heads, feat, num_rel, slope, eps, use_dropout,
                  static_cast<uint32_t>(seed), thr, keep_prob,
                  static_cast<cudaStream_t>(stream)};
  // 4 values a vector: 16 bytes of an fp32 row, 8 of a bf16 one
  const bool vec4 = feat % 4 == 0 && aligned(h, 4 * sizeof(T)) &&
                    aligned(attn, 16) && aligned(out, 16) &&
                    aligned(part_acc, 16);
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == kKernelPair) {
    if (!std::is_same_v<T, __nv_bfloat16> || !vec4 || feat % 8 != 0 ||
        feat > 128 || !aligned(h, 16))
      return static_cast<int>(cudaErrorInvalidValue);
    if (num_items > 0) {
      // two heads a warp: up to 16 heads a block
      const int pairs = (heads + 1) / 2;
      const int wpb2 = pairs < kFwdWarps ? pairs : kFwdWarps;
      const int groups2 = (pairs + wpb2 - 1) / wpb2;
      relgat_fwd_pair_kernel<<<num_items * groups2, 32 * wpb2, 0, a.st>>>(
          reinterpret_cast<const __nv_bfloat16*>(h), attn, rel_bias, a.items,
          src, etype, eid, out, m_out, l_out, bias_out, part_acc, a.part_ml,
          part_bias, groups2, heads, feat, num_rel, slope, eps, use_dropout,
          a.seed, thr, keep_prob);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = launch_merge<4, 1>(a);
  } else if (kernel == kKernelRing) {
    if (feat <= 128) return static_cast<int>(cudaErrorInvalidValue);
    // two values a read where every head's piece of a row is 2-value aligned
    const bool pairs = feat % 2 == 0 && aligned(h, 2 * sizeof(T)) &&
                       aligned(attn, 8) && aligned(out, 8) &&
                       aligned(part_acc, 8);
    if (vec4 && feat <= 256) err = launch_ring<8, 2, 4, 2>(h, a);
    else if (vec4 && feat <= 320) err = launch_ring<10, 2, 4, 4>(h, a);
    else if (vec4 && feat <= 512) err = launch_ring<16, 2, 4, 4>(h, a);
    else if (vec4) err = launch_ring<32, 2, 4, 8>(h, a);
    else if (pairs && feat <= 256) err = launch_ring<8, 2, 1, 8>(h, a);
    else if (pairs && feat <= 320) err = launch_ring<10, 2, 1, 16>(h, a);
    else if (pairs && feat <= 512) err = launch_ring<16, 2, 1, 16>(h, a);
    else if (pairs) err = launch_ring<32, 2, 1, 32>(h, a);
    else if (feat <= 256) err = launch_ring<8, 1, 1, 8>(h, a);
    else if (feat <= 320) err = launch_ring<10, 1, 1, 16>(h, a);
    else if (feat <= 512) err = launch_ring<16, 1, 1, 16>(h, a);
    else err = launch_ring<32, 1, 1, 32>(h, a);
  } else if (kernel == kKernelLanes) {
    if (vec4 && feat <= 128) err = launch_lanes<4, 1>(h, a);
    else if (vec4 && feat <= 256) err = launch_lanes<4, 2>(h, a);
    else if (vec4 && feat <= 512) err = launch_lanes<4, 4>(h, a);
    else if (vec4) err = launch_lanes<4, 8>(h, a);
    else if (feat <= 32) err = launch_lanes<1, 1>(h, a);
    else if (feat <= 64) err = launch_lanes<1, 2>(h, a);
    else if (feat <= 128) err = launch_lanes<1, 4>(h, a);
    else if (feat <= 256) err = launch_lanes<1, 8>(h, a);
    else if (feat <= 512) err = launch_lanes<1, 16>(h, a);
    else err = launch_lanes<1, 32>(h, a);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int relgat_fwd(const float* h, const float* attn,
                          const float* rel_bias, const int* items,
                          const int* src, const int* etype, const int* eid,
                          const int* merge, float* out, float* m_out,
                          float* l_out, float* bias_out, float* part_acc,
                          float* part_ml, double* part_bias, int num_items,
                          int num_split,
                          int item_edges, int heads, int feat, int num_rel,
                          float slope, float eps, int use_dropout, int seed,
                          unsigned int thr, float keep_prob,
                          int kernel, void* stream) {
  return launch_fwd(h, attn, rel_bias, items, src, etype, eid, merge, out,
                    m_out, l_out, bias_out, part_acc, part_ml, part_bias,
                    num_items, num_split, item_edges, heads, feat, num_rel,
                    slope, eps, use_dropout, seed, thr, keep_prob,
                    kernel, stream);
}

// The same with h in bf16 (kernel_precision="default").
extern "C" int relgat_fwd_bf16(const __nv_bfloat16* h, const float* attn,
                               const float* rel_bias, const int* items,
                               const int* src, const int* etype,
                               const int* eid, const int* merge, float* out,
                               float* m_out, float* l_out, float* bias_out,
                               float* part_acc,
                               float* part_ml, double* part_bias,
                               int num_items, int num_split, int item_edges,
                               int heads, int feat, int num_rel, float slope,
                               float eps, int use_dropout, int seed,
                               unsigned int thr, float keep_prob,
                               int kernel, void* stream) {
  return launch_fwd(h, attn, rel_bias, items, src, etype, eid, merge, out,
                    m_out, l_out, bias_out, part_acc, part_ml, part_bias,
                    num_items, num_split, item_edges, heads, feat, num_rel,
                    slope, eps, use_dropout, seed, thr, keep_prob,
                    kernel, stream);
}
