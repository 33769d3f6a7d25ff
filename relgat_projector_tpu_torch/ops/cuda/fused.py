"""Wrappers of the Hopper propagate kernels, each beside its plain version.

Port of ``relgat_projector_tpu/ops/pallas/fused.py``:

- ``relgat_fwd`` (``csrc/relgat_fwd.cu``) replaces ``_fused_kernel``. It
  walks the work items of ``CSRGraph.fwd_items`` (a row of at most
  ``FWD_ITEM_EDGES`` in-edges, or one such chunk of a longer row); the
  chunks of a split row leave partials in scratch, which a second kernel
  merges in a fixed order (``relgat_fwd_split_plain`` is that route in
  plain PyTorch);
- ``relgat_bwd_src`` and ``relgat_bwd_rel`` (``csrc/relgat_bwd.cu``) together
  replace ``_bwd_src_kernel``. The first computes dh in src order and folds
  each edge's logit gradient ``de`` per (src row, relation) into ``W``, and
  ``gsum[dst]`` into ``B``, over the work items of ``CSRGraph.bwd_items``
  (a source row of at most ``bwd_item_edges`` out-edges, or one such chunk
  of a longer row, whose partial dh, W and B rows a merge kernel adds in
  chunk order; ``relgat_bwd_src_split_plain`` is that route in plain
  PyTorch); the second reduces ``dattn = W^T h`` per head and
  ``dbias = sum_s B[s]`` over the node rows, reading h and W once (the TPU
  kernel sums dattn and dbias across its sequential grid, which this card
  does not have). On bf16 rows the ring design of the src pass takes each
  edge's attn terms by (source row, head, relation): a kernel first writes
  the logits ``P = h attn^T`` ``[N_src, H, R]`` into W's buffer, the ring's
  loop reads each edge's logit from it and sums ``alpha * keep * g`` into
  dh, and after the merge a last kernel adds ``W attn`` into dh
  (``relgat_bwd_src_factored_plain`` is that route in plain PyTorch, for
  the tests); no attn row is loaded an edge and no array is added.

``kernel_of`` picks the kernel of every launch; the C entry points launch
it or refuse it, and choose none. A forward or src pass takes the bf16
pair kernel (two heads a warp) up to 128 features, and past them, by width
and head count (``design_of``), the ring kernel (a producer warp streams
each edge's row slice into shared memory with bulk copies, a consumer warp
a head) or the one-warp-a-head template, which takes every other call;
the bf16 src pass's ring has a factored and a per-edge loop, by density
(``ring_src_loop``). ``relgat_bwd_rel_bf16`` takes ``"mma"``, the tensor
cores (fp32 W split exactly into three bf16 pieces, ``split_bf16x3``),
or ``"tile"``, the SIMT kernel that ``relgat_bwd_rel`` runs.
``with_design`` forces a kernel by name, to time each and hold it to the
plain version.

Each has a bf16 variant (``relgat_fwd_bf16``, ``relgat_bwd_src_bf16``,
``relgat_bwd_rel_bf16``) for ``kernel_precision="default"``, the TPU
kernels' bf16 streams: it reads ``h`` (and ``g``) as bfloat16 rows and does
everything else as its fp32 twin does, in fp32. Its plain version widens
those rows and runs the fp32 plain version.

A wrapper given CPU tensors computes its plain PyTorch version (the
``*_plain`` function beside it); given CUDA tensors it launches its kernel
or raises: a CUDA tensor of another type than the kernel reads is refused,
never converted. The plain versions are the reference the kernels are held
to on the card; nothing on the card's main path calls them. Each wrapper
counts its launches in a plain int attribute, ``<wrapper>.launches``, where
its kernel launches: a call that launches nothing (a src pass over no
source rows) counts nothing. Beside it, ``<wrapper>.designs`` counts the
kernels each call launches by design, as ``kernel_of`` picked them:
``"pair"``, ``"lanes"`` or ``"ring"`` (either loop) over the work items of
a forward or src pass, then ``"merge"`` where rows were split; ``"mma"`` or
``"tile"`` for the relation reduction, then its ``"reduce"``.
``design_counts()`` reads them and ``reset_design_counts()`` zeroes them,
and with them ``relgat_bwd_src_bf16.ring_loops``, its ring launches by
loop (``"factored"``, ``"per_edge"``), which ``ring_loop_counts()`` reads.

Shapes, over the layout's ``N_src = csr.num_src`` source rows and
``N = csr.num_nodes`` destination rows (both the padded node count on one
device; a halo shard's subsets read their own source spaces,
``parallel/halo.py``): ``h``/``dh`` are ``[N_src, H*F]`` and ``g``/``out``
``[N, H*F]``, fp32 (``h``/``g`` bf16 in the bf16 variants);
``attn``/``dattn`` ``[H, R, F]``; the statistics ``m``, ``l`` (un-dropped
softmax sum) and ``s_dot`` (``<out - bias, g>``) ``[N, H]``; ``gsum``
(``sum_{h,f} g``) ``[N]``; ``W`` ``[N_src, H, R]`` and ``B`` ``[N_src, R]``.
A destination row without in-edges comes out with ``m = -inf``, ``l = 0``
and ``out = 0``. Attention dropout hashes each edge's canonical id,
``csr.eid``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.data.csr import FWD_ITEM_EDGES, CSRGraph
from relgat_projector_tpu_torch.ops.cuda.build import entry_point
from relgat_projector_tpu_torch.ops.dropout import (
    edge_keep_mask_all_heads,
    keep_threshold,
)
from relgat_projector_tpu_torch.ops.segment import segment_max

MAX_FEAT = 1024  # csrc/relgat_common.cuh kMaxFeatPerLane * 32
# FWD_ITEM_EDGES (data/csr.py) is csrc/relgat_fwd.cu kItemEdges.
MAX_WARPS_PER_BLOCK = 8  # csrc/relgat_common.cuh kMaxWarpsPerBlock
MAX_BWD_SMEM_BYTES = 48 * 1024  # csrc/relgat_bwd.cu kMaxBwdSmemBytes
EDGE_TABLE_BYTES = 32 * 32  # csrc/relgat_bwd.cu 32 EdgeEntry a warp
REL_TILE_ROWS = 512  # csrc/relgat_bwd.cu kRelTileRows
# The mma design of relgat_bwd_rel_bf16 sums runs of at least
# REL_MMA_MIN_ROWS node rows a block, each leaving one partial [H, R, F]
# and up to REL_MMA_BIAS_SLICES partials of dbias (csrc/relgat_bwd.cu
# kMmaBiasSlices); the kernel picks how many runs by the card's SM count
# and its own occupancy.
REL_MMA_MIN_ROWS = 512
REL_MMA_BIAS_SLICES = 16


def _atomic_sum(data, segment_ids, num_segments):
    """The plain versions' segment sum: ``index_add_``, whose atomics add in
    any order on the card. The plain versions are held in float64, and
    their time is the kernels' plain ms, so they keep the sum those times
    were measured with; the model's plain route takes
    ``ops.segment.segment_sum``, which is ordered."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def _dropout_args(seed: Optional[int], rate: float):
    """(use, seed, threshold, keep probability) for the C entry points."""
    if rate > 0.0 and seed is not None:
        if not -(2**31) <= int(seed) < 2**31:
            raise ValueError(f"dropout seed {seed} is not an int32")
        return 1, int(seed), keep_threshold(rate), 1.0 - float(rate)
    return 0, 0, 0, 1.0


def _keep_scale(eid, heads, seed, rate) -> Optional[torch.Tensor]:
    """The dropout keep / (1 - rate) of edges ``eid`` [E, H], or None."""
    if not (rate > 0.0 and seed is not None):
        return None
    return edge_keep_mask_all_heads(eid, heads, seed, rate) / (1.0 - rate)


def _on_card(
    name: str, csr: Optional[CSRGraph], *tensors: torch.Tensor,
    bf16_rows: int = 0,
) -> bool:
    """True for CUDA inputs (after checking them), False for CPU ones. The
    first ``bf16_rows`` tensors are a bf16 variant's rows (h, g) and must
    be bfloat16; every other floating-point input float32."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    layout = (csr.dst_ptr,) if csr is not None else ()
    for t in tensors + layout:
        if t.device != dev:
            raise ValueError(f"{name}: inputs lie on {t.device} and {dev}")
    for i, t in enumerate(tensors):
        if not t.is_floating_point():
            continue
        want = torch.bfloat16 if i < bf16_rows else torch.float32
        if t.dtype != want:
            raise NotImplementedError(
                f"{name}: a {t.dtype} input where the kernel reads {want} "
                "(float32, or bfloat16 h and g with "
                "kernel_precision='default')"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _f32(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def check_shapes(name, h, attn, csr):
    """The shape gate of the kernels: ``(N_src, H, R, F)`` of
    ``h [N_src, H*F]`` and ``attn [H, R, F]`` over ``csr``, or a ValueError
    naming what the kernels do not take. The plain versions take any
    width."""
    n, hf = h.shape
    heads, num_rel, f = attn.shape
    if hf != heads * f or n != csr.num_src:
        raise ValueError(
            f"{name}: h is {tuple(h.shape)}, expected [{csr.num_src}, "
            f"{heads * f}]"
        )
    if f > MAX_FEAT:
        raise ValueError(
            f"{name}: {f} features per head exceed the kernels' limit of "
            f"{MAX_FEAT}: a lane holds F / 32 of its head's features in "
            f"registers, at most 32 (csrc/relgat_common.cuh kMaxFeatPerLane)"
        )
    if csr.num_rel > num_rel:
        raise ValueError(
            f"{name}: the graph has relations up to {csr.num_rel - 1}, "
            f"attn only {num_rel}"
        )
    return n, heads, num_rel, f


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _count(wrapper, *kernels: str) -> None:
    """Count a call's launches: one of ``wrapper``, and one a kernel by its
    design (``kernels``, as ``kernel_of`` names them, in launch order)."""
    wrapper.launches += 1
    loops = getattr(wrapper, "ring_loops", None)
    for k in kernels:
        if loops is not None and k in RING_LOOPS:
            loops[RING_LOOPS[k]] = loops.get(RING_LOOPS[k], 0) + 1
        d = "ring" if k in RING_LOOPS else k
        wrapper.designs[d] = wrapper.designs.get(d, 0) + 1


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` of two ``[E, H, F]`` arrays, as batched dot
    products that make no ``[E, H, F]`` temporary."""
    return torch.einsum("ehf,ehf->eh", a, b)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def relgat_fwd_plain(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_fwd``: ``(out, m, l, bias)``."""
    n_src, hf = h.shape
    n = csr.num_nodes
    heads, _, f = attn.shape
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    hs = h.view(n_src, heads, f)[src]                            # [E, H, F]
    e = F.leaky_relu(_dots(hs, attn[:, et].transpose(0, 1)),
                     negative_slope)                             # [E, H]
    m = segment_max(e, dst, n)
    p = torch.exp(e - torch.where(torch.isfinite(m), m, 0.0)[dst])
    l = _atomic_sum(p, dst, n)
    keep = _keep_scale(csr.eid, heads, seed, rate)
    if keep is not None:
        p = p * keep
    acc = _atomic_sum(hs * p[..., None], dst, n)
    bias = _atomic_sum(rel_bias[et], dst, n)
    out = acc / l.clamp_min(eps)[..., None] + bias[:, None, None]
    return out.reshape(n, hf), m, l, bias


def relgat_fwd_split_plain(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relgat_fwd_plain`` by the kernels' route: a partial ``(m_c, l_c,
    acc_c, bias_c)`` per work item of ``csr.fwd_items``, then each row's
    items merged, ``m = max m_c``, ``l = sum l_c e^(m_c - m)``, ``acc`` alike
    and the bias summed. The tests hold it to ``relgat_fwd_plain``."""
    n_src, hf = h.shape
    n = csr.num_nodes
    heads, _, f = attn.shape
    items = csr.fwd_items.long()
    row = items[:, 0]
    num_items = items.shape[0]
    item = torch.repeat_interleave(
        torch.arange(num_items, device=h.device), items[:, 2] - items[:, 1])
    src, et = csr.src.long(), csr.etype.long()
    hs = h.view(n_src, heads, f)[src]                            # [E, H, F]
    e = F.leaky_relu(_dots(hs, attn[:, et].transpose(0, 1)),
                     negative_slope)                             # [E, H]
    m_c = segment_max(e, item, num_items)                        # [I, H]
    p = torch.exp(e - m_c[item])
    l_c = _atomic_sum(p, item, num_items)
    keep = _keep_scale(csr.eid, heads, seed, rate)
    if keep is not None:
        p = p * keep
    acc_c = _atomic_sum(hs * p[..., None], item, num_items)
    bias_c = _atomic_sum(rel_bias[et], item, num_items)
    m = segment_max(m_c, row, n)
    # only the one item of a row without in-edges has m_c = -inf
    w = torch.exp(m_c - torch.where(torch.isfinite(m), m, 0.0)[row])
    l = _atomic_sum(l_c * w, row, n)
    acc = _atomic_sum(acc_c * w[..., None], row, n)
    bias = _atomic_sum(bias_c, row, n)
    out = acc / l.clamp_min(eps)[..., None] + bias[:, None, None]
    return out.reshape(n, hf), m, l, bias


def relgat_fwd_bf16_plain(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
):
    """Plain version of ``relgat_fwd_bf16``: ``h``'s bf16 values widened
    to ``attn``'s type, then ``relgat_fwd_plain``."""
    return relgat_fwd_plain(
        h.to(attn.dtype), attn, rel_bias, csr, seed=seed, rate=rate,
        negative_slope=negative_slope, eps=eps,
    )


def _launch_fwd(
    wrapper, h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope,
    eps, forced=None,
):
    """Launch the kernel ``kernel_of`` picks and count the launch (a kernel
    ``forced``: see ``with_design``, counted nowhere)."""
    name = wrapper.__name__
    _, heads, num_rel, f = check_shapes(name, h, attn, csr)
    if csr.fwd_item_edges > FWD_ITEM_EDGES:
        raise ValueError(
            f"{name}: work items of {csr.fwd_item_edges} edges exceed "
            f"the kernel's edge table of {FWD_ITEM_EDGES}"
        )
    n = csr.num_nodes
    out = _f32(h, (n, heads * f))
    m = _f32(h, (n, heads))
    l = _f32(h, (n, heads))
    bias = _f32(h, (n,))
    parts = csr.fwd_num_parts
    part_acc = _f32(h, (parts, heads, f))
    part_ml = _f32(h, (parts, heads, 2))
    part_bias = h.new_empty((parts,), dtype=torch.float64)
    use, s, thr, keep = _dropout_args(seed, rate)
    kernel = forced or kernel_of(wrapper, heads, f,
                                 aligned=_aligned(h, attn, out, part_acc))
    rc = entry_point(name)(
        h.data_ptr(), attn.data_ptr(), rel_bias.data_ptr(),
        csr.fwd_items.data_ptr(), csr.src.data_ptr(), csr.etype.data_ptr(),
        csr.eid.data_ptr(), csr.fwd_merge.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), bias.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), part_bias.data_ptr(), csr.fwd_num_items,
        csr.fwd_num_split, csr.fwd_item_edges, heads, f, num_rel,
        float(negative_slope), float(eps), use, s, thr, keep,
        ITEM_KERNELS[kernel], _stream(),
    )
    _raise_on(rc, name)
    if not forced:
        _count(wrapper, *((kernel,) if csr.fwd_num_items > 0 else ()),
               *(("merge",) if csr.fwd_num_split > 0 else ()))
    return out, m, l, bias


def relgat_fwd(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
):
    """Aggregate every destination row's in-edges: ``out [N, H*F]`` (rows
    without in-edges are 0) and the saved statistics ``m, l [N, H]``,
    ``bias [N]``."""
    kw = dict(seed=seed, rate=rate, negative_slope=negative_slope, eps=eps)
    if not _on_card("relgat_fwd", csr, h, attn, rel_bias):
        return relgat_fwd_plain(h, attn, rel_bias, csr, **kw)
    return _launch_fwd(relgat_fwd, h, attn, rel_bias, csr, **kw)


def relgat_fwd_bf16(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
):
    """``relgat_fwd`` reading ``h`` as bf16 rows; fp32 outputs."""
    kw = dict(seed=seed, rate=rate, negative_slope=negative_slope, eps=eps)
    if not _on_card("relgat_fwd_bf16", csr, h, attn, rel_bias, bf16_rows=1):
        return relgat_fwd_bf16_plain(h, attn, rel_bias, csr, **kw)
    return _launch_fwd(relgat_fwd_bf16, h, attn, rel_bias, csr, **kw)


relgat_fwd.launches = relgat_fwd_bf16.launches = 0
relgat_fwd.designs, relgat_fwd_bf16.designs = {}, {}


# ---------------------------------------------------------------------------
# Backward: dh, and de folded per (src row, relation), in src order
# ---------------------------------------------------------------------------

def max_num_rel(heads: int) -> int:
    """Most relations ``relgat_bwd_src`` takes at ``heads`` heads: a block
    of up to 8 warps holds a 1 KB edge table per warp, one slab of R floats
    per warp and one more, in 48 KB of shared memory (1137 at 16 heads)."""
    warps = min(int(heads), MAX_WARPS_PER_BLOCK)
    return ((MAX_BWD_SMEM_BYTES - EDGE_TABLE_BYTES * warps)
            // (4 * (warps + 1)))


def _alpha_de(eraw, dalpha, m, l, s_dot, dst, keep, *, negative_slope,
              eps):
    """``alpha * keep`` and the logit gradient ``de`` [E, H] of edges into
    ``dst`` from their logits ``eraw`` and ``dalpha = <h[src], g[dst]>``
    (``keep`` [E, H] or None)."""
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    alpha = torch.exp(
        F.leaky_relu(eraw, negative_slope) - m_safe[dst]
    ) / l.clamp_min(eps)[dst]
    k = keep if keep is not None else 1.0
    de = alpha * (dalpha * k - s_dot[dst])
    de = de * torch.where(eraw >= 0, 1.0, negative_slope)
    return alpha * k, de


def _src_terms(h, g, attn, m, l, s_dot, src, dst, et, keep, *,
               negative_slope, eps):
    """Per edge of ``(src, dst, et)``: ``alpha * keep`` and the logit
    gradient ``de`` [E, H], with the rows ``g[dst]`` and ``attn[et]``
    [E, H, F] they multiply (``keep`` [E, H] or None)."""
    heads, _, f = attn.shape
    hs = h.view(-1, heads, f)[src]
    gd = g.view(-1, heads, f)[dst]
    ar = attn[:, et].transpose(0, 1)
    eraw = _dots(hs, ar)
    dalpha = _dots(hs, gd)
    del hs  # [E, H, F] arrays are 14 GB each at 1M edges and H*F = 3600
    aw, de = _alpha_de(eraw, dalpha, m, l, s_dot, dst, keep,
                       negative_slope=negative_slope, eps=eps)
    return aw, de, gd, ar


def relgat_bwd_src_plain(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_src``: ``(dh [N_src, H*F],
    W [N_src, H, R], B [N_src, R])``, W and B as segment sums over the key
    ``src * R + etype``."""
    n, hf = h.shape
    heads, num_rel, _ = attn.shape
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    aw, de, gd, ar = _src_terms(
        h, g, attn, m, l, s_dot, src, dst, et,
        _keep_scale(csr.eid, heads, seed, rate),
        negative_slope=negative_slope, eps=eps)
    dh = _atomic_sum(aw[..., None] * gd, src, n)
    dh += _atomic_sum(de[..., None] * ar, src, n)
    dh = dh.reshape(n, hf)
    key = src * num_rel + et
    w = _atomic_sum(de, key, n * num_rel).view(n, num_rel, heads)
    b = _atomic_sum(gsum[dst], key, n * num_rel).view(n, num_rel)
    return dh, w.transpose(1, 2).contiguous(), b


def _split_src(h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
               negative_slope, eps, factored):
    """The src pass by the kernels' route: partial dh, W and B rows per
    work item of ``csr.bwd_items`` over the src-CSR, then each source row's
    items added. ``factored``: each edge's logit gathered from ``P = h
    attn^T`` by (src row, relation), the partial dh rows ``alpha * keep *
    g`` alone, and ``W attn`` added into dh after the merge."""
    n, hf = h.shape
    heads, num_rel, f = attn.shape
    items = csr.bwd_items.long()
    num_items = items.shape[0]
    item = torch.repeat_interleave(
        torch.arange(num_items, device=h.device), items[:, 2] - items[:, 1])
    src = items[item, 0]
    dst, et = csr.by_src_dst.long(), csr.by_src_etype.long()
    keep = _keep_scale(csr.by_src_eid, heads, seed, rate)
    kw = dict(negative_slope=negative_slope, eps=eps)
    if factored:
        hv = h.view(n, heads, f)
        logits = torch.einsum("nhf,hrf->nhr", hv, attn)[src, :, et]
        gd = g.view(-1, heads, f)[dst]
        aw, de = _alpha_de(logits, _dots(hv[src], gd), m, l, s_dot, dst,
                           keep, **kw)
    else:
        aw, de, gd, ar = _src_terms(h, g, attn, m, l, s_dot, src, dst, et,
                                    keep, **kw)
    dh_c = _atomic_sum(aw[..., None] * gd, item, num_items)
    if not factored:
        dh_c += _atomic_sum(de[..., None] * ar, item, num_items)
    key = item * num_rel + et
    w_c = _atomic_sum(de, key, num_items * num_rel).view(
        num_items, num_rel, heads)
    b_c = _atomic_sum(gsum[dst], key, num_items * num_rel).view(
        num_items, num_rel)
    row = items[:, 0]
    dh = _atomic_sum(dh_c, row, n)
    w = _atomic_sum(w_c, row, n)
    if factored:
        dh = dh + torch.einsum("nrh,hrf->nhf", w, attn)
    return (dh.reshape(n, hf), w.transpose(1, 2).contiguous(),
            _atomic_sum(b_c, row, n))


def relgat_bwd_src_split_plain(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relgat_bwd_src_plain`` by the kernels' route: partial dh, W and B
    rows per work item of ``csr.bwd_items`` over the src-CSR, then each
    source row's items added. The tests hold it to
    ``relgat_bwd_src_plain``."""
    return _split_src(h, g, attn, m, l, s_dot, gsum, csr, seed=seed,
                      rate=rate, negative_slope=negative_slope, eps=eps,
                      factored=False)


def relgat_bwd_src_factored_plain(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``relgat_bwd_src_split_plain`` by the bf16 ring's factored route,
    for the tests: the logits from ``P = h attn^T`` ``[N_src, H, R]``
    gathered by (src row, relation), W from ``de``, then ``dh = sum aw g +
    W attn``. The tests hold it to ``relgat_bwd_src_plain``."""
    return _split_src(h, g, attn, m, l, s_dot, gsum, csr, seed=seed,
                      rate=rate, negative_slope=negative_slope, eps=eps,
                      factored=True)


def relgat_bwd_src_bf16_plain(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_src_bf16``: the bf16 values of ``h``
    and ``g`` widened to ``attn``'s type, then ``relgat_bwd_src_plain``."""
    return relgat_bwd_src_plain(
        h.to(attn.dtype), g.to(attn.dtype), attn, m, l, s_dot, gsum, csr,
        seed=seed, rate=rate, negative_slope=negative_slope, eps=eps,
    )


def _launch_bwd_src(
    wrapper, h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps, forced=None,
):
    """Launch the kernel ``kernel_of`` picks and count the launch; a layout
    without source rows (an empty halo buffer) launches nothing and counts
    nothing (a kernel ``forced``: see ``with_design``, counted nowhere)."""
    name = wrapper.__name__
    n, heads, num_rel, f = check_shapes(name, h, attn, csr)
    nd = csr.num_nodes
    if (g.shape != (nd, heads * f) or gsum.shape != (nd,)
            or not (m.shape == l.shape == s_dot.shape == (nd, heads))):
        raise ValueError(f"{name}: g or statistics have wrong shapes")
    if num_rel > max_num_rel(heads):
        raise ValueError(
            f"{name}: {num_rel} relations exceed the limit of "
            f"{max_num_rel(heads)} at {heads} heads (edge tables and one "
            f"slab of R floats per warp, and one more, in "
            f"{MAX_BWD_SMEM_BYTES} bytes of shared memory)"
        )
    # after the n source rows, one partial row a chunk of a split row (slot
    # k: row n + k), which the merge adds into its source row
    rows = n + csr.bwd_num_parts
    dh = _f32(h, (rows, heads * f))
    w = _f32(h, (rows, heads, num_rel))
    b = _f32(h, (rows, num_rel))
    if n == 0:  # no source row: a grid of no blocks is not a launch
        return dh, w, b
    use, s, thr, keep = _dropout_args(seed, rate)
    kernel = forced or kernel_of(wrapper, heads, f, num_rel,
                                 aligned=_aligned(h, g, attn, dh),
                                 num_edges=csr.num_edges, num_src=n)
    rc = entry_point(name)(
        h.data_ptr(), g.data_ptr(), attn.data_ptr(), m.data_ptr(),
        l.data_ptr(), s_dot.data_ptr(), gsum.data_ptr(),
        csr.bwd_items.data_ptr(), csr.bwd_merge.data_ptr(),
        csr.by_src_dst.data_ptr(), csr.by_src_etype.data_ptr(),
        csr.by_src_eid.data_ptr(), dh.data_ptr(), w.data_ptr(), b.data_ptr(),
        n, csr.bwd_num_items, csr.bwd_num_split, heads, f, num_rel,
        float(negative_slope), float(eps), use, s, thr, keep,
        ITEM_KERNELS[kernel], _stream(),
    )
    _raise_on(rc, name)
    if not forced:
        _count(wrapper, *((kernel,) if csr.bwd_num_items > 0 else ()),
               *(("merge",) if csr.bwd_num_split > 0 else ()))
    return dh[:n], w[:n], b[:n]


def relgat_bwd_src(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
):
    """Gradient wrt ``h`` and the per-(src row, relation) sums ``W`` of the
    logit gradient and ``B`` of ``gsum[dst]``, every source row written;
    on the card over ``csr``'s src-pass work plan, the split rows' chunks
    merged in order (one launch counted)."""
    args = (h, g, attn, m, l, s_dot, gsum, csr)
    kw = dict(seed=seed, rate=rate, negative_slope=negative_slope, eps=eps)
    if not _on_card("relgat_bwd_src", csr, *args[:-1]):
        return relgat_bwd_src_plain(*args, **kw)
    return _launch_bwd_src(relgat_bwd_src, *args, **kw)


def relgat_bwd_src_bf16(
    h, g, attn, m, l, s_dot, gsum, csr: CSRGraph, *, seed, rate,
    negative_slope, eps,
):
    """``relgat_bwd_src`` reading ``h`` and ``g`` as bf16 rows; the
    statistics and every output fp32."""
    args = (h, g, attn, m, l, s_dot, gsum, csr)
    kw = dict(seed=seed, rate=rate, negative_slope=negative_slope, eps=eps)
    if not _on_card("relgat_bwd_src_bf16", csr, *args[:-1], bf16_rows=2):
        return relgat_bwd_src_bf16_plain(*args, **kw)
    return _launch_bwd_src(relgat_bwd_src_bf16, *args, **kw)


relgat_bwd_src.launches = relgat_bwd_src_bf16.launches = 0
relgat_bwd_src.designs, relgat_bwd_src_bf16.designs = {}, {}
relgat_bwd_src_bf16.ring_loops = {}


# ---------------------------------------------------------------------------
# Backward: dattn and dbias, a streaming reduction over node rows
# ---------------------------------------------------------------------------

def relgat_bwd_rel_plain(h, w, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_rel``: ``(dattn [H, R, F], dbias [R])``."""
    n, heads, _ = w.shape
    dattn = torch.einsum("nhr,nhf->hrf", w,
                         h.view(n, heads, h.shape[1] // heads))
    return dattn, b.sum(0)


def relgat_bwd_rel_bf16_plain(h, w, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_rel_bf16``: ``h``'s bf16 values
    widened to ``W``'s type, then ``relgat_bwd_rel_plain``."""
    return relgat_bwd_rel_plain(h.to(w.dtype), w, b)


def split_bf16x3(w: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mma design's split of fp32 ``w`` into three bf16 pieces, as the
    kernel makes it (``csrc/relgat_bwd.cu`` ``split_bf16x3``): ``hi`` is
    ``w`` truncated to bf16 (its low 16 bits cleared), ``mid`` the
    remainder ``w - hi`` truncated, ``lo = w - hi - mid``. Each subtraction
    is exact, so ``hi + mid + lo == w`` for every finite ``w`` with
    ``|w| >= 2**-110`` or 0, and truncation keeps ``|w|`` up to FLT_MAX
    finite. A non-finite ``w`` gives ``hi = w`` (NaN as bf16's NaN) and
    ``mid = lo = 0``. The kernel's products ``piece x h`` are exact in
    fp32; this function lets the CPU tests hold the split to that."""
    if w.dtype != torch.float32:
        raise ValueError(f"split_bf16x3: W is {w.dtype}, not float32")
    mask = torch.tensor(-65536, dtype=torch.int32)  # 0xffff0000

    def trunc(x):
        return (x.view(torch.int32) & mask).view(torch.float32)

    finite = torch.isfinite(w)
    hi = trunc(w)
    r = torch.where(finite, w - hi, 0.0)
    mid = trunc(r)
    lo = trunc(r - mid)
    hi = torch.where(torch.isnan(w), w, hi)  # truncation may make NaN inf
    return tuple(x.to(torch.bfloat16) for x in (hi, mid, lo))


def rel_tiles(design: str, n: int) -> int:
    """Runs of node rows ``relgat_bwd_rel``'s kernels sum apart, one
    partial ``[H, R, F]`` each, summed in run order after; 0 at ``n = 0``.
    ``"tile"``: ``ceil(n / REL_TILE_ROWS)``. ``"mma"``: the most runs the
    kernel may take, ``ceil(n / REL_MMA_MIN_ROWS)``; it takes as many of
    them as fill whole waves of its blocks on the card best, two waves or
    more (``csrc/relgat_bwd.cu`` ``rel_mma_runs``)."""
    return -(-n // (REL_TILE_ROWS if design == "tile" else REL_MMA_MIN_ROWS))


def _launch_bwd_rel(wrapper, h, w, b, forced=None):
    """Launch the kernel ``kernel_of`` picks and count the launch (a kernel
    ``forced``: see ``with_design``, counted nowhere)."""
    name = wrapper.__name__
    n, hf = h.shape
    _, heads, num_rel = w.shape
    f = hf // heads
    if w.shape[0] != n or heads * f != hf or b.shape != (n, num_rel):
        raise ValueError(
            f"{name}: h {tuple(h.shape)}, W {tuple(w.shape)} and "
            f"B {tuple(b.shape)} do not match"
        )
    kernel = forced or kernel_of(wrapper, heads, f)
    tiles = rel_tiles(kernel, n)
    bias_parts = tiles * (REL_MMA_BIAS_SLICES if kernel == "mma" else 1)
    part_attn = _f32(h, (tiles, heads, num_rel, f))
    part_bias = _f32(h, (bias_parts, num_rel))
    dattn = _f32(h, (heads, num_rel, f))
    dbias = _f32(h, (num_rel,))
    args = [h.data_ptr(), w.data_ptr(), b.data_ptr(), part_attn.data_ptr(),
            part_bias.data_ptr(), dattn.data_ptr(), dbias.data_ptr(),
            n, heads, f, num_rel, tiles]
    if wrapper is relgat_bwd_rel_bf16:
        args.append(REL_DESIGNS[kernel])
    rc = entry_point(name)(*args, _stream())
    _raise_on(rc, name)
    if not forced:
        _count(wrapper, *((kernel,) if tiles > 0 else ()), "reduce")
    return dattn, dbias


def relgat_bwd_rel(h, w, b):
    """``dattn[hd] = W[:, hd, :]^T h[:, hd, :]`` and ``dbias = sum_s B[s]``
    over the node rows, deterministic."""
    if not _on_card("relgat_bwd_rel", None, h, w, b):
        return relgat_bwd_rel_plain(h, w, b)
    return _launch_bwd_rel(relgat_bwd_rel, h, w, b)


def relgat_bwd_rel_bf16(h, w, b):
    """``relgat_bwd_rel`` reading ``h`` as bf16 rows; fp32 outputs. On the
    card the design of ``kernel_of``: the tensor cores (``"mma"``) or the
    SIMT tile kernel (``"tile"``)."""
    if not _on_card("relgat_bwd_rel_bf16", None, h, w, b, bf16_rows=1):
        return relgat_bwd_rel_bf16_plain(h, w, b)
    return _launch_bwd_rel(relgat_bwd_rel_bf16, h, w, b)


relgat_bwd_rel.launches = relgat_bwd_rel_bf16.launches = 0
relgat_bwd_rel.designs, relgat_bwd_rel_bf16.designs = {}, {}


# csrc/relgat_common.cuh kKernelLanes, kKernelRing, kKernelRingFactored,
# kKernelPair: the kernel a forward or src pass runs over its work items
ITEM_KERNELS = {"lanes": 1, "ring": 2, "ring_factored": 3, "pair": 4}
# csrc/relgat_bwd.cu kRelDesignTile, kRelDesignMma: relgat_bwd_rel_bf16
REL_DESIGNS = {"tile": 1, "mma": 2}
# The two rings, by the loop ring_loop_counts() counts them under
RING_LOOPS = {"ring": "per_edge", "ring_factored": "factored"}
# The designs with_design forces, by wrapper, and the kernel each names:
# "ring" the ring kernel (the bf16 src pass's: its factored loop, whatever
# the graph), "ring_per_edge" its per-edge loop, "lanes" the template
FORCED = {
    "relgat_fwd": {"lanes": "lanes", "ring": "ring"},
    "relgat_bwd_src": {"lanes": "lanes", "ring": "ring"},
    "relgat_fwd_bf16": {"lanes": "lanes", "ring": "ring", "pair": "pair"},
    "relgat_bwd_src_bf16": {"lanes": "lanes", "ring": "ring_factored",
                            "ring_per_edge": "ring", "pair": "pair"},
    "relgat_bwd_rel_bf16": {"tile": "tile", "mma": "mma"},
}


# Where each forward or src pass takes the ring kernel: ranges of
# (fewest features, most features, fewest heads) a head. They follow the
# card: on an H100 80GB HBM3 (700 W; wide_heads.py, PERF.md section 6) the
# ring was faster than the one-warp-a-head template across each range, at
# each measured width and at both ends; outside them the template was
# faster, or was not timed, and keeps the call. With fewer than 4 heads
# (a part-empty ring block) the fp32 passes and the wider bf16 src pass
# were slower or even.
RING_RANGES = {
    "relgat_fwd": ((129, 152, 4), (257, 448, 4)),
    "relgat_bwd_src": ((129, 216, 4), (248, 520, 4)),
    "relgat_fwd_bf16": ((257, 368, 1),),
    "relgat_bwd_src_bf16": ((129, 320, 1), (321, 480, 4), (513, 1024, 1)),
}


# Where the bf16 ring src pass takes its factored loop: the logits and the
# attn term of dh by (source row, head, relation). Its two products cost
# N_src * R a head and its fold a round trip of dh, whatever the edges;
# each edge and head saves an attn row. On an H100 80GB HBM3 (700 W;
# scripts/ring_src_times.py, PERF.md section 6) at 12 x 256 and 100,008
# source rows the loop saved ~0.8 ms a million edges, the logits cost 0.43
# / 0.98 ms and the fold 1.10 / 1.90 ms at R = 40 / 100: the two loops come
# even near E / N_src = 0.28 R + 8 out-edges a row, and the rule keeps the
# per-edge loop up to 0.28 R + 10. Measured on either side: the per-edge
# loop faster at E / (N_src R) = 0.25 (R = 40) and 0.2 (R = 100), even at
# 0.5 (R = 40), the factored loop faster at 1.0 (R = 40) and 0.5 and 1.0
# (R = 100).
FACTORED_MIN_DENSITY = 0.28
FACTORED_MIN_ROW_EDGES = 10.0


def ring_src_loop(num_edges: int, num_src: int, num_rel: int) -> str:
    """The bf16 ring src pass's loop on a graph of ``num_edges`` edges from
    ``num_src`` source rows over ``num_rel`` relations: ``"factored"`` where
    ``num_edges >= num_src * (FACTORED_MIN_DENSITY * num_rel +
    FACTORED_MIN_ROW_EDGES)``, else ``"per_edge"``."""
    need = num_src * (FACTORED_MIN_DENSITY * num_rel + FACTORED_MIN_ROW_EDGES)
    return "factored" if num_edges >= need else "per_edge"


# Where relgat_bwd_rel_bf16 takes the tensor cores ("mma"): ranges of
# (fewest features, most features, fewest heads) a head, at head widths
# that are a multiple of MMA_FEAT_MULTIPLE. On an H100 80GB HBM3 (700 W;
# rel_designs.py, PERF.md section 6, R = 40, two passes) the tensor cores
# took 0.30-0.80 of the tile kernel's time at each such width timed with 2
# to 20 heads, 32 to 1024 features; at 3 x 301 (h copied one value at a
# time) 1.13 of it, and at 1 x 128 (0.05-0.09 ms) 0.70 in one pass and
# 1.28 in the other. So other widths, one head, and widths under 32 (not
# timed) keep the tile kernel.
MMA_RANGES = ((32, 1024, 2),)
MMA_FEAT_MULTIPLE = 4


def _in_ranges(ranges, heads, feat) -> bool:
    return any(lo <= feat <= hi and heads >= fewest
               for lo, hi, fewest in ranges)


def design_of(wrapper, heads: int, feat: int) -> str:
    """The width part of ``kernel_of``: the design a wrapper takes at
    ``heads`` heads of ``feat`` features. A forward or src pass:
    ``"ring"``, the ring kernel, inside one of its ``RING_RANGES`` (all past
    128 features), else ``"lanes"``, the one-warp-a-head template.
    ``relgat_bwd_rel_bf16``: ``"mma"``, the tensor cores, inside
    ``MMA_RANGES`` at a multiple of ``MMA_FEAT_MULTIPLE`` features, else
    ``"tile"``."""
    if wrapper is relgat_bwd_rel_bf16:
        return ("mma" if feat % MMA_FEAT_MULTIPLE == 0
                and _in_ranges(MMA_RANGES, heads, feat) else "tile")
    return ("ring" if _in_ranges(RING_RANGES[wrapper.__name__], heads, feat)
            else "lanes")


def kernel_of(wrapper, heads: int, feat: int, num_rel: int = 0, *,
              aligned: bool = True, num_edges: int = 0,
              num_src: int = 0) -> str:
    """The kernel a call of ``wrapper`` launches, the one rule the C entry
    points obey: for a bf16 forward or src pass ``"pair"`` at ``feat`` <=
    128, a multiple of 8, where the rows, attn and outputs are 16-byte
    ``aligned`` and the pair src pass's shared memory holds ``num_rel``;
    else ``design_of``'s, its ring for the bf16 src pass ``"ring_factored"``
    on a graph of ``num_edges`` edges from ``num_src`` rows dense enough
    for ``ring_src_loop``; ``"tile"`` for ``relgat_bwd_rel``."""
    if wrapper is relgat_bwd_rel:
        return "tile"
    if (wrapper in (relgat_fwd_bf16, relgat_bwd_src_bf16) and aligned
            and feat % 8 == 0 and feat <= 128):
        warps = min((heads + 1) // 2, MAX_WARPS_PER_BLOCK)
        if (wrapper is relgat_fwd_bf16 or warps * EDGE_TABLE_BYTES
                + 4 * (2 * warps + 1) * num_rel <= MAX_BWD_SMEM_BYTES):
            return "pair"
    design = design_of(wrapper, heads, feat)
    if (design == "ring" and wrapper is relgat_bwd_src_bf16
            and ring_src_loop(num_edges, num_src, num_rel) == "factored"):
        return "ring_factored"
    return design


def designs_of(wrapper) -> Tuple[str, ...]:
    """The designs ``with_design`` takes for ``wrapper`` (``FORCED``)."""
    return tuple(FORCED.get(wrapper.__name__, ()))


def with_design(wrapper, design, *args, **kw):
    """``wrapper`` on CUDA tensors through the kernel ``FORCED`` names for
    ``design`` (``designs_of``), whichever ``kernel_of`` would take: for
    timing each kernel and holding it to the plain version; its launches
    count nowhere. A kernel whose conditions the call fails (a ring at 128
    features or fewer, the pair kernel past them or on rows not 16-byte
    aligned) is refused by its entry point, a RuntimeError. The arguments
    after ``design`` are ``wrapper``'s."""
    launch = {relgat_fwd: _launch_fwd, relgat_fwd_bf16: _launch_fwd,
              relgat_bwd_src: _launch_bwd_src,
              relgat_bwd_src_bf16: _launch_bwd_src,
              relgat_bwd_rel_bf16: _launch_bwd_rel}[wrapper]
    bf16_rows = {relgat_fwd_bf16: 1, relgat_bwd_src_bf16: 2,
                 relgat_bwd_rel_bf16: 1}.get(wrapper, 0)
    csr, tensors = ((None, args) if wrapper is relgat_bwd_rel_bf16
                    else (args[-1], args[:-1]))
    if not _on_card(wrapper.__name__, csr, *tensors, bf16_rows=bf16_rows):
        raise ValueError(f"{wrapper.__name__}: a design is chosen on the "
                         "card only")
    if design not in designs_of(wrapper):
        raise ValueError(f"{wrapper.__name__}: no design {design!r}")
    return launch(wrapper, *args, forced=FORCED[wrapper.__name__][design],
                  **kw)


FP32_KERNELS = (relgat_fwd, relgat_bwd_src, relgat_bwd_rel)
BF16_KERNELS = (relgat_fwd_bf16, relgat_bwd_src_bf16, relgat_bwd_rel_bf16)
KERNELS = FP32_KERNELS + BF16_KERNELS


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def design_counts() -> dict:
    """Kernel launches by ``"<wrapper>/<design>"`` since the last reset,
    the designs each wrapper launched (see the module's docstring)."""
    return {f"{k.__name__}/{d}": n for k in KERNELS
            for d, n in sorted(k.designs.items())}


def reset_design_counts() -> None:
    for k in KERNELS:
        k.designs.clear()
    relgat_bwd_src_bf16.ring_loops.clear()


def ring_loop_counts() -> dict:
    """The bf16 ring src pass's launches by loop since the last reset:
    ``"factored"`` or ``"per_edge"`` (``ring_src_loop``)."""
    return dict(sorted(relgat_bwd_src_bf16.ring_loops.items()))
