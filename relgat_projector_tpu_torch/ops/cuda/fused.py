"""Wrappers of the Hopper propagate kernels, each beside its plain version.

Port of ``relgat_projector_tpu/ops/pallas/fused.py``:

- ``relgat_fwd`` (``csrc/relgat_fwd.cu``) replaces ``_fused_kernel``;
- ``relgat_bwd_src`` and ``relgat_bwd_rel`` (``csrc/relgat_bwd.cu``) together
  replace ``_bwd_src_kernel``: dh and the per-edge logit gradient ``de`` in
  src order, then dattn/dbias reduced per relation (the TPU kernel sums
  those across its sequential grid, which this card does not have).

A wrapper given CPU tensors computes its plain PyTorch version (the
``*_plain`` function beside it); given CUDA tensors it launches its kernel
or raises. The plain versions are the reference the kernels are held to on
the card; nothing on the card's main path calls them. Each wrapper counts
its launches in a plain int attribute, ``<wrapper>.launches``.

Shapes: ``h``/``g``/``out``/``dh`` are ``[N, H*F]`` fp32 over the layout's
N (padded) node rows; ``attn``/``dattn`` ``[H, R, F]``; the statistics
``m``, ``l`` (un-dropped softmax sum) and ``s_dot`` (``<out - bias, g>``)
``[N, H]``; ``de`` ``[E, H]`` by canonical edge id.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.data.csr import CSRGraph
from relgat_projector_tpu_torch.ops.cuda.build import entry_point
from relgat_projector_tpu_torch.ops.dropout import (
    edge_keep_mask_all_heads,
    keep_threshold,
)
from relgat_projector_tpu_torch.ops.segment import segment_max, segment_sum

MAX_FEAT = 256  # csrc/relgat_common.cuh kMaxFeatPerLane * 32


def _dropout_args(seed: Optional[int], rate: float):
    """(use, seed, threshold, keep probability) for the C entry points."""
    if rate > 0.0 and seed is not None:
        if not -(2**31) <= int(seed) < 2**31:
            raise ValueError(f"dropout seed {seed} is not an int32")
        return 1, int(seed), keep_threshold(rate), 1.0 - float(rate)
    return 0, 0, 0, 1.0


def _keep_scale(csr: CSRGraph, heads, seed, rate, device) -> Optional[torch.Tensor]:
    if not (rate > 0.0 and seed is not None):
        return None
    eids = torch.arange(csr.num_edges, device=device)
    return edge_keep_mask_all_heads(eids, heads, seed, rate) / (1.0 - rate)


def _on_card(name: str, csr: CSRGraph, *tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (after checking them), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors + (csr.dst_ptr,):
        if t.device != dev:
            raise ValueError(f"{name}: inputs lie on {t.device} and {dev}")
    for t in tensors:
        if t.dtype == torch.float32 and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.is_floating_point() and t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name}: only float32 ('highest' precision) is ported"
            )
    return True


def _check_shapes(name, h, attn, csr):
    n, hf = h.shape
    heads, num_rel, f = attn.shape
    if hf != heads * f or n != csr.num_nodes:
        raise ValueError(
            f"{name}: h is {tuple(h.shape)}, expected [{csr.num_nodes}, "
            f"{heads * f}]"
        )
    if f > MAX_FEAT:
        raise ValueError(f"{name}: features per head {f} > {MAX_FEAT}")
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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def relgat_fwd_plain(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_fwd``: ``(out, m, l, bias)``."""
    n, hf = h.shape
    heads, _, f = attn.shape
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    hs = h.view(n, heads, f)[src]                                # [E, H, F]
    e = F.leaky_relu(
        (hs * attn[:, et].transpose(0, 1)).sum(-1), negative_slope
    )                                                            # [E, H]
    m = segment_max(e, dst, n)
    p = torch.exp(e - torch.where(torch.isfinite(m), m, 0.0)[dst])
    l = segment_sum(p, dst, n)
    keep = _keep_scale(csr, heads, seed, rate, h.device)
    if keep is not None:
        p = p * keep
    acc = segment_sum(hs * p[..., None], dst, n)
    bias = segment_sum(rel_bias[et], dst, n)
    out = acc / l.clamp_min(eps)[..., None] + bias[:, None, None]
    return out.reshape(n, hf), m, l, bias


def relgat_fwd(
    h, attn, rel_bias, csr: CSRGraph, *, seed, rate, negative_slope, eps
):
    """Aggregate every row's in-edges: ``out [N, H*F]`` (rows without
    in-edges are 0) and the saved statistics ``m, l [N, H]``, ``bias [N]``."""
    if not _on_card("relgat_fwd", csr, h, attn, rel_bias):
        return relgat_fwd_plain(
            h, attn, rel_bias, csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
    n, heads, num_rel, f = _check_shapes("relgat_fwd", h, attn, csr)
    out = torch.empty_like(h)
    m = h.new_empty((n, heads))
    l = h.new_empty((n, heads))
    bias = h.new_empty((n,))
    use, s, thr, keep = _dropout_args(seed, rate)
    rc = entry_point("relgat_fwd")(
        h.data_ptr(), attn.data_ptr(), rel_bias.data_ptr(),
        csr.dst_ptr.data_ptr(), csr.src.data_ptr(), csr.etype.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), bias.data_ptr(),
        n, heads, f, num_rel, float(negative_slope), float(eps),
        use, s, thr, keep, _stream(),
    )
    _raise_on(rc, "relgat_fwd")
    relgat_fwd.launches += 1
    return out, m, l, bias


relgat_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward: dh and de in src order
# ---------------------------------------------------------------------------

def relgat_bwd_src_plain(
    h, g, attn, m, l, s_dot, csr: CSRGraph, *, seed, rate, negative_slope,
    eps,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_src``: ``(dh [N, H*F], de [E, H])``."""
    n, hf = h.shape
    heads, _, f = attn.shape
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    hs = h.view(n, heads, f)[src]
    gd = g.view(n, heads, f)[dst]
    ar = attn[:, et].transpose(0, 1)
    eraw = (hs * ar).sum(-1)
    dalpha = (hs * gd).sum(-1)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    alpha = torch.exp(
        F.leaky_relu(eraw, negative_slope) - m_safe[dst]
    ) / l.clamp_min(eps)[dst]
    keep = _keep_scale(csr, heads, seed, rate, h.device)
    k = keep if keep is not None else 1.0
    de = alpha * (dalpha * k - s_dot[dst])
    de = de * torch.where(eraw >= 0, 1.0, negative_slope)
    contrib = (alpha * k)[..., None] * gd + de[..., None] * ar
    return segment_sum(contrib, src, n).reshape(n, hf), de


def relgat_bwd_src(
    h, g, attn, m, l, s_dot, csr: CSRGraph, *, seed, rate, negative_slope,
    eps,
):
    """Gradient wrt ``h`` (every row written) and the per-edge logit
    gradient ``de [E, H]`` by canonical edge id."""
    if not _on_card("relgat_bwd_src", csr, h, g, attn, m, l, s_dot):
        return relgat_bwd_src_plain(
            h, g, attn, m, l, s_dot, csr, seed=seed, rate=rate,
            negative_slope=negative_slope, eps=eps,
        )
    n, heads, num_rel, f = _check_shapes("relgat_bwd_src", h, attn, csr)
    if g.shape != h.shape or not (m.shape == l.shape == s_dot.shape == (n, heads)):
        raise ValueError("relgat_bwd_src: g or statistics have wrong shapes")
    dh = torch.empty_like(h)
    de = h.new_empty((csr.num_edges, heads))
    use, s, thr, keep = _dropout_args(seed, rate)
    rc = entry_point("relgat_bwd_src")(
        h.data_ptr(), g.data_ptr(), attn.data_ptr(), m.data_ptr(),
        l.data_ptr(), s_dot.data_ptr(), csr.src_ptr.data_ptr(),
        csr.by_src_dst.data_ptr(), csr.by_src_etype.data_ptr(),
        csr.by_src_eid.data_ptr(), dh.data_ptr(), de.data_ptr(),
        n, heads, f, num_rel, float(negative_slope), float(eps),
        use, s, thr, keep, _stream(),
    )
    _raise_on(rc, "relgat_bwd_src")
    relgat_bwd_src.launches += 1
    return dh, de


relgat_bwd_src.launches = 0


# ---------------------------------------------------------------------------
# Backward: dattn and dbias per relation
# ---------------------------------------------------------------------------

def relgat_bwd_rel_plain(
    h, de, gsum, csr: CSRGraph, num_rel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``relgat_bwd_rel``: ``(dattn [H, R, F], dbias [R])``."""
    n, hf = h.shape
    heads = de.shape[1]
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    hs = h.view(n, heads, hf // heads)[src]
    dattn = segment_sum(de[..., None] * hs, et, num_rel).transpose(0, 1)
    return dattn.contiguous(), segment_sum(gsum[dst], et, num_rel)


def relgat_bwd_rel(h, de, gsum, csr: CSRGraph, num_rel: int):
    """``dattn[r] = sum_{e: etype=r} de[e] * h[src_e]`` and
    ``dbias[r] = sum_{e: etype=r} gsum[dst_e]``, deterministic."""
    if not _on_card("relgat_bwd_rel", csr, h, de, gsum):
        return relgat_bwd_rel_plain(h, de, gsum, csr, num_rel)
    n, hf = h.shape
    heads = de.shape[1]
    f = hf // heads
    if (heads * f != hf or n != csr.num_nodes or gsum.shape != (n,)
            or de.shape[0] != csr.num_edges or csr.num_rel > num_rel):
        raise ValueError("relgat_bwd_rel: inputs do not match the layout")
    part_attn = h.new_empty((csr.num_chunks, hf))
    part_bias = h.new_empty((csr.num_chunks,))
    dattn = h.new_empty((heads, num_rel, f))
    dbias = h.new_empty((num_rel,))
    rc = entry_point("relgat_bwd_rel")(
        h.data_ptr(), de.data_ptr(), gsum.data_ptr(), csr.src.data_ptr(),
        csr.dst.data_ptr(), csr.rel_eid.data_ptr(),
        csr.chunk_start.data_ptr(), csr.chunk_end.data_ptr(),
        csr.rel_chunk_ptr.data_ptr(), part_attn.data_ptr(),
        part_bias.data_ptr(), dattn.data_ptr(), dbias.data_ptr(),
        csr.num_chunks, heads, f, num_rel, csr.num_rel, _stream(),
    )
    _raise_on(rc, "relgat_bwd_rel")
    relgat_bwd_rel.launches += 1
    return dattn, dbias


relgat_bwd_rel.launches = 0

KERNELS = (relgat_fwd, relgat_bwd_src, relgat_bwd_rel)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
