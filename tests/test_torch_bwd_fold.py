"""The backward's folded route against the per-edge formula, on the CPU.

``relgat_bwd_src`` sums each edge's logit gradient per (src row, relation)
into ``W`` and ``gsum[dst]`` into ``B``; ``relgat_bwd_rel`` then reduces
``dattn = W^T h`` per head and ``dbias = sum_s B[s]``. In float64 that route
must give the per-edge sums ``dattn[r] = sum_{e: etype=r} de[e] h[src_e]``
and ``dbias[r] = sum_{e: etype=r} gsum[dst_e]`` to 1e-12 relative: the two
differ only in the order of the additions. Here the wrappers get CPU
tensors, so they run their plain versions.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops.dropout import edge_keep_mask_all_heads
from relgat_projector_tpu_torch.ops.segment import segment_sum

REL_TOL = 1e-12
EMPTY_REL = 1  # a relation no edge carries, where there are 3 or more
HEADS, FEAT = 3, 16


def _case(num_rel, seed):
    """A graph with self-loops, repeated (src, dst, etype) triples, source
    rows 0..9 without out-edges and, for R >= 3, one relation without
    edges; float64 inputs and the forward's statistics from them."""
    rng = np.random.default_rng(seed)
    n, e = 60, 500
    src = rng.integers(10, n, e)
    dst = rng.integers(0, n, e)
    et = rng.integers(0, num_rel, e)
    if num_rel >= 3:
        et[et == EMPTY_REL] = 0
    dst[:30] = src[:30]              # self-loops
    src[30:60] = src[60:90]          # multi-edges
    dst[30:60] = dst[60:90]
    et[30:60] = et[60:90]
    g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True, device="cpu")
    np_ = g.num_nodes

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale)

    h = randn(np_, HEADS * FEAT, scale=0.5)
    grad = randn(np_, HEADS * FEAT)
    attn = randn(HEADS, num_rel, FEAT, scale=0.3)
    bias = randn(num_rel, scale=0.1)
    return g, h, grad, attn, bias


def _edgewise(h, grad, attn, m, l, s_dot, gsum, csr, *, seed, rate):
    """The per-edge formula: de per (edge, head), then dh, dattn and dbias
    as sums over the edges' src, relation and relation."""
    n = h.shape[0]
    heads, num_rel, f = attn.shape
    src, dst, et = csr.src.long(), csr.dst.long(), csr.etype.long()
    hs = h.view(n, heads, f)[src]
    gd = grad.view(n, heads, f)[dst]
    ar = attn[:, et].transpose(0, 1)
    eraw = (hs * ar).sum(-1)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    alpha = torch.exp(F.leaky_relu(eraw, 0.2) - m_safe[dst]) / l[dst]
    k = 1.0
    if rate > 0.0:
        eids = torch.arange(csr.num_edges)
        k = edge_keep_mask_all_heads(eids, heads, seed, rate) / (1.0 - rate)
    de = alpha * ((hs * gd).sum(-1) * k - s_dot[dst])
    de = de * torch.where(eraw >= 0, 1.0, 0.2)
    dh = segment_sum((alpha * k)[..., None] * gd + de[..., None] * ar, src, n)
    dattn = segment_sum(de[..., None] * hs, et, num_rel).transpose(0, 1)
    dbias = segment_sum(gsum[dst], et, num_rel)
    return dh.reshape(n, heads * f), dattn, dbias


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("num_rel", (1, 7, 37))
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_fold_matches_edgewise(num_rel, rate):
    g, h, grad, attn, bias = _case(num_rel, seed=num_rel)
    csr = g.csr
    seed = 424242 if rate else None
    kw = dict(seed=seed, rate=rate, negative_slope=0.2, eps=1e-16)
    out, m, l, b = kern.relgat_fwd(h, attn, bias, csr, **kw)
    n = h.shape[0]
    s_dot = ((out - b[:, None]) * grad).view(n, HEADS, FEAT).sum(-1)
    gsum = grad.sum(1)
    before = kern.launch_counts()
    dh, w, bsum = kern.relgat_bwd_src(h, grad, attn, m, l, s_dot, gsum, csr,
                                      **kw)
    dattn, dbias = kern.relgat_bwd_rel(h, w, bsum)
    assert kern.launch_counts() == before  # CPU tensors: plain versions
    assert w.shape == (n, HEADS, num_rel) and bsum.shape == (n, num_rel)
    assert dattn.shape == attn.shape and dbias.shape == (num_rel,)

    want = _edgewise(h, grad, attn, m, l.clamp_min(1e-16), s_dot, gsum, csr,
                     seed=seed, rate=rate)
    for got, ref in zip((dh, dattn, dbias), want):
        assert _rel(got, ref) <= REL_TOL

    # rows without out-edges and relations without edges fold to exact 0
    outdeg = np.bincount(csr.src.numpy(), minlength=n)
    assert (outdeg[:10] == 0).all()
    assert bool((w[:10] == 0).all()) and bool((bsum[:10] == 0).all())
    if num_rel >= 3:
        assert bool((w[:, :, EMPTY_REL] == 0).all())
        assert bool((dattn[:, EMPTY_REL] == 0).all())
        assert float(dbias[EMPTY_REL]) == 0.0
    # W and B are the per-(src, relation) sums, edge by edge
    src, et = csr.src.numpy(), csr.etype.numpy()
    for s in (10, 30, n - 1):
        for r in set(et[src == s]) | {0}:
            edges = np.flatnonzero((src == s) & (et == r))
            gs = gsum[csr.dst.long()[torch.from_numpy(edges)]].sum()
            assert abs(float(bsum[s, r] - gs)) <= REL_TOL * float(
                bsum.abs().max())


def test_max_num_rel_follows_the_warps_of_a_block():
    # a 1 KB edge table per warp and (warps + 1) slabs of R floats in 48 KB;
    # 8 warps a block at most
    assert kern.max_num_rel(16) == (49152 - 8 * 1024) // (4 * 9) == 1137
    assert kern.max_num_rel(8) == kern.max_num_rel(64) == 1137
    assert kern.max_num_rel(1) == (49152 - 1024) // 8
    assert kern.max_num_rel(3) == (49152 - 3 * 1024) // 16
