"""The forward's work plan and its merge rule, on the CPU.

``data/csr.py`` cuts the dst-CSR into work items of at most
``FWD_ITEM_EDGES`` edges: a row of at most that many in-edges is one item,
a longer row consecutive chunks whose partials ``(m_c, l_c, acc_c, bias_c)``
``relgat_fwd``'s merge kernel combines in chunk order. Here the plan's
invariants are checked on rows of degree 0, K, K+1 and 3K+5, a uniform graph
and a zipf graph (dst drawn with p ~ 1/rank, ``bench.py``'s recipe), and
``relgat_fwd_split_plain`` (the kernels' route in plain PyTorch) is held to
``relgat_fwd_plain`` in float64 to 1e-12: the two differ only in the order
of the additions.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.data.csr import FWD_ITEM_EDGES, build_fwd_plan
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops import cuda as kern

K = FWD_ITEM_EDGES
REL_TOL = 1e-12
HUB = 5
CASES = ("degree_0", "degree_K", "degree_K+1", "degree_3K+5", "uniform",
         "zipf")
FWD_CU = (Path(__file__).resolve().parents[1] / "relgat_projector_tpu_torch"
          / "csrc" / "relgat_fwd.cu")


def _graph(case, n=300, e=3000, num_rel=6):
    rng = np.random.default_rng(CASES.index(case))
    src = rng.integers(0, n, e)
    if case == "zipf":
        p = 1.0 / np.arange(1, n + 1) ** 1.0
        p /= p.sum()
        dst = rng.choice(n, size=e, p=p)
    else:
        dst = rng.integers(0, n, e)
    if case.startswith("degree_"):
        degree = {"0": 0, "K": K, "K+1": K + 1, "3K+5": 3 * K + 5}[
            case.split("_")[1]]
        dst[dst == HUB] = HUB + 1
        dst[:degree] = HUB
    et = rng.integers(0, num_rel, e)
    return build_graph(src, dst, et, n, num_rel=num_rel, csr=True,
                       device="cpu"), rng


@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_edge_once_in_order(case):
    g, _ = _graph(case)
    c = g.csr
    ptr = c.dst_ptr.numpy()
    deg = np.diff(ptr)
    items = c.fwd_items.numpy()
    merge = c.fwd_merge.numpy()
    row, e0, e1, slot = items.T
    assert c.fwd_item_edges == K and c.fwd_num_items == len(items)
    # the items, in order, tile [0, E) in dst-CSR order, row after row
    assert e0[0] == 0 and e1[-1] == c.num_edges
    np.testing.assert_array_equal(e0[1:], e1[:-1])
    assert (np.diff(row) >= 0).all()
    np.testing.assert_array_equal(np.unique(row), np.arange(g.num_nodes))
    assert ((ptr[row] <= e0) & (e1 <= ptr[row + 1])).all()
    assert ((e1 - e0) <= K).all()
    # a row of at most K in-edges (none included) is one whole-row item
    per_row = np.bincount(row, minlength=g.num_nodes)
    np.testing.assert_array_equal(per_row, np.maximum(1, -(-deg // K)))
    whole = per_row[row] == 1
    assert (slot[whole] == -1).all()
    np.testing.assert_array_equal(e0[whole], ptr[row[whole]])
    np.testing.assert_array_equal(e1[whole], ptr[row[whole] + 1])
    # a split row: full chunks of K but the last, slots contiguous in chunk
    # order, listed once in the merge list
    assert (e1[~whole] - e0[~whole] >= 1).all()
    np.testing.assert_array_equal(slot[~whole], np.arange((~whole).sum()))
    assert c.fwd_num_split == len(merge) and c.fwd_num_parts == (~whole).sum()
    for r, first, end in merge:
        mine = np.flatnonzero(row == r)
        np.testing.assert_array_equal(slot[mine], np.arange(first, end))
        assert (e1[mine[:-1]] - e0[mine[:-1]] == K).all()
    np.testing.assert_array_equal(merge[:, 0], np.flatnonzero(deg > K))
    if case.startswith("degree_"):
        want = {"0": 0, "K": K, "K+1": K + 1, "3K+5": 3 * K + 5}[
            case.split("_")[1]]
        assert deg[HUB] == want
        assert per_row[HUB] == max(1, -(-want // K))
    if case == "zipf":
        assert len(merge) >= 1 and deg.max() > K


@pytest.mark.parametrize("case", CASES)
def test_rows_without_in_edges_are_zero(case):
    g, rng = _graph(case)
    c = g.csr
    heads, f = 2, 8
    h = torch.from_numpy(rng.standard_normal((g.num_nodes, heads * f)))
    attn = torch.from_numpy(rng.standard_normal((heads, 6, f)) * 0.3)
    bias = torch.from_numpy(rng.standard_normal(6) * 0.1)
    empty = np.diff(c.dst_ptr.numpy()) == 0
    assert empty.any()
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    for fwd in (kern.relgat_fwd, kern.relgat_fwd_split_plain):
        out, m, l, b = fwd(h, attn, bias, c, **kw)
        assert bool((out[empty] == 0).all()) and bool((l[empty] == 0).all())
        assert bool((b[empty] == 0).all()) and bool(torch.isinf(m[empty]).all())
        assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("case", ("degree_K+1", "degree_3K+5", "zipf"))
@pytest.mark.parametrize("rate", (0.0, 0.3))
@pytest.mark.parametrize("with_bias", (True, False))
def test_merge_matches_plain(case, rate, with_bias):
    g, rng = _graph(case)
    c = g.csr
    assert c.fwd_num_split >= 1
    heads, num_rel, f = 3, 6, 16
    h = torch.from_numpy(rng.standard_normal((g.num_nodes, heads * f)) * 0.5)
    attn = torch.from_numpy(rng.standard_normal((heads, num_rel, f)) * 0.3)
    bias = torch.from_numpy(rng.standard_normal(num_rel) * 0.1)
    if not with_bias:
        bias = torch.zeros_like(bias)
    kw = dict(seed=-13579 if rate else None, rate=rate, negative_slope=0.2,
              eps=1e-16)
    want = kern.relgat_fwd_plain(h, attn, bias, c, **kw)
    got = kern.relgat_fwd_split_plain(h, attn, bias, c, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert float((a - b)[fin].abs().max()) <= REL_TOL * float(
            b[fin].abs().max().clamp_min(1e-300))


def test_item_size_mirrors_the_kernel():
    text = FWD_CU.read_text()
    assert int(re.search(r"constexpr int kItemEdges = (\d+);", text)[1]) == K


@pytest.mark.parametrize("item_edges", (0, -1))
def test_plan_needs_positive_item_size(item_edges):
    with pytest.raises(ValueError, match="item_edges"):
        build_fwd_plan(np.array([0, 3, 3]), item_edges)
