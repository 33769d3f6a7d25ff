"""The src pass's work plan and its merge rule, on the CPU.

``data/csr.py`` cuts the src-CSR into work items of at most
``bwd_item_edges`` edges (``BWD_ITEM_EDGES``; ``with_bwd_plan`` rebuilds
the plan at another size): a source row of at most that many out-edges is
one item, a longer row consecutive chunks whose partial dh, W and B rows ``relgat_bwd_src``'s
merge kernel adds in chunk order. Here the plan's invariants are checked on
rows of out-degree 0, K, K+1 and 3K+5, a uniform graph, a zipf graph (dst
drawn with p ~ 1/rank, ``bench.py``'s recipe: in-degree hubs) and the same
graph with src and dst swapped (out-degree hubs), and
``relgat_bwd_src_split_plain`` (the kernels' route in plain PyTorch) is held
to ``relgat_bwd_src_plain`` in float64 to 1e-12: the two differ only in the
order of the additions. So is ``relgat_bwd_src_factored_plain``, the bf16
ring's route (logits from ``P = h attn^T`` by (src row, relation), ``dh =
sum aw g + W attn``), over ``test_torch_propagate.py``'s cases, a relation
without edges and rows without out-edges, with and without dropout.
"""

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.data.csr import (
    BWD_ITEM_EDGES,
    build_bwd_plan,
    build_csr_graph,
    with_bwd_plan,
)
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops import cuda as kern
from tests.test_torch_propagate import CASES as PROPAGATE_CASES
from tests.test_torch_propagate import _inputs

K = 16  # a small item size, so that the graphs here split rows
REL_TOL = 1e-12
HUB = 5
CASES = ("degree_0", "degree_K", "degree_K+1", "degree_3K+5", "uniform",
         "zipf", "zipf_src")
DEGREES = {"0": 0, "K": K, "K+1": K + 1, "3K+5": 3 * K + 5}


def _graph(case, n=300, e=3000, num_rel=6, item_edges=K):
    rng = np.random.default_rng(CASES.index(case))
    src = rng.integers(0, n, e)
    if case.startswith("zipf"):
        p = 1.0 / np.arange(1, n + 1)
        dst = rng.choice(n, size=e, p=p / p.sum())
        if case == "zipf_src":
            src, dst = dst, src
    else:
        dst = rng.integers(0, n, e)
    if case.startswith("degree_"):
        degree = DEGREES[case.split("_")[1]]
        src[src == HUB] = HUB + 1
        src[:degree] = HUB
    et = rng.integers(0, num_rel, e)
    g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True, device="cpu")
    return g, with_bwd_plan(g.csr, item_edges), rng


@pytest.mark.parametrize("case", CASES)
def test_plan_covers_every_edge_once_in_order(case):
    g, c, _ = _graph(case)
    ptr = c.src_ptr.numpy()
    deg = np.diff(ptr)
    items = c.bwd_items.numpy()
    merge = c.bwd_merge.numpy()
    row, e0, e1, slot = items.T
    assert c.bwd_item_edges == K and c.bwd_num_items == len(items)
    # the items, in order, tile [0, E) in src-CSR order, row after row
    assert e0[0] == 0 and e1[-1] == c.num_edges
    np.testing.assert_array_equal(e0[1:], e1[:-1])
    assert (np.diff(row) >= 0).all()
    np.testing.assert_array_equal(np.unique(row), np.arange(c.num_src))
    assert ((ptr[row] <= e0) & (e1 <= ptr[row + 1])).all()
    assert ((e1 - e0) <= K).all()
    # a row of at most K out-edges (none included) is one whole-row item
    per_row = np.bincount(row, minlength=c.num_src)
    np.testing.assert_array_equal(per_row, np.maximum(1, -(-deg // K)))
    whole = per_row[row] == 1
    assert (slot[whole] == -1).all()
    np.testing.assert_array_equal(e0[whole], ptr[row[whole]])
    np.testing.assert_array_equal(e1[whole], ptr[row[whole] + 1])
    assert (deg[row[whole]] == 0).sum() == (deg == 0).sum()
    # a split row: full chunks of K but the last, slots contiguous in chunk
    # order, listed once in the merge list
    assert (e1[~whole] - e0[~whole] >= 1).all()
    np.testing.assert_array_equal(slot[~whole], np.arange((~whole).sum()))
    assert c.bwd_num_split == len(merge) and c.bwd_num_parts == (~whole).sum()
    for r, first, end in merge:
        mine = np.flatnonzero(row == r)
        np.testing.assert_array_equal(slot[mine], np.arange(first, end))
        assert (e1[mine[:-1]] - e0[mine[:-1]] == K).all()
    np.testing.assert_array_equal(merge[:, 0], np.flatnonzero(deg > K))
    if case.startswith("degree_"):
        want = DEGREES[case.split("_")[1]]
        assert deg[HUB] == want
        assert per_row[HUB] == max(1, -(-want // K))
    if case == "zipf_src":
        assert len(merge) >= 1 and deg.max() > 10 * K


def test_every_layout_carries_the_default_plan():
    g, _, _ = _graph("zipf_src")
    c = g.csr
    assert c.bwd_item_edges == BWD_ITEM_EDGES
    items, merge = build_bwd_plan(c.src_ptr.numpy(), BWD_ITEM_EDGES)
    np.testing.assert_array_equal(c.bwd_items.numpy(), items)
    np.testing.assert_array_equal(c.bwd_merge.numpy(), merge.reshape(-1, 3))
    # a layout built with another item size, and a source space of its own
    rng = np.random.default_rng(1)
    dst = np.sort(rng.integers(0, 40, 200))
    src = rng.integers(0, 50, 200)
    src[:30] = 3
    sub = build_csr_graph(src, dst, np.zeros_like(src), 40, 1,
                          torch.device("cpu"), num_src=50)
    assert sub.bwd_item_edges == BWD_ITEM_EDGES and sub.bwd_num_split == 0
    sub = with_bwd_plan(sub, 7)
    assert sub.bwd_item_edges == 7 and sub.bwd_num_items > 50
    assert 3 in sub.bwd_merge[:, 0].tolist()
    empty = build_csr_graph(*(np.zeros(0, np.int64),) * 3, 8, 1,
                            torch.device("cpu"), num_src=0)
    assert empty.bwd_num_items == 0 and empty.bwd_num_parts == 0


@pytest.mark.parametrize("item_edges", (0, -1))
def test_plan_needs_positive_item_size(item_edges):
    with pytest.raises(ValueError, match="item_edges"):
        build_bwd_plan(np.array([0, 3, 3]), item_edges)


def _src_args(case, heads=3, num_rel=6, f=16, rate=0.0):
    g, c, rng = _graph(case, num_rel=num_rel)
    n = g.num_nodes
    h = torch.from_numpy(rng.standard_normal((n, heads * f)) * 0.5)
    gr = torch.from_numpy(rng.standard_normal((n, heads * f)))
    attn = torch.from_numpy(rng.standard_normal((heads, num_rel, f)) * 0.3)
    bias = torch.from_numpy(rng.standard_normal(num_rel) * 0.1)
    kw = dict(seed=-13579 if rate else None, rate=rate, negative_slope=0.2,
              eps=1e-16)
    out, m, l, b = kern.relgat_fwd_plain(h, attn, bias, c, **kw)
    s_dot = ((out - b[:, None]) * gr).view(n, heads, f).sum(-1)
    return (h, gr, attn, m, l, s_dot, gr.sum(1), c), kw


@pytest.mark.parametrize("case", ("degree_K+1", "degree_3K+5", "uniform",
                                  "zipf", "zipf_src"))
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_merge_matches_plain(case, rate):
    args, kw = _src_args(case, rate=rate)
    assert args[-1].bwd_num_split >= 1
    want = kern.relgat_bwd_src_plain(*args, **kw)
    got = kern.relgat_bwd_src_split_plain(*args, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert float((a - b).abs().max()) <= REL_TOL * float(
            b.abs().max().clamp_min(1e-300))


def test_rows_without_out_edges_are_zero():
    args, kw = _src_args("zipf_src")
    c = args[-1]
    empty = torch.from_numpy(np.diff(c.src_ptr.numpy()) == 0)
    assert bool(empty.any())
    for fn in (kern.relgat_bwd_src, kern.relgat_bwd_src_split_plain,
               kern.relgat_bwd_src_factored_plain):
        for x in fn(*args, **kw):
            assert bool((x[empty] == 0).all()) and bool(torch.isfinite(x).all())


EMPTY_REL = 4  # the relation without edges
EMPTY_ROWS = 40  # rows 0 .. 39 without out-edges
FACTORED_CASES = PROPAGATE_CASES + ("relation_without_edges",
                                    "rows_without_out_edges")


def _factored_args(case, rate):
    """The src pass's inputs in float64 on ``test_torch_propagate.py``'s
    graph of ``case`` (its ``out_hub`` layout splits rows), or on a uniform
    graph of that size with relation ``EMPTY_REL`` or rows below
    ``EMPTY_ROWS`` left without edges, in items of ``K`` edges."""
    if case in PROPAGATE_CASES:
        g, h, attn, bias, gr = _inputs(case)
        c = g.csr
        heads, num_rel, f = attn.shape
    else:
        rng = np.random.default_rng(FACTORED_CASES.index(case))
        n, e, num_rel, heads, f = 150, 900, 7, 3, 16
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        et = rng.integers(0, num_rel, e)
        if case == "relation_without_edges":
            et[et == EMPTY_REL] = EMPTY_REL + 1
        else:
            src[src < EMPTY_ROWS] += EMPTY_ROWS
        g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True,
                        device="cpu")
        c = with_bwd_plan(g.csr, K)
        h = rng.standard_normal((g.num_nodes, heads, f)) * 0.5
        attn = rng.standard_normal((heads, num_rel, f)) * 0.3
        bias = rng.standard_normal(num_rel) * 0.1
        gr = rng.standard_normal((g.num_nodes, heads, f))
    n = g.num_nodes
    h, attn, gr = (torch.from_numpy(np.asarray(x, np.float64)).reshape(s)
                   for x, s in ((h, (n, heads * f)),
                                (attn, (heads, num_rel, f)),
                                (gr, (n, heads * f))))
    bias = torch.from_numpy(np.zeros(num_rel) if bias is None
                            else np.asarray(bias, np.float64))
    kw = dict(seed=-13579 if rate else None, rate=rate, negative_slope=0.2,
              eps=1e-16)
    out, m, l, b = kern.relgat_fwd_plain(h, attn, bias, c, **kw)
    s_dot = ((out - b[:, None]) * gr).view(n, heads, f).sum(-1)
    return (h, gr, attn, m, l, s_dot, gr.sum(1), c), kw


@pytest.mark.parametrize("case", FACTORED_CASES)
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_factored_route_matches_plain(case, rate):
    """The bf16 ring's route, logits and the attn term of dh by (src row,
    relation), against the plain per-edge src pass at 1e-12 in float64."""
    args, kw = _factored_args(case, rate)
    c = args[-1]
    if case == "out_hub":
        assert c.bwd_num_split >= 1
    if case == "relation_without_edges":
        assert not bool((c.etype == EMPTY_REL).any())
    if case == "rows_without_out_edges":
        assert (np.diff(c.src_ptr.numpy())[:EMPTY_ROWS] == 0).all()
    want = kern.relgat_bwd_src_plain(*args, **kw)
    got = kern.relgat_bwd_src_factored_plain(*args, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert float((a - b).abs().max()) <= REL_TOL * float(
            b.abs().max().clamp_min(1e-300))
    if case == "relation_without_edges":
        assert bool((got[1][:, :, EMPTY_REL] == 0).all())
    if case == "rows_without_out_edges":
        assert all(bool((x[:EMPTY_ROWS] == 0).all()) for x in got)


@pytest.mark.parametrize("edges,rows,rels,loop", [
    (10_000_000, 100_008, 100, "factored"),  # zipf-inv-10m
    (5_000_000, 100_008, 100, "factored"),
    (2_000_000, 100_008, 100, "per_edge"),
    (4_000_000, 100_008, 40, "factored"),
    (1_000_000, 100_008, 40, "per_edge"),  # sparse-1m
    (0, 0, 40, "factored"),
])
def test_ring_src_loop_follows_the_density(edges, rows, rels, loop):
    """The bf16 ring src pass takes its factored loop on graphs with enough
    edges a (source row, relation) to pay for its two products (the
    measured rule beside ``RING_RANGES``), the per-edge loop below; only
    that wrapper has the per-edge ring as a design of its own."""
    assert kern.ring_src_loop(edges, rows, rels) == loop
    assert kern.designs_of(kern.relgat_bwd_src_bf16) == (
        "lanes", "ring", "ring_per_edge", "pair")
    assert kern.designs_of(kern.relgat_bwd_src) == ("lanes", "ring")


RULE_ROWS = 100_008  # zipf-inv-10m's source rows
SPARSE = 1_000_000   # sparse-1m's edges: the per-edge loop at every R here


@pytest.mark.parametrize("wrapper,heads,feat,num_rel,offset,edges,kernel", [
    # the bf16 pair kernels at small-bf16's 16 x 128, not in fp32
    ("relgat_fwd_bf16", 16, 128, 40, 0, SPARSE, "pair"),
    ("relgat_bwd_src_bf16", 16, 128, 40, 0, SPARSE, "pair"),
    ("relgat_fwd", 16, 128, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 16, 128, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd_bf16", 3, 40, 7, 0, SPARSE, "pair"),
    ("relgat_fwd_bf16", 4, 28, 7, 0, SPARSE, "lanes"),  # not a multiple of 8
    # h a view one bf16 value past a 16-byte boundary: the template
    ("relgat_fwd_bf16", 16, 128, 40, 1, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 16, 128, 40, 1, SPARSE, "lanes"),
    # the pair src pass's shared memory: 8 warps of 16 heads hold R <= 602
    ("relgat_bwd_src_bf16", 16, 128, 602, 0, SPARSE, "pair"),
    ("relgat_bwd_src_bf16", 16, 128, 603, 0, SPARSE, "lanes"),
    ("relgat_fwd_bf16", 16, 128, 603, 0, SPARSE, "pair"),
    # ring against lanes at both ends of each RING_RANGES entry
    ("relgat_fwd", 4, 128, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd", 4, 129, 40, 0, SPARSE, "ring"),
    ("relgat_fwd", 4, 152, 40, 0, SPARSE, "ring"),
    ("relgat_fwd", 4, 153, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd", 3, 129, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd", 4, 256, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd", 4, 257, 40, 0, SPARSE, "ring"),
    ("relgat_fwd", 4, 448, 40, 0, SPARSE, "ring"),
    ("relgat_fwd", 4, 449, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 4, 128, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 4, 129, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src", 4, 216, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src", 4, 217, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 4, 247, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 4, 248, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src", 4, 520, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src", 4, 521, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src", 3, 300, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd_bf16", 1, 256, 40, 0, SPARSE, "lanes"),
    ("relgat_fwd_bf16", 1, 257, 40, 0, SPARSE, "ring"),
    ("relgat_fwd_bf16", 1, 368, 40, 0, SPARSE, "ring"),
    ("relgat_fwd_bf16", 1, 369, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 1, 128, 40, 1, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 1, 129, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src_bf16", 1, 320, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src_bf16", 3, 321, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 4, 321, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src_bf16", 4, 480, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src_bf16", 4, 481, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 1, 512, 40, 0, SPARSE, "lanes"),
    ("relgat_bwd_src_bf16", 1, 513, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src_bf16", 1, 1024, 40, 0, SPARSE, "ring"),
    # the bf16 ring's loop on either side of ring_src_loop (R = 100: the
    # factored loop from ~3.8M edges on these rows); the fp32 ring has one
    ("relgat_bwd_src_bf16", 12, 256, 100, 0, 10_000_000, "ring_factored"),
    ("relgat_bwd_src_bf16", 12, 256, 100, 0, 3_900_000, "ring_factored"),
    ("relgat_bwd_src_bf16", 12, 256, 100, 0, 3_700_000, "ring"),
    ("relgat_bwd_src_bf16", 12, 300, 40, 0, SPARSE, "ring"),
    ("relgat_bwd_src", 12, 300, 100, 0, 10_000_000, "ring"),
    ("relgat_fwd_bf16", 12, 256, 100, 0, 10_000_000, "lanes"),
    # the relation reduction: mma against tile
    ("relgat_bwd_rel_bf16", 12, 256, 100, 0, SPARSE, "mma"),
    ("relgat_bwd_rel_bf16", 16, 128, 40, 0, SPARSE, "mma"),
    ("relgat_bwd_rel_bf16", 3, 301, 40, 0, SPARSE, "tile"),
    ("relgat_bwd_rel_bf16", 1, 128, 40, 0, SPARSE, "tile"),
    ("relgat_bwd_rel", 12, 256, 100, 0, SPARSE, "tile"),
])
def test_one_rule_picks_every_kernel(wrapper, heads, feat, num_rel, offset,
                                     edges, kernel):
    """``kernel_of`` names the kernel of every launch from what the call
    can observe: the wrapper, heads, F and R, whether its rows are 16-byte
    aligned (here h's first row, a view ``offset`` bf16 values in), and the
    graph's density, on ``RULE_ROWS`` source rows. The C entry points
    launch that kernel or refuse it."""
    h = torch.empty(heads * feat + offset, dtype=torch.bfloat16)[offset:]
    aligned = kern.fused._aligned(h)
    assert aligned == (offset == 0)
    assert kern.kernel_of(getattr(kern, wrapper), heads, feat, num_rel,
                          aligned=aligned, num_edges=edges,
                          num_src=RULE_ROWS) == kernel


@pytest.mark.parametrize("wrapper,kernel,design,loops", [
    ("relgat_bwd_src_bf16", "ring_factored", "ring", {"factored": 1}),
    ("relgat_bwd_src_bf16", "ring", "ring", {"per_edge": 1}),
    ("relgat_bwd_src_bf16", "pair", "pair", {}),
    ("relgat_bwd_src", "ring", "ring", {}),
    ("relgat_fwd_bf16", "ring", "ring", {}),
    ("relgat_fwd", "lanes", "lanes", {}),
    ("relgat_bwd_rel_bf16", "mma", "mma", {}),
])
def test_the_counters_read_the_kernel_launched(wrapper, kernel, design,
                                               loops):
    """A launch counts the kernel ``kernel_of`` named: one launch of the
    wrapper, one of its design (both rings count as ``"ring"``), and for
    the bf16 src pass's ring one of its loop."""
    w = getattr(kern, wrapper)
    kern.reset_design_counts()
    before = w.launches
    try:
        kern.fused._count(w, kernel, "merge")
        assert w.launches == before + 1
        assert kern.design_counts() == {f"{wrapper}/{design}": 1,
                                        f"{wrapper}/merge": 1}
        assert kern.ring_loop_counts() == loops
    finally:
        w.launches = before
        kern.reset_design_counts()
