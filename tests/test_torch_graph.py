"""The port's graph container and the kernels' CSR layout.

The padded COO must equal the JAX package's array for array (the plain path
is held to ``_xla_propagate`` on it); the CSR orderings must hold every real
edge exactly once under the canonical edge id the JAX layouts carry.
"""

import numpy as np
import pytest

from relgat_projector_tpu.data.blocked import _build_one_np
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu_torch.data.graph import build_graph


def _edges(seed=0, n=300, e=2000, r=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[:700] = 7  # one heavy row, mostly of one relation
    et = rng.integers(0, r, e)
    et[:600] = 2
    return src, dst, et, n, r


@pytest.mark.parametrize("e", (0, 1, 127, 128, 2000))
def test_padded_coo_matches_jax(e):
    src, dst, et, n, r = _edges()
    src, dst, et = src[:e], dst[:e], et[:e]
    g = build_graph(src, dst, et, n, num_rel=r, device="cpu")
    jg = jax_build_graph(src, dst, et, n)
    assert g.num_nodes == jg.num_nodes
    assert g.num_real_edges == jg.num_real_edges == e
    for a, b in ((g.src, jg.src), (g.dst, jg.dst), (g.etype, jg.etype)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_csr_layout_invariants():
    src, dst, et, n, r = _edges()
    g = build_graph(src, dst, et, n, num_rel=r, csr=True, device="cpu")
    c = g.csr
    e = c.num_edges
    # by dst: the real prefix of the dst-sorted COO; edge id = position
    np.testing.assert_array_equal(c.src.numpy(), g.src.numpy()[:e])
    np.testing.assert_array_equal(c.dst.numpy(), g.dst.numpy()[:e])
    ptr = c.dst_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == e and ptr.shape == (g.num_nodes + 1,)
    for d in (0, 7, n - 1):
        assert (c.dst.numpy()[ptr[d]:ptr[d + 1]] == d).all()
    # the ids are the TPU layout's canonical ids (chunk_meta row 3), which
    # index the dst-sorted real edges the JAX build_graph hands it
    order = np.argsort(dst, kind="stable")
    s_src, s_dst, s_et = src[order], dst[order], et[order]
    tpu = _build_one_np(s_dst, s_src, s_dst, s_et, g.num_nodes, 16, 64)
    real = tpu["mask"] > 0
    tpu_ids = tpu["edge_of_slot"][real]
    np.testing.assert_array_equal(c.src.numpy()[tpu_ids], tpu["src"][real])
    np.testing.assert_array_equal(c.etype.numpy()[tpu_ids], tpu["etype"][real])
    # by src: a permutation of edge ids, grouped by src
    eid = c.by_src_eid.numpy()
    np.testing.assert_array_equal(np.sort(eid), np.arange(e))
    np.testing.assert_array_equal(c.by_src_dst.numpy(), c.dst.numpy()[eid])
    np.testing.assert_array_equal(c.by_src_etype.numpy(), c.etype.numpy()[eid])
    sptr = c.src_ptr.numpy()
    srcs = c.src.numpy()[eid]
    assert (np.diff(srcs) >= 0).all()
    for s in (0, 5, n - 1):
        assert (srcs[sptr[s]:sptr[s + 1]] == s).all()
    # src-CSR rows: out-degrees, with each row's edges in id order (the
    # order relgat_bwd_src folds them into W and B); padded rows are empty
    np.testing.assert_array_equal(
        np.diff(sptr), np.bincount(src, minlength=g.num_nodes))
    assert sptr.shape == (g.num_nodes + 1,) and sptr[0] == 0 and sptr[-1] == e
    for s in range(g.num_nodes):
        assert (np.diff(eid[sptr[s]:sptr[s + 1]]) > 0).all()
    assert (c.by_src_etype.numpy() == 2).sum() == (et == 2).sum()
    assert (sptr[n:] == e).all()


@pytest.mark.parametrize(
    "field,value", [("src", -1), ("src", 300), ("dst", 300), ("etype", 9),
                    ("etype", -2)],
)
def test_out_of_range_indices_raise(field, value):
    src, dst, et, n, r = _edges()
    arrays = {"src": src.copy(), "dst": dst.copy(), "etype": et.copy()}
    arrays[field][17] = value
    with pytest.raises(ValueError, match=field):
        build_graph(arrays["src"], arrays["dst"], arrays["etype"], n,
                    num_rel=r, csr=True, device="cpu")
