"""The halo route's plan and per-shard propagate against the JAX package's,
on the CPU (``relgat_projector_tpu_torch/parallel/halo.py``).

- The plan (``build_halo_graph``) equals JAX's array for array: send lists,
  the unsplit layout and the local/remote split with canonical edge ids, at
  1, 2 and 4 shards, on a uniform and a clustered graph.
- One shard's overlapped propagate (the local subset over its own rows, the
  remote subset over the halo buffer, merged), by the port's plain route
  (``relgat_propagate_partial`` + ``merge_propagate_partials``) and by its
  kernels' plain versions (``OverlappedPropagate`` over CSR layouts whose
  source space is not their destination rows), against JAX's
  ``relgat_propagate_pallas_overlapped`` (Pallas in interpret mode) and the
  XLA partials of ``_halo_propagate_overlapped``: forward rtol 1e-4 /
  atol 1e-5, ``dh_own``, ``dhalo``, dattn and dbias rtol 1e-3 / atol 1e-5
  (``tests/test_pallas.py``'s bars), attention dropout 0 and 0.3 with the
  shard's seed injected on both sides (JAX's ``seed_from_key`` of one key).
  The graph gives shard 0 no remote edge and shard 3 no local one.
- ``relgat_propagate_partial`` and ``merge_propagate_partials`` against
  JAX's, masked edges and canonical ids included.
- The bf16 split propagate (``kernel_precision="default"``) against JAX's
  "default" Pallas path, at ``tests/test_torch_bf16.py``'s bars.
- The kernels' plain versions and shape gate over ``num_src != num_dst``:
  rows a subset never touches come out neutral, a subset without edges
  runs, out-of-range ids are refused on the host, and identity ids keep the
  single-device layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.ops import relgat_ops as jax_ops
from relgat_projector_tpu.ops.dropout import seed_from_key
from relgat_projector_tpu.ops.pallas.kernels import (
    relgat_propagate_pallas_overlapped,
)
from relgat_projector_tpu.parallel.halo import (
    build_halo_graph as jax_build_halo_graph,
)
from relgat_projector_tpu_torch.data.csr import build_csr_graph
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops import relgat_ops
from relgat_projector_tpu_torch.ops.propagate import (
    relgat_propagate_kernels,
    relgat_propagate_kernels_overlapped,
)
from relgat_projector_tpu_torch.parallel.halo import (
    build_halo_graph,
    shard_seed,
)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
N, E, R, HEADS, F = 200, 1600, 5, 3, 16
KEY = jax.random.PRNGKey(11)


def _uniform(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, E), rng.integers(0, N, E),
            rng.integers(0, R, E))


def _clustered(seed=1):
    """Four shards of 56 rows (N = 200): shard 0's in-edges come from its own
    rows only (no remote subset), shard 3's from other shards only (no local
    subset), shards 1 and 2 mostly from their own rows."""
    rng = np.random.default_rng(seed)
    rows, per = 56, E // 4
    srcs, dsts = [], []
    for d in range(4):
        hi = min((d + 1) * rows, N)
        dst = rng.integers(d * rows, hi, per)
        if d == 0:
            src = rng.integers(0, rows, per)
        elif d == 3:
            src = rng.integers(0, 3 * rows, per)
        else:
            own = rng.random(per) < 0.85
            src = np.where(own, rng.integers(d * rows, hi, per),
                           rng.integers(0, N, per))
        srcs.append(src)
        dsts.append(dst)
    return (np.concatenate(srcs), np.concatenate(dsts),
            rng.integers(0, R, 4 * per))


GRAPHS = {"uniform": _uniform, "clustered": _clustered}
PLAN_FIELDS = ("send_idx", "src_halo", "dst_local", "etype", "mask",
               "loc_src", "loc_dst", "loc_etype", "loc_mask", "loc_eid",
               "rem_src", "rem_dst", "rem_etype", "rem_mask", "rem_eid")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_plan_equals_jax(graph, shards, overlap):
    src, dst, et = GRAPHS[graph]()
    want = jax_build_halo_graph(src, dst, et, N, shards, overlap=overlap)
    got = build_halo_graph(src, dst, et, N, shards, overlap=overlap)
    for name in ("num_shards", "rows_per_shard", "halo_pair", "num_nodes",
                 "num_real_edges", "overlap"):
        assert getattr(got, name) == getattr(want, name), name
    for name in PLAN_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.exchange_bytes_per_device(64) == \
        want.exchange_bytes_per_device(64)
    assert got.replication_bytes_per_device(64) == \
        want.replication_bytes_per_device(64)


def test_plan_with_tpu_row_blocks_equals_jax():
    src, dst, et = _clustered()
    want = jax_build_halo_graph(src, dst, et, N, 4, blocked=True,
                                block_nodes=64, chunk_edges=128,
                                overlap=True)
    got = build_halo_graph(src, dst, et, N, 4, blocked=True, block_nodes=64,
                           overlap=True)
    assert (got.rows_per_shard, got.halo_pair) == (want.rows_per_shard,
                                                  want.halo_pair)
    for name in PLAN_FIELDS[5:]:
        assert np.array_equal(getattr(got, name),
                              np.asarray(getattr(want, name))), name


def _shard_inputs(seed=2):
    """The clustered graph's JAX plan (with its TPU layouts) and global
    inputs: ``h [G*rows, H, F]``, attn, bias, and a cotangent."""
    src, dst, et = _clustered()
    hg = jax_build_halo_graph(src, dst, et, N, 4, blocked=True,
                              block_nodes=8, chunk_edges=64, overlap=True)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((hg.num_nodes, HEADS, F)).astype(np.float32)
    attn = (rng.standard_normal((HEADS, R, F)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(R) * 0.1).astype(np.float32)
    cot = rng.standard_normal((hg.rows_per_shard, HEADS, F)).astype(
        np.float32)
    return hg, h, attn, bias, cot


def _split(hg, h, d):
    """Shard ``d``'s own rows and received halo buffer, from global ``h``."""
    rows, hp, g = hg.rows_per_shard, hg.halo_pair, hg.num_shards
    send = np.asarray(hg.send_idx)
    own = h[d * rows:(d + 1) * rows]
    halo = np.concatenate([h[o * rows + send[o, d]] for o in range(g)])
    return own, halo


def _jax_shard(hg, d, own, halo, attn, bias, cot, rate, route, precision):
    """JAX's (out, dh_own, dhalo, dattn, dbias) of shard ``d``."""
    rng = KEY if rate > 0 else None
    rows = hg.rows_per_shard

    def fwd(o, hl, a, b):
        if route == "pallas":
            take = lambda x: x[d]  # noqa: E731
            return relgat_propagate_pallas_overlapped(
                o, hl, a, b, jax.tree_util.tree_map(take, hg.blocked_loc),
                jax.tree_util.tree_map(take, hg.blocked_rem),
                attn_dropout_rate=rate, dropout_rng=rng,
                kernel_precision=precision,
            )
        kw = dict(num_out=rows, attn_dropout_rate=rate, dropout_rng=rng,
                  edges_sorted_by_dst=True)
        p_loc = jax_ops.relgat_propagate_partial(
            o, a, b, hg.loc_src[d], hg.loc_dst[d], hg.loc_etype[d],
            edge_mask=hg.loc_mask[d], dropout_edge_ids=hg.loc_eid[d], **kw)
        p_rem = jax_ops.relgat_propagate_partial(
            hl, a, b, hg.rem_src[d], hg.rem_dst[d], hg.rem_etype[d],
            edge_mask=hg.rem_mask[d], dropout_edge_ids=hg.rem_eid[d], **kw)
        return jax_ops.merge_propagate_partials([p_loc, p_rem])

    args = tuple(map(jnp.asarray, (own, halo, attn, bias)))
    out, vjp = jax.vjp(fwd, *args)
    grads = vjp(jnp.asarray(cot))
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _port_shard(d, own, halo, attn, bias, cot, rate, route, precision):
    """The port's (out, dh_own, dhalo, dattn, dbias) of shard ``d``."""
    plan = build_halo_graph(*_clustered(), N, 4, overlap=True)
    rows = plan.rows_per_shard
    seed = int(seed_from_key(KEY)) if rate > 0 else None
    t = [torch.from_numpy(x).requires_grad_(True)
         for x in (own, halo, attn, bias)]
    subsets = []
    for pre, num_src in (("loc", rows), ("rem", plan.num_shards
                                         * plan.halo_pair)):
        real = getattr(plan, f"{pre}_mask")[d] > 0
        cols = [getattr(plan, f"{pre}_{k}")[d][real].astype(np.int64)
                for k in ("src", "dst", "etype", "eid")]
        subsets.append((cols, num_src))
    if route == "kernels":
        csrs = [build_csr_graph(*cols[:3], rows, R, torch.device("cpu"),
                                num_src=num_src, eid=cols[3])
                for cols, num_src in subsets]
        out = relgat_propagate_kernels_overlapped(
            t[0], t[1], t[2], t[3], *csrs, attn_dropout_rate=rate,
            dropout_seed=seed, kernel_precision=precision)
    else:
        parts = [
            relgat_ops.relgat_propagate_partial(
                space, t[2], t[3], *map(torch.from_numpy, cols[:3]),
                num_out=rows, attn_dropout_rate=rate, dropout_seed=seed,
                dropout_edge_ids=torch.from_numpy(cols[3]))
            for space, (cols, _) in zip(t[:2], subsets)
        ]
        out = relgat_ops.merge_propagate_partials(parts)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [x.grad.numpy() for x in t]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_overlapped_shard_matches_jax_xla_partials(rate, route):
    hg, h, attn, bias, cot = _shard_inputs()
    loc_n = np.asarray(hg.loc_mask).sum(1)
    rem_n = np.asarray(hg.rem_mask).sum(1)
    assert rem_n[0] == 0 and loc_n[3] == 0 and (loc_n * rem_n)[1:3].all()
    for d in range(4):
        own, halo = _split(hg, h, d)
        want = _jax_shard(hg, d, own, halo, attn, bias, cot, rate, "xla",
                          "highest")
        got = _port_shard(d, own, halo, attn, bias, cot, rate, route,
                          "highest")
        np.testing.assert_allclose(got[0], want[0], **FWD)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_overlapped_shard_matches_jax_pallas(rate):
    """Shards 0 (no remote edge) and 1 (both subsets), kernels' route."""
    hg, h, attn, bias, cot = _shard_inputs()
    for d in (0, 1):
        own, halo = _split(hg, h, d)
        want = _jax_shard(hg, d, own, halo, attn, bias, cot, rate, "pallas",
                          "highest")
        got = _port_shard(d, own, halo, attn, bias, cot, rate, "kernels",
                          "highest")
        np.testing.assert_allclose(got[0], want[0], **FWD)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, **GRAD)


def test_bf16_split_propagate_matches_jax_default():
    """Shard 3 (no local edge) and 2 in the bf16 mode: forward 1e-4 / 1e-5,
    gradients within 1e-3 of their largest value (the bars of
    tests/test_torch_bf16.py)."""
    hg, h, attn, bias, cot = _shard_inputs(seed=5)
    for d in (3, 2):
        own, halo = _split(hg, h, d)
        want = _jax_shard(hg, d, own, halo, attn, bias, cot, 0.3, "pallas",
                          "default")
        got = _port_shard(d, own, halo, attn, bias, cot, 0.3, "kernels",
                          "default")
        np.testing.assert_allclose(got[0], want[0], **FWD)
        for a, b in zip(got[1:], want[1:]):
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= 1e-3 * scale


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_partial_and_merge_match_jax(rate):
    rng = np.random.default_rng(7)
    n_src, n_out, e = 40, 24, 300
    h = rng.standard_normal((n_src, HEADS, F)).astype(np.float32)
    attn = (rng.standard_normal((HEADS, R, F)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(R) * 0.1).astype(np.float32)
    parts_j, parts_t = [], []
    for k in range(2):
        src = rng.integers(0, n_src, e)
        dst = np.sort(rng.integers(0, n_out - 4 * k, e))  # rows left empty
        et = rng.integers(0, R, e)
        mask = (rng.random(e) < 0.9).astype(np.float32)
        eid = rng.permutation(2 * e)[:e]
        pj = jax_ops.relgat_propagate_partial(
            jnp.asarray(h), jnp.asarray(attn), jnp.asarray(bias),
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(et),
            num_out=n_out, attn_dropout_rate=rate,
            dropout_rng=KEY if rate else None, edge_mask=jnp.asarray(mask),
            dropout_edge_ids=jnp.asarray(eid))
        pt = relgat_ops.relgat_propagate_partial(
            torch.from_numpy(h), torch.from_numpy(attn),
            torch.from_numpy(bias), *map(torch.from_numpy, (src, dst, et)),
            num_out=n_out, attn_dropout_rate=rate,
            dropout_seed=int(seed_from_key(KEY)) if rate else None,
            edge_mask=torch.from_numpy(mask),
            dropout_edge_ids=torch.from_numpy(eid))
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
        parts_j.append(pj)
        parts_t.append(pt)
    np.testing.assert_allclose(
        relgat_ops.merge_propagate_partials(parts_t).numpy(),
        np.asarray(jax_ops.merge_propagate_partials(parts_j)), **FWD)


def _subset_csr(num_src, num_dst, e, seed, *, eid=None):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, num_dst - 3, e))  # the last rows: no edge
    src = rng.integers(0, num_src, e)
    et = rng.integers(0, R, e)
    return build_csr_graph(src, dst, et, num_dst, R, torch.device("cpu"),
                           num_src=num_src, eid=eid)


@pytest.mark.parametrize("num_src,num_dst", [(64, 24), (16, 40)])
def test_kernel_plain_versions_take_a_source_space(num_src, num_dst):
    rng = np.random.default_rng(3)
    e = 200
    csr = _subset_csr(num_src, num_dst, e, 4,
                      eid=rng.permutation(3 * e)[:e])
    h = torch.from_numpy(rng.standard_normal((num_src, HEADS * F)))
    attn = torch.from_numpy(rng.standard_normal((HEADS, R, F)) * 0.3)
    bias = torch.from_numpy(rng.standard_normal(R) * 0.1)
    kw = dict(seed=123, rate=0.3, negative_slope=0.2, eps=1e-16)
    out, m, l, b = kern.relgat_fwd(h, attn, bias, csr, **kw)
    split = kern.relgat_fwd_split_plain(h, attn, bias, csr, **kw)
    for a, c in zip((out, m, l, b), split):
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12)
    assert out.shape == (num_dst, HEADS * F) and m.shape == (num_dst, HEADS)
    assert torch.isinf(m[-3:]).all() and (l[-3:] == 0).all()
    assert (out[-3:] == 0).all()
    g = torch.from_numpy(rng.standard_normal((num_dst, HEADS * F)))
    s_dot = ((out - b[:, None]) * g).view(num_dst, HEADS, F).sum(-1)
    dh, w, bb = kern.relgat_bwd_src(h, g, attn, m, l, s_dot, g.sum(1), csr,
                                   **kw)
    assert dh.shape == (num_src, HEADS * F)
    assert w.shape == (num_src, HEADS, R) and bb.shape == (num_src, R)
    dattn, dbias = kern.relgat_bwd_rel(h, w, bb)
    assert dattn.shape == attn.shape and dbias.shape == (R,)
    # The shape gate reads h's rows as the source space.
    with pytest.raises(ValueError, match=f"expected \\[{num_src},"):
        kern.check_shapes("relgat_fwd", g, attn, csr)


def test_subset_without_edges_runs():
    csr = build_csr_graph(*(np.zeros(0, np.int64),) * 3, 16, R,
                          torch.device("cpu"), num_src=8)
    h = torch.randn(8, HEADS * F, dtype=torch.float64)
    attn = torch.randn(HEADS, R, F, dtype=torch.float64)
    out, m, l, b = kern.relgat_fwd(h, attn, torch.zeros(R, dtype=h.dtype),
                                   csr, seed=None, rate=0.0,
                                   negative_slope=0.2, eps=1e-16)
    assert (out == 0).all() and torch.isinf(m).all() and (l == 0).all()
    halo = torch.randn(8, HEADS, F, requires_grad=True)
    own = torch.randn(16, HEADS, F, requires_grad=True)
    loc = build_csr_graph(np.arange(16), np.arange(16), np.zeros(16, int),
                          16, R, torch.device("cpu"))
    res = relgat_propagate_kernels_overlapped(
        own, halo, attn.float(), None, loc, csr)
    res.sum().backward()
    assert (halo.grad == 0).all() and own.grad.abs().sum() > 0


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_halo_buffer_of_no_rows_runs(precision):
    """A remote subset over no source rows: the overlapped propagate is the
    local subset's alone, and the empty buffer's gradient keeps its
    width."""
    rem = build_csr_graph(*(np.zeros(0, np.int64),) * 3, 24, R,
                          torch.device("cpu"), num_src=0)
    loc = _subset_csr(24, 24, 120, 5)
    own = torch.randn(24, HEADS, F, requires_grad=True)
    halo = torch.zeros(0, HEADS, F, requires_grad=True)
    attn = torch.randn(HEADS, R, F) * 0.3
    kw = dict(kernel_precision=precision)
    res = relgat_propagate_kernels_overlapped(own, halo, attn, None, loc,
                                              rem, **kw)
    res.sum().backward()
    assert halo.grad.shape == (0, HEADS, F)
    own_alone = own.detach().clone().requires_grad_(True)
    want = relgat_propagate_kernels(own_alone, attn, None, loc, **kw)
    want.sum().backward()
    torch.testing.assert_close(res, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(own.grad, own_alone.grad, rtol=1e-6,
                               atol=1e-6)


def test_layout_refuses_ids_out_of_range():
    src, dst, et = np.array([0, 9]), np.array([0, 1]), np.array([0, 1])
    with pytest.raises(ValueError, match="src out of range"):
        build_csr_graph(src, dst, et, 4, R, torch.device("cpu"), num_src=9)
    with pytest.raises(ValueError, match="dst out of range"):
        build_csr_graph(np.array([0, 1]), np.array([0, 4]), et, 4, R,
                        torch.device("cpu"), num_src=9)


def test_identity_ids_keep_the_single_device_layout():
    src, dst, et = _uniform()
    order = np.argsort(dst, kind="stable")
    csr = build_csr_graph(src[order], dst[order], et[order], N, R,
                          torch.device("cpu"))
    assert csr.num_src == csr.num_nodes == N
    assert torch.equal(csr.eid, torch.arange(E, dtype=torch.int32))
    by_src = np.argsort(src[order], kind="stable")
    assert np.array_equal(csr.by_src_eid.numpy(), by_src)


def test_shard_seed_is_an_int32_rule_of_seed_and_shard():
    seeds = {shard_seed(s, g) for s in (-(2**31), -1, 0, 7, 2**31 - 1)
             for g in range(4)}
    assert len(seeds) == 20
    assert all(-(2**31) <= s < 2**31 for s in seeds)
    assert shard_seed(7, 2) == shard_seed(7, 2) != shard_seed(7, 3)
