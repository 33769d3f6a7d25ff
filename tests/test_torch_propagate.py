"""The port's propagate (plain path and the kernels' autograd.Function with
their plain versions) against the JAX package's ``_xla_propagate`` and its
Pallas kernels in interpret mode, forward and gradients (dh, dattn, dbias).

Inputs are made once with numpy and handed to both packages. Tolerances are
the bars ``test_pallas.py`` holds the Pallas kernels to against XLA: forward
rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-5 (fp32 sums in other
orders, the TPU kernel's per-chunk reference shift). Logits stay within a
spread of a few units per destination, far inside the ~80 where that shift
is exact. The ``out_hub`` case gives one source row 200 out-edges and the
layout a src-pass item size of ``OUT_HUB_ITEM_EDGES``, so that the src
pass's work plan splits that row (and a few others) into chunks; on the CPU
its gradients are also taken through ``relgat_bwd_src_split_plain``, the
kernels' route of per-chunk partial rows and their merge.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.data.blocked import build_blocked_graph
from relgat_projector_tpu.ops.dropout import seed_from_key
from relgat_projector_tpu.ops.pallas import relgat_propagate_pallas
from relgat_projector_tpu.ops.relgat_ops import relgat_propagate as jax_propagate
from relgat_projector_tpu_torch.data.csr import with_bwd_plan
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops.cuda import fused
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate

TD, TE = 16, 64
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
CASES = ("uniform", "empty_rows", "heavy_dst", "no_bias", "dropout", "zipf",
         "out_hub")
DROPOUT_KEY = 3
OUT_HUB_ITEM_EDGES = 16


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    n, e, r, heads, f = 150, 900, 7, 3, 16
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if case == "empty_rows":
        dst = rng.integers(0, 32, e)  # most rows get no in-edge
    if case == "heavy_dst":
        dst[:200] = 5  # 200 in-edges span 4 chunks of TE = 64
    if case == "zipf":
        # in-degree on hubs, dst drawn with p ~ 1/rank (bench.py's recipe)
        p = 1.0 / np.arange(1, n + 1) ** 1.0
        dst = rng.choice(n, size=e, p=p / p.sum())
    if case == "out_hub":
        src[:200] = 5  # 200 out-edges, 13 chunks of OUT_HUB_ITEM_EDGES
    et = rng.integers(0, r, e)
    g = build_graph(src, dst, et, n, num_rel=r, csr=True, device="cpu")
    if case == "out_hub":
        g = dataclasses.replace(
            g, csr=with_bwd_plan(g.csr, OUT_HUB_ITEM_EDGES))
    n_pad = g.num_nodes
    h = (rng.standard_normal((n_pad, heads, f)) * 0.5).astype(np.float32)
    attn = (rng.standard_normal((heads, r, f)) * 0.3).astype(np.float32)
    bias = None if case == "no_bias" else (
        rng.standard_normal(r) * 0.1).astype(np.float32)
    wsum = rng.standard_normal((n_pad, heads, f)).astype(np.float32)
    return g, h, attn, bias, wsum


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    """(out, grads) of the JAX XLA path and of the JAX Pallas path."""
    g, h, attn, bias, wsum = _inputs(case)
    rate = 0.3 if case == "dropout" else 0.0
    key = jax.random.PRNGKey(DROPOUT_KEY) if rate else None
    csr = g.csr
    blocked = build_blocked_graph(
        csr.src.numpy(), csr.dst.numpy(), csr.etype.numpy(),
        num_nodes=g.num_nodes, block_nodes=TD, chunk_edges=TE,
    )
    coo = [jnp.asarray(a.numpy().astype(np.int32)) for a in (g.src, g.dst, g.etype)]

    def xla(h_, a_, b_):
        return jax_propagate(
            h_, a_, b_, *coo, num_nodes=g.num_nodes, attn_dropout_rate=rate,
            dropout_rng=key, edges_sorted_by_dst=True,
        )

    def pallas(h_, a_, b_):
        return relgat_propagate_pallas(
            h_, a_, b_, blocked, attn_dropout_rate=rate, dropout_rng=key
        )

    results = {}
    for name, fn in (("xla", xla), ("pallas", pallas)):
        args = [jnp.asarray(h), jnp.asarray(attn)]
        args.append(None if bias is None else jnp.asarray(bias))
        argnums = (0, 1) if bias is None else (0, 1, 2)

        def loss(*a):
            return jnp.sum(jnp.sin(fn(*a)) * wsum)

        out = np.asarray(fn(*args))
        grads = jax.grad(loss, argnums=argnums)(*args)
        results[name] = (out, [np.asarray(x) for x in grads])
    return results


def _torch_results(case, use_pallas):
    g, h, attn, bias, wsum = _inputs(case)
    rate = 0.3 if case == "dropout" else 0.0
    seed = int(seed_from_key(jax.random.PRNGKey(DROPOUT_KEY))) if rate else None
    leaves = [torch.tensor(h, requires_grad=True),
              torch.tensor(attn, requires_grad=True)]
    if bias is not None:
        leaves.append(torch.tensor(bias, requires_grad=True))
    out = relgat_propagate(
        leaves[0], leaves[1], leaves[2] if bias is not None else None,
        g.src, g.dst, g.etype, num_nodes=g.num_nodes,
        attn_dropout_rate=rate, dropout_seed=seed, use_pallas=use_pallas,
        csr=g.csr,
    )
    (torch.sin(out) * torch.from_numpy(wsum)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves], g


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize(
    "port,ref",
    [("plain", "xla"), ("kernels", "pallas"), ("kernels", "xla")],
)
def test_propagate_matches_jax(case, port, ref):
    out, grads, g = _torch_results(case, use_pallas=(port == "kernels"))
    want_out, want_grads = _jax_results(case)[ref]
    rows = slice(None)
    if (port, ref) == ("kernels", "xla"):
        # The XLA path's padded edges carry rel_bias[0] into the last padded
        # row (and its softmax weight); the kernels leave padded rows at 0.
        rows = slice(0, g.num_real_nodes)
        want_grads = [want_grads[0][rows]] + want_grads[1:2]
        grads = [grads[0][rows]] + grads[1:2]
    np.testing.assert_allclose(out[rows], want_out[rows], **FWD_TOL)
    assert len(grads) == len(want_grads)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_split_src_route_matches_jax(monkeypatch):
    """The kernels' route through the src pass's work plan (partial rows
    per chunk, merged in chunk order), which the CPU wrapper does not take
    by itself, against JAX's Pallas kernels in interpret mode."""
    calls = []

    def split_route(*args, **kw):
        calls.append(args[-1].bwd_num_split)
        return fused.relgat_bwd_src_split_plain(*args, **kw)

    monkeypatch.setattr(fused, "relgat_bwd_src_plain", split_route)
    out, grads, g = _torch_results("out_hub", use_pallas=True)
    assert g.csr.bwd_num_split >= 1
    assert calls and all(n == g.csr.bwd_num_split for n in calls)
    want_out, want_grads = _jax_results("out_hub")["pallas"]
    np.testing.assert_allclose(out, want_out, **FWD_TOL)
    assert len(grads) == len(want_grads) == 3
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_out_hub_splits_the_src_pass():
    g = _inputs("out_hub")[0]
    deg = np.diff(g.csr.src_ptr.numpy())
    assert deg[5] >= 200 and g.csr.bwd_item_edges == OUT_HUB_ITEM_EDGES
    assert 5 in g.csr.bwd_merge[:, 0].tolist()


def test_kernel_path_zeroes_rows_without_in_edges():
    out, _, g = _torch_results("empty_rows", use_pallas=True)
    indeg = np.bincount(g.csr.dst.numpy(), minlength=g.num_nodes)
    assert (indeg == 0).sum() > 100
    np.testing.assert_array_equal(out[indeg == 0], 0.0)
    assert np.isfinite(out).all()


def test_heavy_dst_spans_three_tpu_chunks():
    g = _inputs("heavy_dst")[0]
    assert np.bincount(g.csr.dst.numpy()).max() >= 2 * TE + 1


def test_zipf_puts_in_degree_on_hubs():
    g = _inputs("zipf")[0]
    deg = np.bincount(g.csr.dst.numpy(), minlength=g.num_nodes)
    assert deg.max() >= 20 * deg.mean() and (deg == 0).sum() >= 20


def test_kernel_path_needs_the_csr_layout():
    g, h, attn, bias, _ = _inputs("uniform")
    with pytest.raises(ValueError, match="csr=True"):
        relgat_propagate(
            torch.from_numpy(h), torch.from_numpy(attn), torch.from_numpy(bias),
            g.src, g.dst, g.etype, num_nodes=g.num_nodes, use_pallas=True,
            csr=None,
        )
