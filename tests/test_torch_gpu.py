"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
test, so every xdist worker collects the same tests). Run them on a machine
with a card, from the repository root, without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: max|kernel - plain| <= 1e-5 * max|plain|, with the plain version
run in float64 on the same fp32 inputs, so the error is the kernel's own fp32
rounding (the kernels keep a true per-row running max like the plain
version). The bf16 variants are held to the same bar against their plain
versions run in float64 on the same bf16 values, widened exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.config import ModelConfig, RunConfig, TrainConfig
from relgat_projector_tpu_torch.data.csr import (
    BWD_ITEM_EDGES, FWD_ITEM_EDGES, build_fwd_plan, with_bwd_plan)
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops.propagate import relgat_propagate_kernels
from relgat_projector_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.gpu
REL_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _exact(plain, *args, **kw):
    """``plain`` on float64 copies of the floating-point inputs."""
    return plain(*(a.double() if isinstance(a, torch.Tensor) else a
                   for a in args), **kw)


def _case(heads, feat, num_rel=7, n=400, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(40, n, e)  # rows 0..39 have no in-edges
    dst[:500] = 77                # one heavy row
    et = rng.integers(0, num_rel, e)
    g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (g.num_nodes, heads * feat)
    h = torch.randn(shape, generator=gen, device="cuda") * 0.5
    gr = torch.randn(shape, generator=gen, device="cuda")
    attn = torch.randn((heads, num_rel, feat), generator=gen, device="cuda") * 0.3
    bias = torch.randn((num_rel,), generator=gen, device="cuda") * 0.1
    return g, h, gr, attn, bias


@pytest.mark.parametrize(
    "heads,feat,num_rel",
    [(1, 8, 7), (3, 40, 7), (16, 128, 7), (9, 200, 7), (4, 32, 1),
     (16, 128, 300), (12, 300, 7), (4, 512, 7), (2, 1024, 7), (3, 301, 7),
     (3, 128, 7), (1, 128, 7), (16, 200, 7), (12, 256, 7), (20, 136, 7),
     (9, 520, 7)],
)
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_kernels_match_plain(card, heads, feat, num_rel, rate):
    g, h, gr, attn, bias = _case(heads, feat, num_rel=num_rel)
    csr = g.csr
    kw = dict(seed=-987654321, rate=rate, negative_slope=0.2, eps=1e-16)
    before = kern.launch_counts()
    out_k, m_k, l_k, b_k = kern.relgat_fwd(h, attn, bias, csr, **kw)
    out_p, m, l, b = _exact(kern.relgat_fwd_plain, h, attn, bias, csr, **kw)
    assert _rel(out_k, out_p) <= REL_TOL
    assert _rel(l_k, l) <= REL_TOL and _rel(b_k, b) <= REL_TOL
    assert torch.equal(torch.isinf(m_k), torch.isinf(m))
    n = h.shape[0]
    s_dot = ((out_k - b_k[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (h, gr, attn, m_k, l_k, s_dot, gr.sum(1), csr)
    dh_k, w_k, bb_k = kern.relgat_bwd_src(*args, **kw)
    dh_p, w_p, bb_p = _exact(kern.relgat_bwd_src_plain, *args, **kw)
    assert _rel(dh_k, dh_p) <= REL_TOL
    assert _rel(w_k, w_p) <= REL_TOL and _rel(bb_k, bb_p) <= REL_TOL
    da_k, db_k = kern.relgat_bwd_rel(h, w_k, bb_k)
    da_p, db_p = _exact(kern.relgat_bwd_rel_plain, h, w_k, bb_k)
    assert _rel(da_k, da_p) <= REL_TOL and _rel(db_k, db_p) <= REL_TOL
    torch.cuda.synchronize()
    after = kern.launch_counts()
    for k in kern.FP32_KERNELS:
        assert after[k.__name__] == before[k.__name__] + 1
    for k in kern.BF16_KERNELS:
        assert after[k.__name__] == before[k.__name__]


@pytest.mark.parametrize(
    "heads,feat,num_rel",
    [(1, 8, 7), (3, 40, 7), (16, 128, 7), (9, 200, 7), (2, 6, 3),
     (2, 12, 3), (16, 128, 300), (12, 300, 7), (4, 512, 7), (2, 1024, 7),
     (3, 301, 7), (3, 128, 7), (1, 128, 7), (16, 200, 7), (12, 256, 7),
     (20, 136, 7), (9, 520, 7)],
)
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_bf16_kernels_match_plain(card, heads, feat, num_rel, rate):
    """bf16 h and g rows, fp32 everything else. F = 6 and 301 take the
    one-value loads everywhere; F = 12 and 300 the 8-byte row loads and
    8-byte staging in relgat_bwd_rel; F = 8, 40 and 128 (at most 16 heads)
    the pair kernels, two heads a warp (1 and 3 heads leave a warp's
    second half idle: an unpaired last head, as head tensor parallelism's
    tiles of 3 heads have at F = 128); F = 136, 200, 300, 301 and 520 the
    ring kernels in the forward or src pass, by width
    (``csrc/relgat_common.cuh``); the other widths the vector paths."""
    g, h, gr, attn, bias = _case(heads, feat, num_rel=num_rel)
    h16, g16 = h.to(torch.bfloat16), gr.to(torch.bfloat16)
    csr = g.csr
    kw = dict(seed=-987654321, rate=rate, negative_slope=0.2, eps=1e-16)
    before = kern.launch_counts()
    out_k, m_k, l_k, b_k = kern.relgat_fwd_bf16(h16, attn, bias, csr, **kw)
    out_p, m, l, b = _exact(kern.relgat_fwd_bf16_plain, h16, attn, bias, csr,
                            **kw)
    assert out_k.dtype == torch.float32
    assert _rel(out_k, out_p) <= REL_TOL
    assert _rel(l_k, l) <= REL_TOL and _rel(b_k, b) <= REL_TOL
    assert torch.equal(torch.isinf(m_k), torch.isinf(m))
    n = h.shape[0]
    s_dot = ((out_k - b_k[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (h16, g16, attn, m_k, l_k, s_dot, gr.sum(1), csr)
    dh_k, w_k, bb_k = kern.relgat_bwd_src_bf16(*args, **kw)
    dh_p, w_p, bb_p = _exact(kern.relgat_bwd_src_bf16_plain, *args, **kw)
    assert _rel(dh_k, dh_p) <= REL_TOL
    assert _rel(w_k, w_p) <= REL_TOL and _rel(bb_k, bb_p) <= REL_TOL
    da_k, db_k = kern.relgat_bwd_rel_bf16(h16, w_k, bb_k)
    da_p, db_p = _exact(kern.relgat_bwd_rel_bf16_plain, h16, w_k, bb_k)
    assert _rel(da_k, da_p) <= REL_TOL and _rel(db_k, db_p) <= REL_TOL
    torch.cuda.synchronize()
    after = kern.launch_counts()
    for k in kern.BF16_KERNELS:
        assert after[k.__name__] == before[k.__name__] + 1
    for k in kern.FP32_KERNELS:
        assert after[k.__name__] == before[k.__name__]


def test_bf16_kernels_are_deterministic(card):
    """Two calls of the bf16 path, forward (with split rows) and backward,
    give the same bits."""
    g, h, attn, bias = _hub_case(50_000)
    h16 = h.to(torch.bfloat16)
    kw = dict(seed=5, rate=0.3, negative_slope=0.2, eps=1e-16)
    first = kern.relgat_fwd_bf16(h16, attn, bias, g.csr, **kw)
    second = kern.relgat_fwd_bf16(h16, attn, bias, g.csr, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    gr = torch.randn_like(h)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    grads = []
    for _ in range(2):
        out = relgat_propagate_kernels(
            leaves[0].view(g.num_nodes, 16, 128), leaves[1], leaves[2], g.csr,
            attn_dropout_rate=0.3, dropout_seed=11, kernel_precision="default",
        )
        grads.append(torch.autograd.grad((out * gr.view_as(out)).sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_bf16_cuda_tensors_never_fall_back(card):
    """Each wrapper takes exactly its own row type: float16 rows, bf16 rows
    into an fp32 kernel and fp32 rows into a bf16 one all raise, and nothing
    launches."""
    g, h, gr, attn, bias = _case(2, 16)
    csr = g.csr
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    n, heads = h.shape[0], attn.shape[0]
    stats = [torch.ones((n, heads), device="cuda") for _ in range(3)]
    w = torch.zeros((n, heads, attn.shape[1]), device="cuda")
    b = torch.zeros((n, attn.shape[1]), device="cuda")
    before = kern.launch_counts()
    for rows in (h.half(), h):
        with pytest.raises(NotImplementedError):
            kern.relgat_fwd_bf16(rows, attn, bias, csr, **kw)
        with pytest.raises(NotImplementedError):
            kern.relgat_bwd_src_bf16(rows, rows, attn, *stats, gr.sum(1),
                                     csr, **kw)
        with pytest.raises(NotImplementedError):
            kern.relgat_bwd_rel_bf16(rows, w, b)
    h16 = h.to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        kern.relgat_fwd(h16, attn, bias, csr, **kw)
    with pytest.raises(NotImplementedError):
        kern.relgat_bwd_rel(h16, w, b)
    with pytest.raises(NotImplementedError):  # bf16 rows, fp32 attention
        kern.relgat_fwd_bf16(h16, attn.to(torch.bfloat16), bias, csr, **kw)
    assert kern.launch_counts() == before


def _rel_case(heads, feat, num_rel, n, seed=0):
    """bf16 h, and W and B of the magnitudes the src pass leaves."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = (torch.randn((n, heads * feat), generator=gen, device="cuda")
         * 0.5).to(torch.bfloat16)
    w = torch.randn((n, heads, num_rel), generator=gen, device="cuda") * 0.01
    b = torch.randn((n, num_rel), generator=gen, device="cuda")
    return h, w, b


@pytest.mark.parametrize("n", (0, 1, 511, 2_049, 25_008))
@pytest.mark.parametrize(
    "heads,feat,num_rel",
    [(1, 8, 7), (3, 40, 7), (16, 128, 40), (16, 128, 300), (12, 300, 40),
     (3, 301, 7), (16, 200, 40), (2, 1024, 7), (4, 32, 1)],
)
def test_bwd_rel_bf16_both_designs(card, heads, feat, num_rel, n):
    """relgat_bwd_rel_bf16 in each design, forced: the tensor cores (three
    exact bf16 products of W's split) and the SIMT tile kernel, within the
    bar of the float64 plain version and the same bits twice, at F = 301
    (one-value copies) and 300 (8-byte copies), R past one relation tile
    (300), n of no rows, one row, rows not a multiple of a stage and a shard
    layout's 25,008; forced launches count nowhere, the dispatch's once."""
    h, w, b = _rel_case(heads, feat, num_rel, n, seed=heads + feat + n)
    want = _exact(kern.relgat_bwd_rel_bf16_plain, h, w, b)
    before = kern.launch_counts()
    for design in kern.designs_of(kern.relgat_bwd_rel_bf16):
        one = kern.with_design(kern.relgat_bwd_rel_bf16, design, h, w, b)
        two = kern.with_design(kern.relgat_bwd_rel_bf16, design, h, w, b)
        for a, c in zip(one, two):
            assert torch.equal(a, c), design
        for a, c in zip(one, want):
            assert a.dtype == torch.float32 and a.shape == c.shape
            assert _rel(a, c) <= REL_TOL, design
    assert kern.launch_counts() == before
    with pytest.raises(ValueError, match="no design"):
        kern.with_design(kern.relgat_bwd_rel_bf16, "ring", h, w, b)
    got = kern.relgat_bwd_rel_bf16(h, w, b)
    design = kern.design_of(kern.relgat_bwd_rel_bf16, heads, feat)
    for a, c in zip(got, kern.with_design(kern.relgat_bwd_rel_bf16, design,
                                          h, w, b)):
        assert torch.equal(a, c)
    torch.cuda.synchronize()
    after = kern.launch_counts()
    assert after["relgat_bwd_rel_bf16"] == before["relgat_bwd_rel_bf16"] + 1


@pytest.mark.parametrize("design", ("tile", "mma"))
@pytest.mark.parametrize("kind", ("magnitudes", "nonfinite"))
def test_bwd_rel_bf16_extreme_w(card, design, kind):
    """W of magnitudes 1e-30 to 1e30 (random signs): within the bar of the
    float64 plain version; W with inf, -inf and NaN entries (one NaN whose
    payload lies in the low 16 bits, one inf against an h of 0): inf and
    NaN in the same entries as the plain version, the finite rest within
    the bar."""
    h, w, b = _rel_case(3, 40, 7, 2_049, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(5)
    if kind == "magnitudes":
        mag = 10.0 ** (torch.rand(w.shape, generator=gen, device="cuda") * 60
                       - 30)
        w = torch.sign(torch.randn(w.shape, generator=gen, device="cuda")) * mag
    else:
        w[5, 0, 1] = float("inf")
        w[7, 1, 2] = float("-inf")
        w[9, 2, 3] = float("nan")
        w[11, 0, 1] = float("-inf")
        w[13, 2, 4] = float("inf")
        w[15, 1, 5] = torch.tensor(0x7F800001, dtype=torch.int32).view(
            torch.float32)
        h[13, 2 * 40 + 3] = 0.0
    want = _exact(kern.relgat_bwd_rel_bf16_plain, h, w, b)[0]
    got = kern.with_design(kern.relgat_bwd_rel_bf16, design, h, w, b)[0]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)].float())
    fin = torch.isfinite(want)
    assert bool(fin.any())
    assert _rel(got[fin], want[fin]) <= REL_TOL


def _degree_case(heads, feat, num_rel=5, n=600, seed=0):
    """A graph whose rows have in- and out-degrees of 0, 1, 2 and 3, with
    self-loops, repeated (src, dst, relation) edges and one row of 700
    in-edges (split by the forward's work plan), in no sorted order."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for k in (1, 2, 3):  # rows 10k .. 10k + 9: k in-edges; 100 + ...: k out
        for r in range(10 * k, 10 * k + 10):
            dst += [r] * k
            src += list(rng.integers(200, n, k))
            src += [100 + r] * k
            dst += list(rng.integers(200, n, k))
    src += list(range(300, 340))          # self-loops
    dst += list(range(300, 340))
    src += [400, 400, 400, 401]           # multi-edges
    dst += [402, 402, 402, 403]
    src += list(rng.integers(200, n, 700))  # a split row
    dst += [450] * 700
    src, dst = np.array(src), np.array(dst)
    et = rng.integers(0, num_rel, src.size)
    et[-704:-700] = [1, 1, 1, 2]
    order = rng.permutation(src.size)
    g = build_graph(src[order], dst[order], et[order], n, num_rel=num_rel,
                    csr=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (g.num_nodes, heads * feat)
    h = torch.randn(shape, generator=gen, device="cuda") * 0.5
    gr = torch.randn(shape, generator=gen, device="cuda")
    attn = torch.randn((heads, num_rel, feat), generator=gen, device="cuda") * 0.3
    bias = torch.randn((num_rel,), generator=gen, device="cuda") * 0.1
    return g, h, gr, attn, bias


@pytest.mark.parametrize("heads,feat", [(16, 128), (12, 64), (5, 8)])
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_bf16_pair_kernels_on_small_degrees(card, heads, feat, rate):
    """The pair kernels on rows of 0 to 3 edges each way, self-loops,
    multi-edges and a split row: within 1e-5 of their float64 plain
    versions, rows without in-edges 0 (m = -inf), and the same bits over
    two calls."""
    g, h, gr, attn, bias = _degree_case(heads, feat)
    csr = g.csr
    assert csr.fwd_num_split == 1
    h16, g16 = h.to(torch.bfloat16), gr.to(torch.bfloat16)
    kw = dict(seed=77, rate=rate, negative_slope=0.2, eps=1e-16)
    fwd = [kern.relgat_fwd_bf16(h16, attn, bias, csr, **kw) for _ in range(2)]
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    out_k, m_k, l_k, b_k = fwd[0]
    out_p, m, l, b = _exact(kern.relgat_fwd_bf16_plain, h16, attn, bias, csr,
                            **kw)
    assert _rel(out_k, out_p) <= REL_TOL
    assert _rel(l_k, l) <= REL_TOL and _rel(b_k, b) <= REL_TOL
    indeg = torch.bincount(csr.dst.long(), minlength=g.num_nodes)
    assert bool((out_k[indeg == 0] == 0).all())
    assert bool(torch.isinf(m_k[indeg == 0]).all())
    n = h.shape[0]
    s_dot = ((out_k - b_k[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (h16, g16, attn, m_k, l_k, s_dot, gr.sum(1), csr)
    bwd = [kern.relgat_bwd_src_bf16(*args, **kw) for _ in range(2)]
    for a, b in zip(*bwd):
        assert torch.equal(a, b)
    dh_p, w_p, bb_p = _exact(kern.relgat_bwd_src_bf16_plain, *args, **kw)
    for got, want in zip(bwd[0], (dh_p, w_p, bb_p)):
        assert _rel(got, want) <= REL_TOL
    torch.cuda.synchronize()



def _offset_rows(x):
    """``x`` as bf16 rows that start one value past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=x.device)
    rows = buf[1:].view(x.shape)
    rows.copy_(x)
    return rows


@pytest.mark.parametrize("wrapper", ("relgat_fwd_bf16", "relgat_bwd_src_bf16"))
def test_a_kernel_whose_conditions_fail_is_refused(card, wrapper):
    """The pair kernel forced on bf16 rows one value off a 16-byte boundary:
    its entry point refuses it (cudaErrorInvalidValue, a RuntimeError from
    ``_raise_on``) and launches nothing in its place (the counters stay,
    and the next call on the stream runs). The dispatch on the same rows
    takes the template (``kernel_of``), within the bar of the float64
    plain version."""
    heads, feat = 16, 128
    g, h, gr, attn, bias = _case(heads, feat)
    csr = g.csr
    h16, g16 = _offset_rows(h), _offset_rows(gr)
    assert not kern.fused._aligned(h16)
    kw = dict(seed=77, rate=0.3, negative_slope=0.2, eps=1e-16)
    out, m, l, b = kern.relgat_fwd_bf16(h16, attn, bias, csr, **kw)
    n = h.shape[0]
    s_dot = ((out - b[:, None]) * gr).view(n, heads, feat).sum(-1)
    args, plain = {
        "relgat_fwd_bf16": ((h16, attn, bias, csr),
                            kern.relgat_fwd_bf16_plain),
        "relgat_bwd_src_bf16": ((h16, g16, attn, m, l, s_dot, gr.sum(1), csr),
                                kern.relgat_bwd_src_bf16_plain),
    }[wrapper]
    w = getattr(kern, wrapper)
    assert kern.kernel_of(w, heads, feat, attn.shape[1], aligned=True) == "pair"
    assert kern.kernel_of(w, heads, feat, attn.shape[1],
                          aligned=False) == "lanes"
    torch.cuda.synchronize()
    kern.reset_design_counts()
    before = kern.launch_counts()
    with pytest.raises(RuntimeError,
                       match=f"{wrapper}: CUDA launch failed with error code 1"):
        kern.with_design(w, "pair", *args, **kw)
    torch.cuda.synchronize()
    assert kern.launch_counts() == before and kern.design_counts() == {}
    got = w(*args, **kw)
    assert kern.design_counts()[f"{wrapper}/lanes"] == 1
    want = _exact(plain, *args, **kw)
    # the forward's out, l and bias (m is -inf on rows without in-edges)
    keep = (0, 2, 3) if wrapper == "relgat_fwd_bf16" else (0, 1, 2)
    for i in keep:
        assert _rel(got[i], want[i]) <= REL_TOL
    torch.cuda.synchronize()

def test_feature_limit_is_named(card):
    """A head of 1024 features runs; one of 1025 is refused, naming the
    limit, and launches nothing."""
    for feat in (1024, 1025):
        g, h, _, attn, bias = _case(1, feat, n=100, e=300)
        kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
        before = kern.launch_counts()
        if feat == 1024:
            out = kern.relgat_fwd(h, attn, bias, g.csr, **kw)[0]
            assert bool(torch.isfinite(out).all())
        else:
            with pytest.raises(ValueError, match="limit of 1024"):
                kern.relgat_fwd(h, attn, bias, g.csr, **kw)
            with pytest.raises(ValueError, match="limit of 1024"):
                kern.relgat_fwd_bf16(h.to(torch.bfloat16), attn, bias, g.csr,
                                     **kw)
            assert kern.launch_counts() == before
    torch.cuda.synchronize()


def test_rows_without_edges_are_zero(card):
    g, h, _, attn, bias = _case(4, 32)
    out, m, l, b = kern.relgat_fwd(h, attn, bias, g.csr, seed=None, rate=0.0,
                                   negative_slope=0.2, eps=1e-16)
    assert bool((out[:40] == 0).all()) and bool((l[:40] == 0).all())
    assert bool(torch.isfinite(out).all())


def test_backward_is_deterministic(card):
    g, h, gr, attn, bias = _case(16, 128, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    grads = []
    for _ in range(2):
        out = relgat_propagate_kernels(
            leaves[0].view(g.num_nodes, 16, 128), leaves[1], leaves[2], g.csr,
            attn_dropout_rate=0.3, dropout_seed=11,
        )
        grads.append(torch.autograd.grad((out * gr.view_as(out)).sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_plain_propagate_is_deterministic(card):
    """The plain route (``use_pallas=False``, the gspmd route's) gives the
    same bits twice, forward and backward, and its segment sum is the
    float64 one within the bar."""
    from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
    from relgat_projector_tpu_torch.ops.segment import segment_sum

    g, h, gr, attn, bias = _case(16, 128, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    runs = []
    for _ in range(2):
        out = relgat_propagate(
            leaves[0].view(g.num_nodes, 16, 128), leaves[1], leaves[2],
            g.src, g.dst, g.etype, num_nodes=g.num_nodes,
            attn_dropout_rate=0.3, dropout_seed=11,
        )
        runs.append((out.detach(), *torch.autograd.grad(
            (out * gr.view_as(out)).sum(), leaves)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    rows = h[g.src]
    want = torch.zeros((g.num_nodes, h.shape[1]), dtype=torch.float64,
                       device=card).index_add_(0, g.dst, rows.double())
    assert _rel(segment_sum(rows, g.dst, g.num_nodes), want) <= REL_TOL


def test_cuda_tensors_never_fall_back(card):
    g, h, gr, attn, bias = _case(2, 16)
    with pytest.raises(NotImplementedError):
        kern.relgat_fwd(h.double(), attn.double(), bias.double(), g.csr,
                        seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    with pytest.raises(ValueError):
        kern.relgat_fwd(h[:, :-1].contiguous(), attn, bias, g.csr, seed=None,
                        rate=0.0, negative_slope=0.2, eps=1e-16)


def _hub_case(degree, heads=16, feat=128, num_rel=40, n=3000, e=30_000):
    """A uniform graph and one row (77) with ``degree`` in-edges."""
    rng = np.random.default_rng(degree)
    src = rng.integers(0, n, e + degree)
    dst = np.concatenate([rng.integers(100, n, e), np.full(degree, 77)])
    et = rng.integers(0, num_rel, e + degree)
    g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(degree)
    h = torch.randn((g.num_nodes, heads * feat), generator=gen,
                    device="cuda") * 0.5
    attn = torch.randn((heads, num_rel, feat), generator=gen,
                       device="cuda") * 0.1
    bias = torch.randn((num_rel,), generator=gen, device="cuda") * 0.1
    return g, h, attn, bias


@pytest.mark.parametrize(
    "degree", (FWD_ITEM_EDGES, FWD_ITEM_EDGES + 1, 50_000))
def test_split_rows_match_plain(card, degree):
    g, h, attn, bias = _hub_case(degree)
    csr = g.csr
    assert int(np.diff(csr.dst_ptr.cpu().numpy())[77]) == degree
    assert csr.fwd_num_split == (degree > FWD_ITEM_EDGES)
    kw = dict(seed=-987654321, rate=0.3, negative_slope=0.2, eps=1e-16)
    out_k, m_k, l_k, b_k = kern.relgat_fwd(h, attn, bias, csr, **kw)
    out_p, m, l, b = _exact(kern.relgat_fwd_plain, h, attn, bias, csr, **kw)
    assert _rel(out_k, out_p) <= REL_TOL
    assert _rel(out_k[77], out_p[77]) <= REL_TOL
    assert _rel(l_k, l) <= REL_TOL and _rel(b_k, b) <= REL_TOL
    fin = torch.isfinite(m)
    assert torch.equal(torch.isfinite(m_k), fin)
    assert _rel(m_k[fin], m[fin]) <= REL_TOL


def test_forward_is_deterministic(card):
    g, h, attn, bias = _hub_case(50_000)
    kw = dict(seed=5, rate=0.3, negative_slope=0.2, eps=1e-16)
    first = kern.relgat_fwd(h, attn, bias, g.csr, **kw)
    second = kern.relgat_fwd(h, attn, bias, g.csr, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads,feat",
                         [(12, 300), (3, 301), (16, 200), (2, 1024)])
@pytest.mark.parametrize("bf16", (False, True))
def test_wide_heads_both_designs(card, heads, feat, bf16):
    """At F > 128 the forward and src pass each run the ring kernel or the
    one-warp-a-head template, by width. On a graph with a split row (1,000
    in-edges) and dropout, the dispatch gives the same bits twice; each
    design, forced, is within the bar of the float64 plain version; forced
    launches count nowhere."""
    g, h, attn, bias = _hub_case(1_000, heads=heads, feat=feat, n=600,
                                 e=6_000)
    csr = g.csr
    assert csr.fwd_num_split == 1
    gr = torch.randn_like(h)
    rows_h, rows_g = ((h.to(torch.bfloat16), gr.to(torch.bfloat16)) if bf16
                      else (h, gr))
    fwd, bwd_src = ((kern.relgat_fwd_bf16, kern.relgat_bwd_src_bf16) if bf16
                    else (kern.relgat_fwd, kern.relgat_bwd_src))
    fwd_plain, src_plain = (
        (kern.relgat_fwd_bf16_plain, kern.relgat_bwd_src_bf16_plain) if bf16
        else (kern.relgat_fwd_plain, kern.relgat_bwd_src_plain))
    kw = dict(seed=-987654321, rate=0.3, negative_slope=0.2, eps=1e-16)
    before = kern.launch_counts()
    out = [fwd(rows_h, attn, bias, csr, **kw) for _ in range(2)]
    forced = {d: kern.with_design(fwd, d, rows_h, attn, bias, csr, **kw)
              for d in ("lanes", "ring")}
    want = _exact(fwd_plain, rows_h, attn, bias, csr, **kw)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    for got in forced.values():
        assert _rel(got[0], want[0]) <= REL_TOL
        assert _rel(got[2], want[2]) <= REL_TOL
    _, m, l, b = out[0]
    n = h.shape[0]
    s_dot = ((out[0][0] - b[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (rows_h, rows_g, attn, m, l, s_dot, gr.sum(1), csr)
    src = [bwd_src(*args, **kw) for _ in range(2)]
    forced = {d: kern.with_design(bwd_src, d, *args, **kw)
              for d in ("lanes", "ring")}
    want = _exact(src_plain, *args, **kw)
    for a, b in zip(*src):
        assert torch.equal(a, b)
    for got in forced.values():
        for a, b in zip(got, want):
            assert _rel(a, b) <= REL_TOL
    torch.cuda.synchronize()
    after = kern.launch_counts()
    assert after[fwd.__name__] == before[fwd.__name__] + 2
    assert after[bwd_src.__name__] == before[bwd_src.__name__] + 2


def _out_hub_case(heads, feat, degree=3 * BWD_ITEM_EDGES + 5, num_rel=7,
                  n=600, e=6_000):
    """A uniform graph whose row 77 has ``degree`` out-edges (the src pass
    splits it), attention inputs and the forward's statistics."""
    rng = np.random.default_rng(degree + heads)
    src = rng.integers(0, n, e)
    src[src == 77] = 78
    src = np.concatenate([src, np.full(degree, 77)])
    dst = rng.integers(0, n, e + degree)
    et = rng.integers(0, num_rel, e + degree)
    g = build_graph(src, dst, et, n, num_rel=num_rel, csr=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(degree)
    shape = (g.num_nodes, heads * feat)
    h = torch.randn(shape, generator=gen, device="cuda") * 0.5
    gr = torch.randn(shape, generator=gen, device="cuda")
    attn = torch.randn((heads, num_rel, feat), generator=gen,
                       device="cuda") * 0.3
    bias = torch.randn((num_rel,), generator=gen, device="cuda") * 0.1
    return g, h, gr, attn, bias


@pytest.mark.parametrize("heads,feat", [(16, 128), (3, 128), (4, 32), (3, 40),
                                        (12, 300), (16, 200), (4, 512),
                                        (3, 301)])
@pytest.mark.parametrize("bf16", (False, True))
def test_bwd_src_split_rows_every_design(card, heads, feat, bf16):
    """A source row of 3K + 5 out-edges, split into chunks: the src pass
    (the template, the bf16 pair kernel, past 128 features both the ring
    and the template, forced) within the bar of its float64 plain version
    with dropout 0.3, the same bits twice, one launch a call with the
    merge; and on every row that no plan splits the same bits as with a
    plan of one item a row."""
    g, h, gr, attn, bias = _out_hub_case(heads, feat)
    csr = g.csr
    outdeg = np.diff(csr.src_ptr.cpu().numpy())
    assert outdeg[77] == 3 * BWD_ITEM_EDGES + 5 and csr.bwd_num_split == 1
    fwd, bwd_src, src_plain = (
        (kern.relgat_fwd_bf16, kern.relgat_bwd_src_bf16,
         kern.relgat_bwd_src_bf16_plain) if bf16 else
        (kern.relgat_fwd, kern.relgat_bwd_src, kern.relgat_bwd_src_plain))
    rows_h, rows_g = ((h.to(torch.bfloat16), gr.to(torch.bfloat16)) if bf16
                      else (h, gr))
    kw = dict(seed=-987654321, rate=0.3, negative_slope=0.2, eps=1e-16)
    out, m, l, b = fwd(rows_h, attn, bias, csr, **kw)
    n = h.shape[0]
    s_dot = ((out - b[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (rows_h, rows_g, attn, m, l, s_dot, gr.sum(1))
    before = kern.launch_counts()[bwd_src.__name__]
    first = bwd_src(*args, csr, **kw)
    second = bwd_src(*args, csr, **kw)
    torch.cuda.synchronize()
    assert kern.launch_counts()[bwd_src.__name__] == before + 2
    want = _exact(src_plain, *args, csr, **kw)
    for a, b_, c in zip(first, second, want):
        assert torch.equal(a, b_)
        assert _rel(a, c) <= REL_TOL
        assert _rel(a[77], c[77]) <= REL_TOL
    designs = ([d for d in kern.designs_of(bwd_src) if d != "pair"]
               if feat > 128 else ())
    for d in designs:
        for a, c in zip(kern.with_design(bwd_src, d, *args, csr, **kw), want):
            assert _rel(a, c) <= REL_TOL
    whole = with_bwd_plan(csr, int(outdeg.max()))
    assert whole.bwd_num_split == 0
    keep = torch.from_numpy(outdeg <= BWD_ITEM_EDGES).cuda()
    for a, c in zip(first, bwd_src(*args, whole, **kw)):
        assert torch.equal(a[keep], c[keep])
        assert _rel(a[~keep], c[~keep]) <= REL_TOL


@pytest.mark.parametrize("heads,feat,num_rel", [
    (12, 256, 7), (12, 300, 7), (16, 200, 7), (20, 136, 7), (2, 1024, 7),
    (12, 256, 100), (12, 300, 100), (2, 1024, 100)])
def test_bf16_ring_src_factored(card, heads, feat, num_rel):
    """The bf16 ring src pass (logits by (src row, relation), the loop,
    the merge, then W attn added into dh), taken by the dispatch on a graph
    dense enough for ``ring_src_loop``, with a split source row and dropout
    0.3: within the bar of the float64 plain version, the same bits twice,
    and no device memory past dh, W and B (the logits P live in W's
    buffer). At 100 relations (``zipf-inv-10m``'s) the logits kernel takes
    them in groups and the fold in 13 stages."""
    assert kern.design_of(kern.relgat_bwd_src_bf16, heads, feat) == "ring"
    g, h, gr, attn, bias = _out_hub_case(
        heads, feat, num_rel=num_rel, e=12_000 if num_rel < 50 else 30_000)
    csr = g.csr
    assert csr.bwd_num_split == 1
    n = h.shape[0]
    assert kern.ring_src_loop(csr.num_edges, n, num_rel) == "factored"
    kw = dict(seed=-987654321, rate=0.3, negative_slope=0.2, eps=1e-16)
    rows_h, rows_g = h.to(torch.bfloat16), gr.to(torch.bfloat16)
    out, m, l, b = kern.relgat_fwd_bf16(rows_h, attn, bias, csr, **kw)
    s_dot = ((out - b[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (rows_h, rows_g, attn, m, l, s_dot, gr.sum(1), csr)
    del out
    kern.reset_design_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count = torch.cuda.memory_stats()["allocation.all.allocated"]
    base = torch.cuda.memory_allocated()
    first = kern.relgat_bwd_src_bf16(*args, **kw)
    torch.cuda.synchronize()
    # three allocations (dh, W, B), none freed before the end, so the peak
    # is what the outputs hold: their bytes, each block rounded up by the
    # caching allocator (to 512 bytes, or a remainder under 1 MB unsplit)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == count + 3
    assert torch.cuda.max_memory_allocated() == torch.cuda.memory_allocated()
    rows = n + csr.bwd_num_parts
    outputs = 4 * rows * (heads * feat + heads * num_rel + num_rel)
    assert torch.cuda.memory_allocated() - base < outputs + 3 * 2**20
    assert kern.ring_loop_counts() == {"factored": 1}
    second = kern.relgat_bwd_src_bf16(*args, **kw)
    want = _exact(kern.relgat_bwd_src_bf16_plain, *args, **kw)
    for a, b_, c in zip(first, second, want):
        assert torch.equal(a, b_)
        assert _rel(a, c) <= REL_TOL
        assert _rel(a[77], c[77]) <= REL_TOL


@pytest.mark.parametrize("edges", (2_000, 30_000))
def test_bf16_ring_src_loop_follows_the_density(card, edges):
    """At 12 x 256 the bf16 src pass's ring takes the per-edge loop on a
    sparse graph and the factored one on a dense graph (``ring_src_loop``):
    the dispatch gives the bits of that loop forced, counts one ring launch
    of that loop, and both loops are within the bar of the float64 plain
    version."""
    heads, feat = 12, 256
    g, h, gr, attn, bias = _out_hub_case(heads, feat, e=edges)
    csr = g.csr
    n, num_rel = h.shape[0], attn.shape[1]
    loop = kern.ring_src_loop(csr.num_edges, n, num_rel)
    assert loop == ("factored" if edges > 10_000 else "per_edge")
    kw = dict(seed=-987654321, rate=0.3, negative_slope=0.2, eps=1e-16)
    rows_h, rows_g = h.to(torch.bfloat16), gr.to(torch.bfloat16)
    out, m, l, b = kern.relgat_fwd_bf16(rows_h, attn, bias, csr, **kw)
    s_dot = ((out - b[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (rows_h, rows_g, attn, m, l, s_dot, gr.sum(1), csr)
    kern.reset_design_counts()
    got = kern.relgat_bwd_src_bf16(*args, **kw)
    torch.cuda.synchronize()
    assert kern.ring_loop_counts() == {loop: 1}
    assert kern.design_counts()["relgat_bwd_src_bf16/ring"] == 1
    want = _exact(kern.relgat_bwd_src_bf16_plain, *args, **kw)
    forced = {d: kern.with_design(kern.relgat_bwd_src_bf16, d, *args, **kw)
              for d in ("ring", "ring_per_edge")}
    same = forced["ring" if loop == "factored" else "ring_per_edge"]
    for a, b_ in zip(got, same):
        assert torch.equal(a, b_)
    for outs in forced.values():
        for a, c in zip(outs, want):
            assert _rel(a, c) <= REL_TOL
    assert kern.ring_loop_counts() == {loop: 1}


def test_bwd_src_small_items_match_plain(card):
    """Items of 5 edges split most rows of a uniform graph, rows without
    out-edges stay whole: fp32 and bf16 against the float64 plain version;
    the merge writes the split rows' W and B too."""
    g, h, gr, attn, bias = _out_hub_case(16, 128, degree=50, e=3_000)
    csr = with_bwd_plan(g.csr, 5)
    assert csr.bwd_num_split > 100
    kw = dict(seed=11, rate=0.3, negative_slope=0.2, eps=1e-16)
    for bf16 in (False, True):
        fwd, bwd_src, src_plain = (
            (kern.relgat_fwd_bf16, kern.relgat_bwd_src_bf16,
             kern.relgat_bwd_src_bf16_plain) if bf16 else
            (kern.relgat_fwd, kern.relgat_bwd_src, kern.relgat_bwd_src_plain))
        rows_h, rows_g = ((h.to(torch.bfloat16), gr.to(torch.bfloat16))
                          if bf16 else (h, gr))
        out, m, l, b = fwd(rows_h, attn, bias, csr, **kw)
        s_dot = ((out - b[:, None]) * gr).view(h.shape[0], 16, 128).sum(-1)
        args = (rows_h, rows_g, attn, m, l, s_dot, gr.sum(1), csr)
        for a, c in zip(bwd_src(*args, **kw), _exact(src_plain, *args, **kw)):
            assert _rel(a, c) <= REL_TOL


def test_split_path_never_falls_back(card):
    g, h, attn, bias = _hub_case(3 * FWD_ITEM_EDGES + 5, heads=2, feat=16)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    before = kern.relgat_fwd.launches
    out, _, _, _ = kern.relgat_fwd(h, attn, bias, g.csr, **kw)
    torch.cuda.synchronize()
    assert out.is_cuda and kern.relgat_fwd.launches == before + 1
    # a plan whose items outgrow the kernel's edge table is refused
    wide = 2 * FWD_ITEM_EDGES
    items, merge = build_fwd_plan(g.csr.dst_ptr.cpu().numpy(), wide)
    csr = dataclasses.replace(
        g.csr,
        fwd_items=torch.from_numpy(items.astype(np.int32)).cuda(),
        fwd_merge=torch.from_numpy(merge.astype(np.int32)).cuda(),
        fwd_item_edges=wide, fwd_num_parts=int(merge[-1, 2]),
    )
    with pytest.raises(ValueError, match="edge table"):
        kern.relgat_fwd(h, attn, bias, csr, **kw)
    assert kern.relgat_fwd.launches == before + 1


def test_bwd_src_limits_relations_to_shared_memory(card):
    heads, feat = 16, 8
    limit = kern.max_num_rel(heads)
    for num_rel in (limit, limit + 1):
        g, h, gr, attn, _ = _case(heads, feat, num_rel=num_rel, n=100, e=300)
        n = h.shape[0]
        stats = [torch.zeros((n, heads), device="cuda") for _ in range(3)]
        args = (h, gr, attn, *stats, gr.sum(1), g.csr)
        kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
        if num_rel == limit:
            _, w, _ = kern.relgat_bwd_src(*args, **kw)
            assert tuple(w.shape) == (n, heads, limit)
        else:
            with pytest.raises(ValueError, match=f"limit of {limit}"):
                kern.relgat_bwd_src(*args, **kw)
    torch.cuda.synchronize()


def test_trainer_runs_every_step_through_the_kernels(card, tmp_path):
    """A tiny trainer on the card: one relgat_fwd per layer per train step
    and per evaluation, one of each backward kernel per layer per step."""
    layers, steps_per_eval = 2, 4
    kg = generate_synthetic_kg(num_nodes=400, num_edges=3000, num_rel=5,
                               emb_dim=32, seed=1)
    run = RunConfig(
        model=ModelConfig(in_dim=32, num_rel=5, gat_out_dim=16, gat_heads=4,
                          gat_num_layers=layers, dropout=0.3,
                          rel_attn_dropout=0.2, projection_layers=2,
                          use_pallas=True),
        train=TrainConfig(epochs=1, train_batch_size=128, num_neg=8,
                          eval_every_n_steps=steps_per_eval,
                          save_every_n_steps=steps_per_eval,
                          log_every_n_steps=5, out_dir=str(tmp_path)),
    )
    from relgat_projector_tpu_torch.train.trainer import RelGATTrainer

    trainer = RelGATTrainer(run, *kg, log_to_console=False, device="cuda")
    steps = trainer.dataset.steps_per_epoch(128)
    evals = steps // steps_per_eval
    kern.reset_launch_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    assert counts["relgat_fwd"] == layers * (steps + evals)
    assert counts["relgat_bwd_src"] == counts["relgat_bwd_rel"] == layers * steps
    assert int(trainer.state.step) + int(trainer.state.nonfinite_steps) == steps


def _card_step(card, **model):
    """A small model on ``card`` with dropout on (``model`` overrides the
    config): (config, train config, train step, state, embeddings, graph,
    batch, the graph's host arrays)."""
    from relgat_projector_tpu_torch.models.model import init_model
    from relgat_projector_tpu_torch.schedules import make_lr_schedule
    from relgat_projector_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )
    from relgat_projector_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(5)
    n, e, r, d, b = 2_000, 20_000, 8, 64, 64
    coo = (rng.integers(0, n, e), rng.integers(0, n, e), rng.integers(0, r, e))
    g = build_graph(*coo, n, num_rel=r, csr=True, device=card)
    cfg = ModelConfig(**{
        "in_dim": d, "num_rel": r, "gat_out_dim": 32, "gat_heads": 4,
        "gat_num_layers": 2, "dropout": 0.3, "rel_attn_dropout": 0.2,
        "projection_layers": 2, "projection_dropout": 0.3,
        "use_pallas": True, **model})
    tc = TrainConfig(train_batch_size=b, num_neg=8, lr=1e-3,
                     lr_scheduler="constant", warmup_steps=0)
    sched = make_lr_schedule(tc.lr, "constant", 10, 0)
    opt = make_optimizer(tc, sched)
    state = create_train_state(init_model(cfg, seed=1, device=card), opt,
                               seed=2)
    x = torch.randn((g.num_nodes, d),
                    generator=torch.Generator().manual_seed(3)).to(card)
    batch = [torch.from_numpy(rng.integers(0, k, b)).to(card)
             for k in (n, r, n)] + [torch.ones(b, device=card)]
    step = make_train_step(cfg, tc, opt, sched)
    return cfg, tc, step, state, x, g, batch, coo


def _card_leaves(state):
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu))


def test_remat_gives_the_same_bits_on_the_card(card):
    """Two steps with dropout on, remat against none: the same bits and the
    same generator states; relgat_fwd launches twice a layer a step under
    remat (the recompute), the backward kernels once."""
    ends = {}
    for remat in (False, True):
        _, _, step, state, x, g, batch, _ = _card_step(card, remat=remat)
        kern.reset_launch_counts()
        for _ in range(2):
            state, _ = step(state, x, g, *batch)
        torch.cuda.synchronize()
        counts = kern.launch_counts()
        assert counts["relgat_fwd"] == 2 * 2 * (2 if remat else 1)
        assert counts["relgat_bwd_src"] == counts["relgat_bwd_rel"] == 4
        ends[remat] = state
    for a, b in zip(_card_leaves(ends[False]), _card_leaves(ends[True])):
        assert torch.equal(a, b)
    for name in ("host", "device"):
        assert torch.equal(getattr(ends[False].rng, name).get_state(),
                           getattr(ends[True].rng, name).get_state())


@pytest.mark.parametrize("mode", [
    {}, dict(compute_dtype="bfloat16", kernel_precision="default"),
    dict(remat=True)], ids=("fp32", "bf16", "remat"))
def test_device_time_by_span_covers_the_trace(card, mode):
    """Two steps under ``torch.profiler``: the spans' device time and the
    unattributed rest sum to the trace's device time within 0.5%; every
    kernel named ``relgat`` falls under ``relgat/propagate`` (the remat
    recompute's too), every GEMM under the projections, the head or the
    scorer; every idle gap has a span or lies outside the step."""
    from relgat_projector_tpu_torch.utils import profiling

    _, _, step, state, x, g, batch, _ = _card_step(card, **mode)
    state, _ = step(state, x, g, *batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            state, _ = step(state, x, g, *batch)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA") / 1e6
    by_span = profiling.device_time_by_span(prof)
    assert abs(sum(by_span.values()) - total) <= 5e-3 * total
    ops = profiling.device_ops(prof)
    kernels = [o for o in ops if "relgat" in o.name.lower()]
    assert kernels and {o.span for o in kernels} == {"relgat/propagate"}
    gemms = [o for o in ops if any(k in o.name.lower() for k in
                                   ("gemm", "cutlass", "sm90_", "nvjet"))]
    assert gemms and {o.span for o in gemms} <= {
        "relgat/project", "relgat/head", "relgat/score"}
    assert {o.phase for o in kernels} == {"forward", "backward"}
    assert set(profiling.idle_by_span(prof)) <= {
        "relgat/step", "relgat/forward", "relgat/backward",
        "relgat/optimizer", profiling.OUTSIDE_STEP} | {o.span for o in ops}


def test_scan_segments_gives_the_same_bits_on_the_card(card):
    ends = []
    for segments in (0, 4):
        _, _, step, state, x, g, batch, _ = _card_step(
            card, scan_segments=segments)
        for _ in range(2):
            state, _ = step(state, x, g, *batch)
        ends.append(state)
    for a, b in zip(*map(_card_leaves, ends)):
        assert torch.equal(a, b)


def test_bf16_parameter_step_on_the_kernel_route(card):
    """bf16 parameters in the bf16 mode: one step through the bf16 kernels
    keeps every parameter and moment bf16, and its loss is within 1e-2 of
    the same forward's through the plain route on a CPU copy."""
    from relgat_projector_tpu_torch.models.model import single_gat_step
    from relgat_projector_tpu_torch.train.step import score_batch
    from relgat_projector_tpu_torch.utils.tree import tree_map

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16",
                kernel_precision="default", dropout=0.0,
                rel_attn_dropout=0.0, projection_dropout=0.0)
    cfg, tc, step, state, x, g, batch, coo = _card_step(card, **bf16)
    neg = torch.randint(0, g.num_real_nodes, (64, 8),
                        generator=torch.Generator().manual_seed(4))
    host_params = tree_map(lambda t: t.cpu(), state.params)
    kern.reset_launch_counts()
    state, m = step(state, x, g, *batch, neg_dst=neg.to(card))
    torch.cuda.synchronize()
    assert kern.launch_counts()["relgat_fwd_bf16"] == 2
    assert {t.dtype for t in _card_leaves(state)} == {torch.bfloat16}
    g_cpu = build_graph(*coo, g.num_real_nodes, num_rel=cfg.num_rel,
                        device="cpu")
    cpu_cfg = dataclasses.replace(cfg, use_pallas=False)
    with torch.no_grad():
        xs = single_gat_step(host_params, cpu_cfg, x.cpu(), g_cpu)
        loss, _ = score_batch(host_params, cpu_cfg, tc, xs,
                              g_cpu.num_real_nodes,
                              *(t.cpu() for t in batch), neg_dst=neg)
    assert abs(float(m["loss"]) - float(loss)) <= 1e-2 * abs(float(loss))


def test_fp16_product_on_the_card(card):
    """``compute_matmul`` in fp16 on the card (one tensor-core product with
    an fp32 output) against the float64 product of the fp16-rounded
    operands, within the repo's kernel bar of 1e-5 of the largest value
    (the tensor cores' fp32 sums measured 1.8e-6 here, the CPU's 5.5e-7),
    never rounded to fp16; the gradients rounded to fp16 on the card and
    on the CPU, within one fp16 step of each other."""
    from relgat_projector_tpu_torch.device import (
        compute_matmul,
        set_matmul_precision,
    )

    set_matmul_precision()
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((512, 1152), generator=gen)
    w = torch.randn((1152, 384), generator=gen) * 0.05
    gr = torch.randn((512, 384), generator=gen)
    out = []
    for dev in ("cpu", card):
        xd = x.to(dev).detach().requires_grad_(True)
        wd = w.to(dev).detach().requires_grad_(True)
        y = compute_matmul(xd, wd, torch.float16)
        y.backward(gr.to(dev))
        out.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
    (_, dx_cpu, dw_cpu), (y, dx, dw) = out
    assert y.dtype == torch.float32
    assert not torch.equal(y, y.half().float())
    assert _rel(y, x.half().double() @ w.half().double()) <= REL_TOL
    for got, want in ((dx, dx_cpu), (dw, dw_cpu)):
        assert torch.equal(got, got.half().float())
        assert _rel(got, want) <= 2.0 ** -10


def test_fp16_compute_step_on_the_kernel_route(card):
    """fp16 projections with fp32 parameters: one step launches the fp32
    kernels (``h`` is the fp32 product) and its loss is within 1e-2 of the
    same forward's through the plain route on a CPU copy."""
    from relgat_projector_tpu_torch.models.model import single_gat_step
    from relgat_projector_tpu_torch.train.step import score_batch
    from relgat_projector_tpu_torch.utils.tree import tree_map

    fp16 = dict(compute_dtype="float16", dropout=0.0, rel_attn_dropout=0.0,
                projection_dropout=0.0)
    cfg, tc, step, state, x, g, batch, coo = _card_step(card, **fp16)
    neg = torch.randint(0, g.num_real_nodes, (64, 8),
                        generator=torch.Generator().manual_seed(4))
    host_params = tree_map(lambda t: t.cpu(), state.params)
    kern.reset_launch_counts()
    state, m = step(state, x, g, *batch, neg_dst=neg.to(card))
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    assert counts["relgat_fwd"] == 2 and counts["relgat_fwd_bf16"] == 0
    assert {t.dtype for t in _card_leaves(state)} == {torch.float32}
    g_cpu = build_graph(*coo, g.num_real_nodes, num_rel=cfg.num_rel,
                        device="cpu")
    cpu_cfg = dataclasses.replace(cfg, use_pallas=False)
    with torch.no_grad():
        xs = single_gat_step(host_params, cpu_cfg, x.cpu(), g_cpu)
        loss, _ = score_batch(host_params, cpu_cfg, tc, xs,
                              g_cpu.num_real_nodes,
                              *(t.cpu() for t in batch), neg_dst=neg)
    assert abs(float(m["loss"]) - float(loss)) <= 1e-2 * abs(float(loss))


def test_serving_through_the_kernels(card, tmp_path):
    """``export_node_representations`` on the card (one relgat_fwd per
    layer, no backward kernel) agrees with the same call on a CPU copy
    within 1e-4, and a reference round trip (``export_torch_checkpoint_dir``
    -> ``import_torch_checkpoint_dir`` -> ``load_from_pretrained``) gives
    the same bits."""
    from relgat_projector_tpu_torch.inference import (
        export_node_representations,
    )
    from relgat_projector_tpu_torch.interop import (
        export_torch_checkpoint_dir,
        import_torch_checkpoint_dir,
    )
    from relgat_projector_tpu_torch.models.model import (
        load_from_pretrained,
        save_pretrained,
    )
    from relgat_projector_tpu_torch.utils.tree import tree_map

    cfg, _, _, state, x, g, _, coo = _card_step(card)
    kern.reset_launch_counts()
    rep = export_node_representations(state.params, cfg, x, g)
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    assert counts["relgat_fwd"] == cfg.gat_num_layers
    assert counts["relgat_bwd_src"] == counts["relgat_bwd_rel"] == 0
    g_cpu = build_graph(*coo, g.num_real_nodes, num_rel=cfg.num_rel,
                        csr=True, device="cpu")
    rep_cpu = export_node_representations(
        tree_map(lambda t: t.cpu(), state.params), cfg, x.cpu(), g_cpu)
    assert _rel(rep.cpu(), rep_cpu) <= 1e-4

    save_pretrained(str(tmp_path / "port"), state.params, cfg)
    export_torch_checkpoint_dir(str(tmp_path / "port"), str(tmp_path / "ref"),
                                device=card)
    import_torch_checkpoint_dir(str(tmp_path / "ref"), str(tmp_path / "back"),
                                device=card)
    params, back_cfg = load_from_pretrained(str(tmp_path / "back"),
                                            node_emb=x, device=card)
    back = export_node_representations(
        params, dataclasses.replace(back_cfg, use_pallas=True), x, g)
    assert torch.equal(back, rep)


def _subset(num_src, num_dst, e, seed, device):
    """A halo subset's layout: ``num_src`` source rows, ``num_dst``
    destination rows (the last 5 without in-edges, one heavy row the
    forward splits), canonical ids that are not positions."""
    from relgat_projector_tpu_torch.data.csr import build_csr_graph

    rng = np.random.default_rng(seed)
    dst = np.sort(np.concatenate([rng.integers(0, num_dst - 5, e),
                                  np.full(FWD_ITEM_EDGES + 9, 3)]))
    src = rng.integers(0, num_src, dst.shape[0])
    et = rng.integers(0, 7, dst.shape[0])
    eid = rng.permutation(4 * dst.shape[0])[:dst.shape[0]]
    return build_csr_graph(src, dst, et, num_dst, 7, device,
                           num_src=num_src, eid=eid)


@pytest.mark.parametrize("num_src,num_dst", [(900, 300), (200, 500)])
@pytest.mark.parametrize("bf16", (False, True))
def test_split_kernels_take_a_source_space(card, num_src, num_dst, bf16):
    """Source rows apart from destination rows and canonical edge ids: the
    forward and both backward kernels against their plain versions, with
    attention dropout 0.3, and the same bits twice."""
    heads, feat = 16, 128
    csr = _subset(num_src, num_dst, 4000, 1, card)
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((num_src, heads * feat), generator=gen, device=card)
    g = torch.randn((num_dst, heads * feat), generator=gen, device=card)
    attn = torch.randn((heads, 7, feat), generator=gen, device=card) * 0.3
    bias = torch.randn((7,), generator=gen, device=card) * 0.1
    kw = dict(seed=99, rate=0.3, negative_slope=0.2, eps=1e-16)
    rows = h.to(torch.bfloat16) if bf16 else h
    grows = g.to(torch.bfloat16) if bf16 else g
    fwd, bwd_src, bwd_rel = (
        (kern.relgat_fwd_bf16, kern.relgat_bwd_src_bf16,
         kern.relgat_bwd_rel_bf16) if bf16
        else (kern.relgat_fwd, kern.relgat_bwd_src, kern.relgat_bwd_rel))
    got = fwd(rows, attn, bias, csr, **kw)
    assert all(torch.equal(a, b) for a, b in
               zip(got, fwd(rows, attn, bias, csr, **kw)))
    want = _exact(kern.relgat_fwd_plain, rows.float(), attn, bias, csr, **kw)
    for a, b in zip(got, want):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert _rel(a[fin], b[fin]) <= REL_TOL
    out, m, l, b = got
    assert torch.isinf(m[-5:]).all() and (l[-5:] == 0).all()
    assert (out[-5:] == 0).all()
    s_dot = ((out - b[:, None]) * g).view(num_dst, heads, feat).sum(-1)
    gsum = g.sum(1)
    dh, w, bb = bwd_src(rows, grows, attn, m, l, s_dot, gsum, csr, **kw)
    assert dh.shape == (num_src, heads * feat) and w.shape[0] == num_src
    again = bwd_src(rows, grows, attn, m, l, s_dot, gsum, csr, **kw)
    assert all(torch.equal(x, y) for x, y in zip((dh, w, bb), again))
    want = _exact(kern.relgat_bwd_src_plain, rows.float(), grows.float(),
                  attn, m, l, s_dot, gsum, csr, **kw)
    for x, y in zip((dh, w, bb), want):
        assert _rel(x, y) <= REL_TOL
    for x, y in zip(bwd_rel(rows, w, bb),
                    _exact(kern.relgat_bwd_rel_plain, rows.float(), w, bb)):
        assert _rel(x, y) <= REL_TOL


def test_split_kernels_on_a_subset_without_edges(card):
    from relgat_projector_tpu_torch.data.csr import build_csr_graph
    from relgat_projector_tpu_torch.ops.propagate import (
        relgat_propagate_kernels_overlapped,
    )

    heads, feat = 4, 32
    empty = build_csr_graph(*(np.zeros(0, np.int64),) * 3, 64, 7, card,
                            num_src=24)
    loc = _subset(64, 64, 500, 2, card)
    own = torch.randn((64, heads, feat), device=card, requires_grad=True)
    halo = torch.randn((24, heads, feat), device=card, requires_grad=True)
    attn = torch.randn((heads, 7, feat), device=card) * 0.3
    before = kern.launch_counts()
    out = relgat_propagate_kernels_overlapped(own, halo, attn, None, loc,
                                              empty)
    out.sum().backward()
    after = kern.launch_counts()
    for name in ("relgat_fwd", "relgat_bwd_src", "relgat_bwd_rel"):
        assert after[name] - before[name] == 2, name
    assert torch.isfinite(out).all() and (halo.grad == 0).all()


@pytest.mark.parametrize("bf16", (False, True))
def test_empty_halo_buffer_counts_no_src_launch(card, bf16):
    """A remote subset of no source rows (halo_pair = 0): the src pass
    launches nothing and counts nothing; the forward and the relation
    reduction still launch once a subset."""
    from relgat_projector_tpu_torch.data.csr import build_csr_graph
    from relgat_projector_tpu_torch.ops.propagate import (
        relgat_propagate_kernels_overlapped,
    )

    heads, feat = 4, 32
    empty = build_csr_graph(*(np.zeros(0, np.int64),) * 3, 64, 7, card,
                            num_src=0)
    loc = _subset(64, 64, 500, 2, card)
    own = torch.randn((64, heads, feat), device=card, requires_grad=True)
    halo = torch.zeros((0, heads, feat), device=card, requires_grad=True)
    attn = torch.randn((heads, 7, feat), device=card) * 0.3
    fwd, bwd_src, bwd_rel = (
        ("relgat_fwd_bf16", "relgat_bwd_src_bf16", "relgat_bwd_rel_bf16")
        if bf16 else ("relgat_fwd", "relgat_bwd_src", "relgat_bwd_rel"))
    before = kern.launch_counts()
    out = relgat_propagate_kernels_overlapped(
        own, halo, attn, None, loc, empty,
        kernel_precision="default" if bf16 else "highest")
    out.sum().backward()
    after = kern.launch_counts()
    assert after[fwd] - before[fwd] == 2
    assert after[bwd_src] - before[bwd_src] == 1
    assert after[bwd_rel] - before[bwd_rel] == 2
    assert torch.isfinite(out).all() and halo.grad.shape == (0, heads, feat)
    g = torch.randn((64, heads * feat), device=card)
    rows = torch.zeros((0, heads * feat), device=card)
    if bf16:
        rows, g = rows.to(torch.bfloat16), g.to(torch.bfloat16)
    stats = torch.zeros((64, heads), device=card)
    before = kern.launch_counts()[bwd_src]
    dh, w, b = getattr(kern, bwd_src)(
        rows, g, attn, stats, stats, stats, torch.zeros(64, device=card),
        empty, seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    assert kern.launch_counts()[bwd_src] == before
    assert dh.shape == (0, heads * feat) and w.shape == (0, heads, 7)


def test_split_kernels_never_fall_back(card):
    """A CUDA tensor launches or raises: h with the destination rows where
    the layout's source space is asked for, a CPU layout, a bf16 h for the
    fp32 kernel."""
    csr = _subset(900, 300, 2000, 3, card)
    attn = torch.randn((4, 7, 32), device=card)
    bias = torch.zeros(7, device=card)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    with pytest.raises(ValueError, match="expected \\[900,"):
        kern.relgat_fwd(torch.randn((300, 128), device=card), attn, bias,
                        csr, **kw)
    cpu = _subset(900, 300, 2000, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="inputs lie on"):
        kern.relgat_fwd(torch.randn((900, 128), device=card), attn, bias,
                        cpu, **kw)
    with pytest.raises(NotImplementedError):
        kern.relgat_fwd(torch.randn((900, 128), device=card,
                                    dtype=torch.bfloat16), attn, bias, csr,
                        **kw)
