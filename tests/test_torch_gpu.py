"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
test, so every xdist worker collects the same tests). Run them on a machine
with a card, from the repository root, without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: max|kernel - plain| <= 1e-5 * max|plain|, with the plain version
run in float64 on the same fp32 inputs, so the error is the kernel's own fp32
rounding (the kernels keep a true per-row running max like the plain
version).
"""

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.ops import cuda as kern
from relgat_projector_tpu_torch.ops.propagate import relgat_propagate_kernels

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


@pytest.mark.parametrize("heads,feat", [(1, 8), (3, 40), (16, 128), (9, 200)])
@pytest.mark.parametrize("rate", (0.0, 0.3))
def test_kernels_match_plain(card, heads, feat, rate):
    g, h, gr, attn, bias = _case(heads, feat)
    csr, num_rel = g.csr, attn.shape[1]
    kw = dict(seed=-987654321, rate=rate, negative_slope=0.2, eps=1e-16)
    before = kern.launch_counts()
    out_k, m_k, l_k, b_k = kern.relgat_fwd(h, attn, bias, csr, **kw)
    out_p, m, l, b = _exact(kern.relgat_fwd_plain, h, attn, bias, csr, **kw)
    assert _rel(out_k, out_p) <= REL_TOL
    assert _rel(l_k, l) <= REL_TOL and _rel(b_k, b) <= REL_TOL
    assert torch.equal(torch.isinf(m_k), torch.isinf(m))
    n = h.shape[0]
    s_dot = ((out_k - b_k[:, None]) * gr).view(n, heads, feat).sum(-1)
    args = (h, gr, attn, m_k, l_k, s_dot, csr)
    dh_k, de_k = kern.relgat_bwd_src(*args, **kw)
    dh_p, de_p = _exact(kern.relgat_bwd_src_plain, *args, **kw)
    assert _rel(dh_k, dh_p) <= REL_TOL and _rel(de_k, de_p) <= REL_TOL
    gsum = gr.sum(1)
    da_k, db_k = kern.relgat_bwd_rel(h, de_k, gsum, csr, num_rel)
    da_p, db_p = _exact(kern.relgat_bwd_rel_plain, h, de_k, gsum, csr, num_rel)
    assert _rel(da_k, da_p) <= REL_TOL and _rel(db_k, db_p) <= REL_TOL
    torch.cuda.synchronize()
    after = kern.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


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


def test_cuda_tensors_never_fall_back(card):
    g, h, gr, attn, bias = _case(2, 16)
    with pytest.raises(NotImplementedError):
        kern.relgat_fwd(h.double(), attn.double(), bias.double(), g.csr,
                        seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    with pytest.raises(ValueError):
        kern.relgat_fwd(h[:, :-1].contiguous(), attn, bias, g.csr, seed=None,
                        rate=0.0, negative_slope=0.2, eps=1e-16)
