"""The plain reference: its hand-written propagate backward against
autograd through the naive formula, and its train steps against the
program's CPU path (this test imports both; the reference imports
neither the program nor JAX)."""

import torch
import torch.nn.functional as F

from benchmark import harness, judge
from benchmark.reference import model as ref

SEED = 2**32 + 99


def _naive(h, attn, bias, src, dst, et, n):
    """Every edge at once, autograd's own backward."""
    z = (h[src] * attn[:, et].transpose(0, 1)).sum(-1)
    e = F.leaky_relu(z, ref.SLOPE)
    m = torch.full((n, h.shape[1]), -torch.inf, dtype=h.dtype).scatter_reduce(
        0, dst[:, None].expand_as(e), e.detach(), "amax")
    w = torch.exp(e - m[dst])
    l = torch.zeros((n, h.shape[1]), dtype=h.dtype).index_add(0, dst, w)
    alpha = w / l[dst]
    out = torch.zeros_like(h).index_add(0, dst, h[src] * alpha[..., None])
    return out + torch.zeros(n, dtype=h.dtype).index_add(
        0, dst, bias[et])[:, None, None]


def test_propagate_backward_matches_autograd():
    gen = torch.Generator().manual_seed(3)
    n, e, heads, feat, rels = 40, 300, 3, 5, 4
    src = torch.randint(0, n, (e,), generator=gen)
    dst = torch.randint(0, n // 2, (e,), generator=gen)  # rows with no edges
    et = torch.randint(0, rels, (e,), generator=gen)
    h = torch.randn(n, heads, feat, generator=gen, dtype=torch.float64)
    attn = torch.randn(heads, rels, feat, generator=gen, dtype=torch.float64)
    bias = torch.randn(rels, generator=gen, dtype=torch.float64)
    g = torch.randn(n, heads, feat, generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    want = torch.autograd.grad(_naive(*leaves, src, dst, et, n), leaves, g)
    edges = ref.Edges(src, dst, et, rels, block_edges=64)
    leaves = [t.clone().requires_grad_(True) for t in (h, attn, bias)]
    out = ref._Propagate.apply(*leaves, edges, False)
    assert torch.allclose(out, _naive(h, attn, bias, src, dst, et, n),
                          rtol=1e-12, atol=1e-12)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)


def _readings(cell):
    inputs = harness.make_inputs(cell, SEED, "cpu")
    reference = harness.reference_steps(cell, inputs, "cpu")
    record = harness.make_program(cell, inputs).checked_steps()
    return judge.readings(record, reference), record


def test_reference_follows_the_program_in_fp32(tiny):
    numbers, record = _readings(tiny("default-fp32.zipf-inv-10m"))
    assert all(record["finite"])
    # fp32 both sides, sums in other orders.
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3


def test_reference_follows_the_program_in_bf16(tiny):
    numbers, record = _readings(tiny("small-bf16.sparse-1m"))
    assert all(record["finite"])
    # The same bf16 roundings on both sides, flipped where an fp32 sum
    # taken in another order lands on a rounding boundary.
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap_but_rel_bias"] < 1e-2
    assert numbers["rel_bias_gap"] < 1e-2
    assert numbers["grad_gap"] == max(numbers["grad_gap_but_rel_bias"],
                                      numbers["rel_bias_gap"])
    assert numbers["change_gap"] < 1e-2
