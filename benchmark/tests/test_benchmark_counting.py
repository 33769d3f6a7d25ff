"""The yardstick's counts against hand counts at tiny shapes."""

import json

import pytest

from benchmark import counting


def test_gemm_work_by_hand():
    # Y = X W with X [2, 3], W [3, 4], bf16 operands, fp32 result.
    fwd, dw, dx = counting.gemm_work(2, 3, 4, True, 2)
    assert fwd == (2 * 2 * 3 * 4, 2 * (6 + 12) + 4 * 8)
    assert dw == (48, 2 * (6 + 8 + 12))    # X^T G: reads X, G; writes dW
    assert dx == (48, 2 * (8 + 12 + 6))    # G W^T: reads G, W; writes dX
    assert len(counting.gemm_work(2, 3, 4, False, 4)) == 2


def test_gemm_shapes_of_the_production_model():
    model = json.loads(open(counting.PEAKS_FILE.parent / "configs"
                            / "small-bf16.json").read())["model"]
    shapes = counting.gemm_shapes(model, 10)
    # Two GAT layers (the first without an input gradient), a head of two.
    assert shapes == [(10, 1152, 2048, False), (10, 2048, 2048, True),
                      (10, 2048, 2048, True), (10, 2048, 1152, True)]


def test_propagate_work_by_hand():
    n, e, heads, feat, rels, rb = 3, 5, 2, 4, 2, 2
    work = counting.propagate_work(n, n, e, heads, feat, rels, rb)
    # Forward: logits over min(E, N R) = 5 pairs (2F a head), each edge's
    # weighted row (2F) and 6 scalars a head, the normalisation (N H F).
    assert work["forward"][0] == 2 * 4 * 2 * 5 + 5 * 2 * (8 + 6) + 3 * 8
    # h rows; attn, bias, dst_ptr, (src, rel) an edge, out, m and l, bias sum.
    assert work["forward"][1] == 2 * 3 * 8 + 4 * (16 + 2 + 4 + 10 + 24 + 12 + 3)
    # Backward: dalpha and the message's dh (4F) and 8 scalars an edge and
    # head; the logit gradient's two products over the 5 pairs.
    assert work["backward"][0] == 5 * 2 * (16 + 8) + 2 * 2 * 4 * 2 * 5
    # h and g rows; attn, m, l, S, gsum, src_ptr, (dst, rel) an edge, dh,
    # dattn, dbias.
    assert work["backward"][1] == 2 * (24 + 24) + 4 * (
        16 + 18 + 3 + 4 + 10 + 24 + 16 + 2)


def test_relation_reduction_is_one_product():
    # Dense relations: N R < E, so the logit gradient's two products run
    # over (source row, relation) pairs, each 2F a head: one product for
    # dattn = W^T h, the same whether the rows are fp32 or bf16.
    n, e, heads, feat, rels = 10, 1000, 16, 128, 4
    fp32 = counting.propagate_work(n, n, e, heads, feat, rels, 4)
    bf16 = counting.propagate_work(n, n, e, heads, feat, rels, 2)
    one_product = 2 * n * heads * rels * feat
    assert fp32["backward"][0] == e * heads * (4 * feat + 8) + 2 * one_product
    assert bf16["backward"][0] == fp32["backward"][0]
    assert bf16["backward"][1] < fp32["backward"][1]


def test_step_counts_of_the_production_step():
    model = json.loads(open(counting.PEAKS_FILE.parent / "configs"
                            / "small-bf16.json").read())["model"]
    peaks = counting.peaks_of("NVIDIA H100 80GB HBM3")
    c = counting.step_counts(model, 100_008, 1_000_000, 40, peaks)
    # 7.39 TFLOP of products a step at 100k rows, counted by hand.
    assert c["gemm_flop"] == pytest.approx(7.39e12, rel=0.01)
    assert c["peak_flop_per_s"] == 989e12
    # The products are bound by their operations at these shapes.
    assert c["gemm_least_s"] == pytest.approx(c["gemm_flop"] / 989e12,
                                              rel=0.01)
    assert counting.step_counts(model, 10, 10, 2, None).get(
        "gemm_least_s") is None


def test_least_seconds_takes_the_larger_bound():
    assert counting.least_seconds(10.0, 1.0, 10.0, 10.0) == 1.0
    assert counting.least_seconds(1.0, 10.0, 10.0, 2.0) == 5.0
