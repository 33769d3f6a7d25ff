"""The cell of the reference's ``large`` preset,
``preset-large-bf16.zipf-inv-10m``: 12 heads of 256 features, 4 GAT
layers, in the port's bf16 mode, on the edge-heavy graph."""

import pytest

from benchmark import harness, judge

CELL = "preset-large-bf16.zipf-inv-10m"
SEED = 2**33 + 12345


def test_the_tiny_cell_keeps_four_layers_and_is_correct(tiny):
    cell = tiny(CELL)
    assert cell.config["model"]["gat_num_layers"] == 4
    out = harness.run_cell(cell, SEED, 0.1, False, device="cpu")
    assert out["checks"]["finite_steps"] == {"value": 3, "limit": 3}
    assert out["correct"] is True, out["checks"]


def test_the_control_is_not_correct(tiny):
    """bf16 parameters and Adam moments, the nearest precision below the
    stated one, fail the cell's comparison."""
    cell = tiny(CELL)
    inputs = harness.make_inputs(cell, SEED, "cpu")
    ref = harness.reference_steps(cell, inputs, "cpu")
    program = harness.make_program(cell, inputs,
                                   variant=cell.config["control"]["model"])
    numbers = judge.readings(program.checked_steps(), ref)
    correct, checks = judge.judge(numbers, [True] * 3, cell.limits)
    assert correct is False, checks


@pytest.mark.gpu
def test_each_layer_launches_the_designs_of_its_width(card, tiny):
    """One train step at the preset's 12 x 256 in bf16, 4 layers, on a
    300-node zipf graph whose in- and out-degree hub rows are split: in
    every layer one forward on the one-warp-a-head template, one src pass
    on the ring kernel and one relation reduction on the tensor cores,
    each with its merge; no pair or tile kernel."""
    from relgat_projector_tpu_torch.ops.cuda import fused

    cell = tiny(CELL)
    cell.config["model"].update(gat_heads=12, gat_out_dim=256)
    inputs = harness.make_inputs(cell, SEED, card)
    graph = inputs["graph"].csr
    assert graph.fwd_num_split > 0 and graph.bwd_num_split > 0
    program = harness.make_program(cell, inputs)
    fused.reset_design_counts()
    program.run(0)
    layers = cell.config["model"]["gat_num_layers"]
    assert fused.design_counts() == {
        "relgat_fwd_bf16/lanes": layers, "relgat_fwd_bf16/merge": layers,
        "relgat_bwd_src_bf16/merge": layers,
        "relgat_bwd_src_bf16/ring": layers,
        "relgat_bwd_rel_bf16/mma": layers,
        "relgat_bwd_rel_bf16/reduce": layers}
