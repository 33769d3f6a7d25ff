"""The reference's ``large`` architecture preset (12 heads x 256 features,
4 GAT layers): the benchmark's configuration of it, the port's train step
at its depth and head count against the benchmark's plain reference, and
the propagate's launch counter by kernel design."""

import json

import pytest

from benchmark import harness, judge
from relgat_projector_tpu_torch.config import apply_architecture_preset
from relgat_projector_tpu_torch.ops.cuda import fused

CELL = "preset-large-bf16.zipf-inv-10m"
FP32_CELL = "default-fp32.zipf-inv-10m"
SEED = 2**32 + 2020
PRESET_KEYS = ("gat_heads", "gat_out_dim", "gat_num_layers")


def test_the_benchmark_runs_the_ports_preset():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}["preset-large-bf16"]
    model = json.loads((harness.ROOT / entry["file"]).read_text())["model"]
    preset = apply_architecture_preset("large", {})
    assert preset == {k: model[k] for k in PRESET_KEYS}
    assert (preset["gat_heads"], preset["gat_out_dim"],
            preset["gat_num_layers"]) == (12, 256, 4)


def _cpu_cell(precision_of=None):
    """The cell at the preset's depth and head count with the width cut
    for the CPU: 24-wide embeddings, 12 heads of 16, 4 layers, batches of
    16 with 4 negatives, on 300 nodes and 1,500 base edges over 5
    relations of the zipf rule with each edge's inverse. ``precision_of``
    names a cell whose precision settings replace the preset's bf16."""
    cell = harness.load_cell(CELL)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["model"].update(in_dim=24, gat_out_dim=16)
    if precision_of is not None:
        other = harness.load_cell(precision_of).config["model"]
        cell.config["model"].update(
            {k: other[k] for k in ("param_dtype", "compute_dtype",
                                   "kernel_precision")})
    cell.config["train"].update(train_batch_size=16, num_neg=4)
    cell.traffic = dict(cell.traffic, num_nodes=300, num_edges=1500,
                        num_rel=5)
    return cell


def _judged(cell, limits):
    inputs = harness.make_inputs(cell, SEED, "cpu")
    ref = harness.reference_steps(cell, inputs, "cpu")
    record = harness.make_program(cell, inputs).checked_steps()
    numbers = judge.readings(record, ref)
    return judge.judge(numbers, record["finite"], limits)


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_the_train_step_follows_the_reference(precision):
    """Three train steps of the port against the benchmark's reference on
    the same seeded weights, batches and dropout stream.

    bf16 mode is held to the new cell's limits, calibrated on the card at
    full width: the same bf16 roundings on both sides, flipped where an
    fp32 sum runs in another order, and the gap they leave grows with the
    depth, so the cell's own limits and not ``small-bf16``'s. fp32 mode is
    held to ``default-fp32.zipf-inv-10m``'s limits: fp32 on both sides,
    only the order of the sums differs, on the same graph rule."""
    if precision == "bf16":
        cell, limits = _cpu_cell(), harness.load_cell(CELL).limits
    else:
        cell = _cpu_cell(FP32_CELL)
        limits = harness.load_cell(FP32_CELL).limits
    assert cell.config["model"]["gat_num_layers"] == 4
    assert cell.config["model"]["gat_heads"] == 12
    correct, checks = _judged(cell, limits)
    assert correct, checks


def test_the_design_counter_reads_nothing_on_the_plain_path_and_resets():
    """On the CPU every wrapper runs its plain version, which launches no
    kernel: a train step leaves the counter empty, and a reset zeroes what
    a launch would have counted."""
    fused.reset_design_counts()
    cell = _cpu_cell()
    inputs = harness.make_inputs(cell, SEED, "cpu")
    harness.make_program(cell, inputs).run(0)
    assert fused.design_counts() == {}
    assert all(n == 0 for n in fused.launch_counts().values())
    fused._count(fused.relgat_fwd_bf16, "lanes", "merge")
    assert fused.design_counts() == {"relgat_fwd_bf16/lanes": 1,
                                     "relgat_fwd_bf16/merge": 1}
    fused.reset_design_counts()
    fused.reset_launch_counts()
    assert fused.design_counts() == {}


def test_the_preset_reduces_relations_on_the_tensor_cores():
    """The relation reduction at the preset's width takes the tensor cores;
    the forward and src pass take the template and the ring kernel
    (``tests/test_torch_widths.py`` holds those by width)."""
    assert fused.design_of(fused.relgat_bwd_rel_bf16, 12, 256) == "mma"
    assert fused.design_of(fused.relgat_fwd_bf16, 12, 256) == "lanes"
    assert fused.design_of(fused.relgat_bwd_src_bf16, 12, 256) == "ring"
