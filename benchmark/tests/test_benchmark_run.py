"""A whole run on the CPU at a tiny size, past the harness's look for a
card: the last line's schema, and ``correct`` false under each fault a
training cell can have and under each configuration's control."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

SEED = 2**33 + 12345
E2E = ["edge_messages_per_s", "peak_mem_gb", "setup_s"]


def _line_of(out):
    line = json.loads(json.dumps(harness.result_line(out)))
    assert list(line)[-1] == "checks"
    assert set(line) - {"breakdown"} == {"correct", "attempted", "failed",
                                         "metrics", "device", "checks"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    return line


@pytest.mark.parametrize("workload", ["small-bf16.sparse-1m",
                                      "default-fp32.zipf-inv-10m"])
def test_untraced_line(tiny, workload):
    out = harness.run_cell(tiny(workload), SEED, 0.2, False, device="cpu")
    line = _line_of(out)
    # Whether a tiny run is correct is the reference tests' question: the
    # limits are the cell's, set at its own size on the card.
    assert line["checks"]["finite_steps"] == {"value": 3, "limit": 3}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line["metrics"]) == E2E
    assert line["metrics"]["edge_messages_per_s"]["unit"] == "edges/s"
    assert "breakdown" not in line


def test_traced_line(tiny):
    out = harness.run_cell(tiny("default-fp32.sparse-1m"), SEED, 0.2, True,
                           device="cpu")
    line = _line_of(out)
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # On the CPU only the host's and the idle share's readers find
    # anything; the device's groups read nothing (no device operations).
    assert "graph_build_s" in line["metrics"]
    assert "gemm_ms" not in line["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["small-bf16.sparse-1m",
                                      "default-fp32.sparse-1m"])
def test_a_broken_step_is_not_correct(tiny, workload, fault):
    out = harness.run_cell(tiny(workload), SEED, 0.1, False, device="cpu",
                           fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["small-bf16.zipf-inv-10m",
                                      "default-fp32.zipf-inv-10m"])
def test_the_control_is_not_correct(tiny, workload):
    """The configuration's control: the program's own path in the nearest
    precision below the stated one (bf16 parameters for ``small-bf16``,
    the bf16 mode for ``default-fp32``) fails the comparison."""
    cell = tiny(workload)
    inputs = harness.make_inputs(cell, SEED, "cpu")
    ref = harness.reference_steps(cell, inputs, "cpu")
    program = harness.make_program(cell, inputs,
                                   variant=cell.config["control"]["model"])
    from benchmark import judge
    numbers = judge.readings(program.checked_steps(), ref)
    correct, checks = judge.judge(numbers, [True] * 3, cell.limits)
    assert correct is False, checks


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "small-bf16.sparse-1m", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=harness.ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "relgat_projector_tpu_torch_x", sys)
    assert "relgat_projector_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "relgat_projector_tpu.ops", sys)
    assert "relgat_projector_tpu.ops" in harness.forbidden_modules()


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{body}
top = {{m.split('.')[0] for m in sys.modules}}
print(sorted(top & {{'jax', 'jaxlib', 'flax', 'optax', 'relgat_projector_tpu',
                     'relgat_projector_tpu_torch'}}))
"""


def _top_names(body):
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=str(harness.ROOT),
                                               body=body)],
        capture_output=True, text=True, timeout=300, check=True)
    return proc.stdout.strip()


def test_the_run_loads_no_jax(tiny):
    """A whole CPU run in a fresh process: the port is loaded, JAX and the
    JAX package are not."""
    body = (
        "from benchmark import harness\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "harness.run_cell(tiny_cell('small-bf16.sparse-1m'), 7, 0.05, True,"
        " device='cpu')\n")
    assert _top_names(body) == "['relgat_projector_tpu_torch']"


def test_the_reference_loads_neither_jax_nor_the_program():
    body = "from benchmark.reference import model\nfrom benchmark import judge"
    assert _top_names(body) == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["small-bf16.zipf-inv-10m",
                                      "default-fp32.sparse-1m"])
def test_on_the_card(card, tiny, workload):
    """The tiny cell through the card's kernels: a traced run whose
    device groups all read, and the control not correct."""
    cell = tiny(workload)
    out = harness.run_cell(cell, SEED, 0.5, True, device=card)
    line = _line_of(out)
    assert line["device"]["platform"] == "gpu"
    assert line["checks"]["finite_steps"] == {"value": 3, "limit": 3}
    assert {"gemm_ms", "propagate_ms", "elementwise_ms"} <= set(
        line["metrics"])
    inputs = harness.make_inputs(cell, SEED, card)
    ref = harness.reference_steps(cell, inputs, card)
    program = harness.make_program(cell, inputs,
                                   variant=cell.config["control"]["model"])
    from benchmark import judge
    numbers = judge.readings(program.checked_steps(), ref)
    assert judge.judge(numbers, [True] * 3, cell.limits)[0] is False
