"""``BENCHMARK.json`` and the files it names, found by name."""

import json
import re

import pytest

from benchmark import harness, judge

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_entries():
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
            + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"edge_messages_per_s", "peak_mem_gb", "setup_s"} == e2e
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(WORKLOADS)
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_lookup_by_name(workload):
    cell = harness.load_cell(workload)
    config, traffic = workload.split(".", 1)
    assert cell.config["name"] == config and cell.traffic["name"] == traffic
    assert cell.config["reduced"] == []
    compared = set(cell.limits)
    assert compared <= set(judge.NUMBERS)
    assert {"loss_gap", "change_gap"} <= compared
    # The gradient by its worst leaf: over every leaf, or over every leaf
    # but the relation biases with those held on their own.
    assert compared & {"grad_gap", "grad_gap_but_rel_bias"}
    assert ("grad_gap_but_rel_bias" in compared) == (
        "rel_bias_gap" in compared)
    assert [m["name"] for m in cell.end_to_end] == [
        "edge_messages_per_s", "peak_mem_gb", "setup_s"]
    assert len(cell.per_layer) == 8


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_by_name(metric):
    read = harness.metric_reader(metric)
    kernels = [("relgat_fwd_kernel", 0.036), ("sm90_gemm", 0.032),
               ("elementwise", 0.12)]
    run = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={
        "model_flop": 1e12, "gemm_least_s": 0.004, "propagate_least_s": 0.002,
        "peak_flop_per_s": 989e12},
        groups_s={"gemm": 0.008, "propagate": 0.009, "other": 0.03},
        busy_s=0.047, config={}, traffic={},
        shape={"rows": 8, "edges": 16, "num_rel": 2, "window_steps": 9},
        trace={"kernels": kernels, "gaps": [("host (between ops)", 0.012)],
               "busy_s": 0.188, "traced_s": 0.2, "steps": 4,
               "profile": None})
    value = read(run)
    assert value is not None and value > 0
    # Without a trace (or a card with known peaks) the trace's readers
    # find nothing to read, and report nothing rather than 0.
    bare = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={})
    if SPEC["per_layer"][[m["name"] for m in SPEC["per_layer"]].index(
            metric)]["source"] == "device_trace":
        assert read(bare) is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell")


def test_every_config_file_is_used_and_lies_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert (harness.ROOT / c["file"]).is_file()


def test_a_new_reader_is_a_file_that_reads_the_whole_record(tmp_path,
                                                            monkeypatch):
    """A later metric is a file alone: its reader gets the traced record
    whole (per-kernel times, gaps), the cell's configuration and traffic
    and the run's shapes."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "launch_share.py").write_text(
        "def read(run):\n"
        "    if run.trace is None:\n"
        "        return None\n"
        "    fwd = sum(s for k, s in run.trace['kernels'] if 'fwd' in k)\n"
        "    return 100.0 * fwd / run.trace['busy_s'] + "
        "run.shape['num_rel'] + len(run.traffic) + len(run.config)\n")
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    read = harness.metric_reader("launch_share")
    run = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={},
                           config={"model": {}}, traffic={"a": 1, "b": 2},
                           shape={"num_rel": 3},
                           trace={"kernels": [("relgat_fwd", 0.5),
                                              ("gemm", 0.5)],
                                  "busy_s": 1.0})
    assert read(run) == 50.0 + 3 + 2 + 1
    assert read(harness.LayerRun(step_s=0.05, graph_build_s=0.4,
                                 counts={})) is None
