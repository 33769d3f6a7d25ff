"""``BENCHMARK.json`` and the files it names, found by name.

The checks are functions of a spec and the root it lies under, so that a
test runs them on a spec that is not the repo's: a later cell, metric or
configuration is new files and new entries only, and these tests hold it
to the same rules without an edit.
"""

import hashlib
import json
import re
import shutil

import pytest

from benchmark import harness, judge
from benchmark.tests.conftest import card_trace

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTH = re.compile(r"(_dim|_rank)$")  # no width is ever cut
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
SOURCE = {m["name"]: m["source"] for m in SPEC["per_layer"]}
DATA = ("configs", "traffic", "limits", "metrics")
# What the accepted benchmark reports: a spec may add to these and never
# drops one, and each accepted cell reports all of them.
ACCEPTED_E2E = {"edge_messages_per_s", "peak_mem_gb", "setup_s"}
ACCEPTED_PER_LAYER = {
    "graph_build_s", "step_mfu", "gemm_ms", "gemm_roofline", "propagate_ms",
    "propagate_roofline", "elementwise_ms", "device_idle_share",
    "gat_layers_ms", "head_ms", "optimizer_ms"}
ACCEPTED_CELLS = {"small-bf16.sparse-1m", "small-bf16.zipf-inv-10m",
                  "default-fp32.sparse-1m", "default-fp32.zipf-inv-10m"}


def check_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51


def _unique(names):
    assert len(names) == len(set(names)), names
    return set(names)


def check_entries(spec):
    for entry in spec["configs"] + spec["workloads"] + spec["end_to_end"] \
            + spec["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    cells = _unique([w["name"] for w in spec["workloads"]])
    _unique([c["name"] for c in spec["configs"]])
    _unique([(w["config"], w["traffic"]) for w in spec["workloads"]])
    _unique([m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        # A list, where a metric has one, names existing cells; without
        # one the metric is every cell's that reports what it moves.
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells, m
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert ACCEPTED_E2E <= e2e, e2e
    assert ACCEPTED_PER_LAYER <= {m["name"] for m in spec["per_layer"]}
    for m in spec["per_layer"]:
        assert {"name", "unit", "better", "source", "layer", "moves"} \
            <= set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def check_chips(spec):
    """One chip or four; at most a quarter of the cells, rounded down, on
    four, and one such cell always allowed."""
    chips = [w["chips"] for w in spec["workloads"]]
    assert set(chips) <= {1, 4}, chips
    assert chips.count(4) <= max(1, len(chips) // 4), chips


def check_configs(spec, root):
    """Every configuration is used, lies under ``paths``, and states its
    cuts: the file's ``reduced`` is the entry's, names keys of its model
    and no width, and a configuration with a cut states its source and
    the deployment it stands for."""
    assert {w["config"] for w in spec["workloads"]} == {
        c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        config = json.loads((root / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"], c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in config["model"], key
            assert not WIDTH.search(key), key
        if c["reduced"]:
            assert config.get("source") and config.get("deployment"), \
                c["name"]


def check_readers(spec, root):
    for m in spec["per_layer"]:
        assert (root / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def _names_for(cell_name, metrics, reported=None):
    """The metrics a cell reports: those that name it or name no cell,
    and, for per-layer metrics, that move an end-to-end metric it
    reports."""
    return [m["name"] for m in metrics
            if cell_name in m.get("workloads", [cell_name])
            and (reported is None or m["moves"] in reported)]


def check_cell(spec, cell):
    entry = {w["name"]: w for w in spec["workloads"]}[cell.name]
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert cell.chips == entry["chips"]
    e2e = _names_for(cell.name, spec["end_to_end"])
    assert [m["name"] for m in cell.end_to_end] == e2e
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = _names_for(cell.name, spec["per_layer"], set(e2e))
    assert [m["name"] for m in cell.per_layer] == per_layer
    assert per_layer
    if cell.name in ACCEPTED_CELLS:
        assert ACCEPTED_E2E <= set(e2e), e2e
        assert ACCEPTED_PER_LAYER <= set(per_layer), per_layer
    compared = set(cell.limits)
    assert compared <= set(judge.NUMBERS)
    assert {"loss_gap", "change_gap"} <= compared
    # The gradient by its worst leaf: over every leaf, or over every leaf
    # but the relation biases, those held on their own or, where their
    # first gradient cancels past any limit, by their change alone.
    assert compared & {"grad_gap", "grad_gap_but_rel_bias"}
    if "rel_bias_gap" in compared:
        assert "grad_gap_but_rel_bias" in compared


def check_spec(spec, root):
    """Every rule above, for ``spec`` and the files it names under
    ``root``, each cell loaded as a run loads it."""
    check_top_level(spec)
    check_entries(spec)
    check_chips(spec)
    check_configs(spec, root)
    check_readers(spec, root)
    for w in spec["workloads"]:
        check_cell(spec, harness.load_cell(w["name"], root=root))


def _copy_root(tmp_path, spec=SPEC):
    """``tmp_path`` as a root: ``spec`` and the benchmark's data files and
    readers."""
    for sub in DATA:
        shutil.copytree(harness.BENCH_DIR / sub, tmp_path / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    _write(tmp_path / "BENCHMARK.json", spec)
    return json.loads(json.dumps(spec))


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_top_level_keys_and_command():
    check_top_level(SPEC)


def test_names_units_and_entries():
    check_entries(SPEC)
    check_chips(SPEC)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_lookup_by_name(workload):
    cell = harness.load_cell(workload)
    config, traffic = workload.split(".", 1)
    assert cell.config["name"] == config and cell.traffic["name"] == traffic
    check_cell(SPEC, cell)


@pytest.mark.parametrize("change", ["lose", "gain", "lose_e2e"])
def test_a_cell_that_loses_or_gains_a_metric_fails(change):
    """The rule that replaced a fixed count still fails a cell that lost a
    metric it should report, or got one that names only another cell."""
    cell = harness.load_cell(WORKLOADS[0])
    if change == "lose":
        cell.per_layer = cell.per_layer[:-1]
    elif change == "gain":
        cell.per_layer = cell.per_layer + [dict(
            cell.per_layer[0], name="other_ms", workloads=[WORKLOADS[1]])]
    else:
        cell.end_to_end = cell.end_to_end[:-1]
    with pytest.raises(AssertionError):
        check_cell(SPEC, cell)


@pytest.mark.parametrize("metric", ["peak_mem_gb", "setup_s",
                                    "gemm_roofline", "head_ms"])
def test_a_spec_that_drops_an_accepted_metric_fails(metric):
    spec = json.loads(json.dumps(SPEC))
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [m for m in spec[kind] if m["name"] != metric]
    with pytest.raises(AssertionError):
        check_entries(spec)


@pytest.mark.parametrize("metric", ["peak_mem_gb", "gemm_roofline",
                                    "optimizer_ms"])
def test_an_accepted_cell_that_loses_a_metric_to_a_list_fails(tmp_path,
                                                               metric):
    """A metric narrowed to a list without an accepted cell passes the
    entries and fails that cell, which must report every accepted
    metric."""
    spec = _copy_root(tmp_path)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == metric:
            m["workloads"] = [WORKLOADS[1]]
    _write(tmp_path / "BENCHMARK.json", spec)
    check_entries(spec)
    check_cell(spec, harness.load_cell(WORKLOADS[1], root=tmp_path))
    with pytest.raises(AssertionError):
        check_cell(spec, harness.load_cell(WORKLOADS[0], root=tmp_path))


@pytest.mark.parametrize("cells", [[], ["no-such.cell"]])
def test_a_metric_list_names_existing_cells(cells):
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"][0]["workloads"] = cells
    with pytest.raises(AssertionError):
        check_entries(spec)


@pytest.mark.parametrize("chips, ok", [
    ([1, 1, 1, 1], True),
    ([4, 1, 1, 1], True),           # a quarter of four
    ([4], True),                    # one is always allowed
    ([4, 4, 1, 1, 1, 1, 1, 1], True),
    ([4, 4, 1, 1], False),          # more than a quarter
    ([4, 4, 4, 1, 1, 1, 1, 1], False),
    ([2, 1, 1, 1], False),          # neither one chip nor four
])
def test_chips_are_one_or_four_and_four_at_most_a_quarter(chips, ok):
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"] = [dict(spec["workloads"][0], chips=c)
                         for c in chips]
    if ok:
        check_chips(spec)
    else:
        with pytest.raises(AssertionError):
            check_chips(spec)


@pytest.mark.parametrize("fault", [None, "entry_differs", "not_a_model_key",
                                   "a_width", "no_deployment"])
def test_a_cut_is_stated_in_the_file_and_the_entry(tmp_path, fault):
    """``small-bf16`` cut to one GAT layer passes where the file and the
    entry agree, the key is the model's and no width, and the file states
    its source and deployment; each fault alone fails."""
    spec = _copy_root(tmp_path)
    path = tmp_path / spec["configs"][0]["file"]
    config = json.loads(path.read_text())
    key = {"not_a_model_key": "train_batch_size",
           "a_width": "gat_out_dim"}.get(fault, "gat_num_layers")
    config["reduced"] = [key]
    if key in config["model"]:
        config["model"][key] = 1
    config["deployment"] = "one card; the other layer on a second card"
    spec["configs"][0]["reduced"] = [] if fault == "entry_differs" else [key]
    if fault == "no_deployment":
        del config["deployment"]
    _write(path, config)
    if fault is None:
        check_configs(spec, tmp_path)
    else:
        with pytest.raises(AssertionError):
            check_configs(spec, tmp_path)


def test_the_next_cell_is_files_and_entries_only(tmp_path):
    """A sixth cell: ``small-bf16`` at 12 x 256 and 4 layers (the
    reference's ``large`` preset) on ``zipf-inv-10m``, added as a
    configuration file, a limits file and two entries, gets every
    per-layer metric and passes every check; nothing under the repo's
    ``benchmark/`` is written."""
    before = _digest(harness.BENCH_DIR)
    spec = _copy_root(tmp_path)
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "small-bf16.json").read_text())
    config["name"] = "large-bf16"
    config["model"].update(gat_heads=12, gat_out_dim=256, gat_num_layers=4)
    _write(bench / "configs" / "large-bf16.json", config)
    _write(bench / "limits" / "large-bf16.zipf-inv-10m.json", json.loads(
        (bench / "limits" / "small-bf16.zipf-inv-10m.json").read_text()))
    spec["configs"].append(dict(spec["configs"][0], name="large-bf16",
                                file="benchmark/configs/large-bf16.json"))
    spec["workloads"].append(dict(spec["workloads"][1],
                                  name="large-bf16.zipf-inv-10m",
                                  config="large-bf16"))
    _write(tmp_path / "BENCHMARK.json", spec)

    check_spec(spec, tmp_path)
    cell = harness.load_cell("large-bf16.zipf-inv-10m", root=tmp_path)
    names = [m["name"] for m in cell.per_layer]
    assert names == [m["name"] for m in SPEC["per_layer"]]
    assert {"gat_layers_ms", "head_ms", "optimizer_ms"} <= set(names)
    assert (cell.config["model"]["gat_heads"],
            cell.config["model"]["gat_out_dim"],
            cell.config["model"]["gat_num_layers"]) == (12, 256, 4)
    assert cell.traffic["name"] == "zipf-inv-10m"
    for w in WORKLOADS:  # the four cells load what they load in the repo
        assert harness.load_cell(w, root=tmp_path) == harness.load_cell(w)
    assert _digest(harness.BENCH_DIR) == before


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
               "profile": card_trace()})
    value = read(run)
    assert value is not None and value > 0
    # Without a trace the device-trace readers find nothing to read, and
    # report nothing rather than 0. (The harness calls every reader in the
    # traced run only.)
    if SOURCE[metric] == "device_trace":
        bare = harness.LayerRun(step_s=0.05, graph_build_s=0.4, counts={})
        assert read(bare) is None


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such.cell")


def test_every_config_file_is_used_and_lies_under_paths():
    check_configs(SPEC, harness.ROOT)
    check_readers(SPEC, harness.ROOT)


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
