"""One run of one cell: set-up, the measured window, the traced steps and
the comparison with the plain reference.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file and traffic mix, ``traffic/<traffic>.json`` is
the mix's parameters, ``limits/<cell>.json`` the comparison's limits, and
``metrics/<metric>.py`` the reader of each per-layer metric (a function
``read(run)`` that returns a number, or None where it finds nothing).

What the window drives is the program's public train step
(``train/step.py:make_train_step``, what ``RelGATTrainer`` calls each
step) on the graph ``data/graph.py:build_graph(..., csr=True)`` lays out,
its state from ``train/state.py:create_train_state`` with the schedule and
optimizer of ``schedules.py`` and ``train/state.py:make_optimizer``. The
benchmark makes the weights (``generate.py``) and hands the same ones to
the program and the reference. One state is built; its first three steps
are the checked ones, and the same state and step go on into the window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark import counting, devtrace, generate, judge
from benchmark.reference import model as reference

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "relgat_projector_tpu")
CHECKED_STEPS = 3
EXTRA_WARMUP_STEPS = 2
TRACED_STEPS = 4
MAX_BATCHES = 4096
REFERENCE_BLOCK_BYTES = 1 << 30
BREAKDOWN_TOP = 10
B1 = 0.9  # Adam's first-moment decay: mu after one step is (1 - b1) g


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files, all
    read under ``root``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    bench = root / BENCH_DIR.name
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in reported]
    return Cell(workload, config, traffic, limits, int(cell["chips"]), e2e,
                per_layer)


def metric_reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

def nest(flat: Dict[str, torch.Tensor], model: dict) -> dict:
    """The program's parameter tree of the benchmark's named leaves."""
    layers = []
    for li in range(model["gat_num_layers"]):
        pre = f"layers.{li}."
        layers.append({k[len(pre):]: v for k, v in flat.items()
                       if k.startswith(pre)})
    tree = {"layers": layers, "scorer": {"rel_emb": flat["scorer.rel_emb"]}}
    if model["project_to_input_size"]:
        tree["projection"] = {
            part: [flat[f"projection.{part}.{i}"]
                   for i in range(sum(k.startswith(f"projection.{part}.")
                                      for k in flat))]
            for part in ("linears", "ln_scale", "ln_bias")}
    return tree


def flatten(tree: dict) -> Dict[str, torch.Tensor]:
    out = {}
    for li, layer in enumerate(tree["layers"]):
        out.update({f"layers.{li}.{k}": v for k, v in layer.items()})
    for part, leaves in tree.get("projection", {}).items():
        out.update({f"projection.{part}.{i}": v for i, v in enumerate(leaves)})
    out["scorer.rel_emb"] = tree["scorer"]["rel_emb"]
    return out


def _fault(step: Callable, fault: Optional[str], batch: int) -> Callable:
    """The step with a planted fault: ``unchanged`` returns the state it
    was given; ``half_batch`` leaves out the batch's second half, the mean
    taken over the rest."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(state, *args, **kw):
            return state, step(state, *args, **kw)[1]
        return unchanged
    if fault == "half_batch":
        def half(state, node_emb, graph, src, rel, dst, weight, neg_dst=None):
            w = weight.clone()
            w[batch // 2:] = 0.0
            return step(state, node_emb, graph, src, rel, dst, w,
                        neg_dst=neg_dst)
        return half
    raise ValueError(f"unknown fault {fault!r}")


class Program:
    """The program's train step and its one state, fed from ``batches``."""

    def __init__(self, config: dict, weights, node_emb, graph, batches,
                 num_rel: int, num_examples: int, seed: int, *,
                 variant: Optional[dict] = None, fault: Optional[str] = None):
        from relgat_projector_tpu_torch.config import (
            ModelConfig, TrainConfig, torch_dtype)
        from relgat_projector_tpu_torch.schedules import (
            compute_total_and_warmup_steps, make_lr_schedule)
        from relgat_projector_tpu_torch.train.state import (
            create_train_state, make_optimizer)
        from relgat_projector_tpu_torch.train.step import make_train_step

        model = {**config["model"], **(variant or {})}
        train = dict(config["train"])
        ratio = train.pop("warmup_ratio")
        mcfg = ModelConfig(num_rel=num_rel, **model)
        tcfg = TrainConfig(**train)
        total, warm = compute_total_and_warmup_steps(
            num_examples, tcfg.train_batch_size, tcfg.epochs, None, ratio)
        sched = make_lr_schedule(tcfg.lr, tcfg.lr_scheduler, total, warm)
        opt = make_optimizer(tcfg, sched)
        dtype = torch_dtype(mcfg.param_dtype)
        self.start = {k: v.to(dtype) for k, v in weights.items()}
        params = nest({k: v.clone() for k, v in self.start.items()}, model)
        self.state = create_train_state(params, opt, seed=seed)
        self.step = _fault(make_train_step(mcfg, tcfg, opt, sched), fault,
                           tcfg.train_batch_size)
        self.node_emb, self.graph, self.batches = node_emb, graph, batches
        self.weight = torch.ones(tcfg.train_batch_size, device=node_emb.device)

    def run(self, i: int) -> dict:
        src, rel, dst, neg = self.batches.at(i)
        self.state, metrics = self.step(self.state, self.node_emb, self.graph,
                                        src, rel, dst, self.weight,
                                        neg_dst=neg)
        return metrics

    def checked_steps(self) -> dict:
        """The first steps, through the window's own call and feed: each
        step's loss and finite flag, the first gradient as the optimizer
        took it, and the parameters after the last."""
        losses, finite, first_grad = [], [], None
        for i in range(CHECKED_STEPS):
            metrics = self.run(i)
            losses.append(metrics["loss"])
            finite.append(metrics["finite"])
            if first_grad is None:
                first_grad = {k: v.float() / (1.0 - B1) for k, v in
                              flatten(self.state.opt_state.mu).items()}
        return {"losses": [float(x) for x in losses],
                "finite": [bool(f) for f in finite],
                "first_grad": first_grad,
                "params": {k: v.detach().clone() for k, v in
                           flatten(self.state.params).items()},
                "start": self.start}


# ---------------------------------------------------------------------------
# Measuring
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(program: Program, first: int, seconds: float, device) -> dict:
    """Steps back to back for ``seconds``, then a synchronise: the time is
    the whole window's, to the end of its last step."""
    skipped = program.state.nonfinite_steps.clone()
    _sync(device)
    t0 = time.perf_counter()
    i = first
    while True:
        program.run(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    failed = int(program.state.nonfinite_steps - skipped)
    return {"steps": i - first, "window_s": window_s, "failed": failed,
            "next": i}


def traced_steps(program: Program, first: int, device) -> dict:
    """``TRACED_STEPS`` steps under ``torch.profiler`` (host and device),
    after one untraced step."""
    program.run(first)
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first + 1, first + 1 + TRACED_STEPS):
            program.run(i)
        _sync(device)
        traced_s = time.perf_counter() - t0
    kernels = devtrace.device_time_by_kernel(prof)
    busy_s, gaps = devtrace.busy_and_gaps(prof)
    return {"traced_s": traced_s, "kernels": kernels, "busy_s": busy_s,
            "gaps": gaps, "groups_s": devtrace.grouped_seconds(kernels),
            "steps": TRACED_STEPS, "profile": prof}


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclasses.dataclass
class LayerRun:
    """What a per-layer metric's reader reads.

    ``step_s``: the untraced window's seconds a step; ``graph_build_s``:
    the host clock's graph build; ``counts``: the step's counts
    (``counting.step_counts``); ``groups_s`` and ``busy_s``: per-step
    device seconds by group and busy seconds of the trace. ``config``,
    ``traffic`` and ``shape`` (node rows, edges, relations, the window's
    steps) are the cell's; ``trace`` is the traced record whole:
    ``kernels`` and ``gaps`` (``(name, seconds)`` over the traced steps),
    ``busy_s``, ``traced_s``, ``steps`` and ``profile``, the
    ``torch.profiler`` object itself. The trace's fields are None
    without a trace."""

    step_s: float
    graph_build_s: float
    counts: dict
    groups_s: Optional[Dict[str, float]] = None
    busy_s: Optional[float] = None
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    shape: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


def reference_steps(cell: Cell, inputs: dict, device) -> dict:
    """The plain reference's checked steps, from the benchmark's inputs
    (the dropout stream is the program's device generator's: its seed
    plus one, ``utils/rng.py``)."""
    model = cell.config["model"]
    src, dst, et = (torch.from_numpy(a).to(device) for a in inputs["edges"])
    width = model["gat_heads"] * model["gat_out_dim"]
    edges = reference.Edges(src, dst, et, inputs["num_rel"],
                            REFERENCE_BLOCK_BYTES // (4 * width))
    gen = generate.device_generator(inputs["program_seed"] + 1, device)
    batches = [inputs["batches"].at(i) for i in range(CHECKED_STEPS)]
    ref = reference.run_steps(inputs["weights"], model, cell.config["train"],
                              inputs["node_emb"], edges, batches,
                              int(src.shape[0]), gen)
    ref["start"] = inputs["weights"]
    return ref


def make_inputs(cell: Cell, seed: int, device) -> dict:
    """The graph, laid out by the program, and every input, from ``seed``."""
    from relgat_projector_tpu_torch.data.graph import build_graph

    s_graph, s_emb, s_weights, s_batches, s_program = \
        generate.derived_seeds(seed, 5)
    model, train = cell.config["model"], cell.config["train"]
    src, dst, et, n, num_rel = generate.make_graph(cell.traffic, s_graph)
    _sync(device)
    t0 = time.perf_counter()
    graph = build_graph(src, dst, et, n, num_rel=num_rel, csr=True,
                        device=device)
    _sync(device)
    graph_build_s = time.perf_counter() - t0
    if graph.num_nodes != generate.padded_nodes(n):
        raise RuntimeError(f"the program padded {n} nodes to "
                           f"{graph.num_nodes} rows, not "
                           f"{generate.padded_nodes(n)}")
    return {
        "edges": (src, dst, et), "num_nodes": n, "num_rel": num_rel,
        "graph": graph, "graph_build_s": graph_build_s,
        "node_emb": generate.make_embeddings(n, model["in_dim"], s_emb,
                                             device),
        "weights": generate.make_weights(model, num_rel, s_weights, device),
        "batches": generate.make_batches(
            src, dst, et, n, train["train_batch_size"], train["num_neg"],
            MAX_BATCHES, s_batches, device),
        "program_seed": s_program,
    }


def make_program(cell: Cell, inputs: dict, **kw) -> Program:
    return Program(cell.config, inputs["weights"], inputs["node_emb"],
                   inputs["graph"], inputs["batches"], inputs["num_rel"],
                   int(inputs["edges"][0].shape[0]), inputs["program_seed"],
                   **kw)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None,
             fault: Optional[str] = None) -> dict:
    """One run. Returns the result line's fields and the checks."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", time.perf_counter())]
    inputs = make_inputs(cell, seed, device)
    marks.append(("inputs", time.perf_counter()))
    program = make_program(cell, inputs, fault=fault)
    record = program.checked_steps()
    marks.append(("checked_steps", time.perf_counter()))
    for i in range(CHECKED_STEPS, CHECKED_STEPS + EXTRA_WARMUP_STEPS):
        program.run(i)
    _sync(device)
    marks.append(("warmup_steps", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    setup_parts = {"imports": marks[0][1] - t_start}
    setup_parts.update({b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
    setup_parts["graph_build"] = inputs["graph_build_s"]
    win = window(program, CHECKED_STEPS + EXTRA_WARMUP_STEPS, seconds, device)
    traced = traced_steps(program, win["next"], device) if trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del program
    inputs.pop("graph")
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, inputs, device)
    numbers = judge.readings(record, ref)
    correct, checks = judge.judge(numbers, record["finite"], cell.limits)

    model = cell.config["model"]
    rows = inputs["node_emb"].shape[0]
    edges = int(inputs["edges"][0].shape[0])
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    step_s = win["window_s"] / win["steps"]
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": bool(correct), "attempted": win["steps"],
           "failed": win["failed"], "device": device_info, "checks": checks,
           "numbers": numbers, "traced_s": None, "setup_parts": setup_parts}
    if not trace:
        values = {
            "edge_messages_per_s": edges * model["gat_num_layers"]
            * win["steps"] / win["window_s"],
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s,
        }
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        return out
    counts = counting.step_counts(model, rows, edges, inputs["num_rel"],
                                  counting.peaks_of(name))
    layer = LayerRun(step_s=step_s, graph_build_s=inputs["graph_build_s"],
                     counts=counts,
                     groups_s={k: v / TRACED_STEPS
                               for k, v in traced["groups_s"].items()},
                     busy_s=traced["busy_s"] / TRACED_STEPS,
                     config=cell.config, traffic=cell.traffic,
                     shape={"rows": rows, "edges": edges,
                            "num_rel": inputs["num_rel"],
                            "window_steps": win["steps"]},
                     trace=traced)
    metrics = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(layer)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del layer
    traced.pop("profile")
    out["metrics"] = metrics
    out["device"].update(busy_s=traced["busy_s"],
                         window_s=traced["traced_s"])
    out["breakdown"] = {
        "device_ops": [[k, s] for k, s in traced["kernels"][:BREAKDOWN_TOP]],
        "idle_gaps": [[k, s] for k, s in traced["gaps"][:BREAKDOWN_TOP]],
    }
    out["traced_s"] = traced["traced_s"]
    return out


def result_line(out: dict) -> dict:
    """The last line of standard output: the result's keys, the checks
    last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line
