"""Device time and idle gaps of the benchmark's traced steps, by span.

    python3 scripts/span_table.py --workload <cell> --seed <n> [--seconds 10]
        [--root DIR] [--out DIR]

Builds a cell of ``BENCHMARK.json`` as ``benchmark/run.py`` does (inputs
from the seed, the port's graph, state and train step), runs five steps,
times ``--seconds`` of untraced steps with ``benchmark.harness.window``,
then profiles ``benchmark.harness.TRACED_STEPS`` steps with
``benchmark.harness.traced_steps``. It prints one JSON line: the untraced
and the traced step, the harness's kernel-name groups (``devtrace``), and,
where the port has them (``utils/profiling.py``), the traced steps' device
time by span, by phase, by span and kernel group, the top elementwise
kernels by span, the idle gaps by the span the stepping thread was in and
by the span of the operation each gap ends in, the checks of the split
against the harness's groups, and, where the port has them, the head's
fused-block launches a window step (``head_counts`` of
``ops/cuda/gelu_layernorm.py``) and the propagate's kernel launches a
window step by wrapper and design (``design_counts`` of
``ops/cuda/fused.py``), the bf16 ring src pass's launches a window
step by loop (``ring_loop_counts``), and the GAT layers' tail launches a
window step (``tail_counts`` of ``ops/cuda/layer_tail.py``). ``--root`` imports the port and the
benchmark from another checkout (to time two versions side by side);
``--out`` also writes the line to ``DIR/<cell>.<seed>.json``.
Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

WARM_STEPS = 5
TOP = 3


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def _sum(rows):
    out = {}
    for key, seconds in rows:
        out[key] = out.get(key, 0.0) + seconds
    return out


def idle_before(ops):
    """``(span, seconds)`` of each idle gap, by the span of the device
    operation that ends it (what the device waited to start)."""
    end = None
    for o in ops:  # in start order
        stop = o.start_ns + round(o.seconds * 1e9)
        if end is not None and o.start_ns > end:
            yield o.span, (o.start_ns - end) / 1e9
        end = stop if end is None else max(end, stop)


def split(prof, steps, devtrace):
    """The traced steps' split by span, per step (ms), and its checks."""
    from relgat_projector_tpu_torch.utils import profiling

    ops = profiling.device_ops(prof)
    ms = 1e3 / steps
    total = sum(s for _, s in devtrace.device_time_by_kernel(prof))
    groups = devtrace.grouped_seconds(devtrace.device_time_by_kernel(prof))
    by_span = _sum((o.span, o.seconds) for o in ops)
    by_group = _sum(((o.span, devtrace.group_of(o.name)), o.seconds)
                    for o in ops)
    other = {}
    for o in ops:
        if devtrace.group_of(o.name) == "other":
            other.setdefault(o.name, {}).setdefault(o.span, 0.0)
            other[o.name][o.span] += o.seconds
    top = sorted(other.items(), key=lambda kv: -sum(kv[1].values()))[:TOP]
    gemm_spans = ("relgat/project", "relgat/head", "relgat/score")
    gemm = sum(s for (sp, g), s in by_group.items()
               if g == "gemm" and sp in gemm_spans)
    prop = by_group.get(("relgat/propagate", "propagate"), 0.0)
    return {
        "device_ms": total * ms,
        "span_ms": {k: v * ms for k, v in sorted(by_span.items())},
        "phase_ms": {k: v * ms for k, v in sorted(
            _sum((o.phase, o.seconds) for o in ops).items())},
        "span_phase_ms": {f"{sp} {ph}": v * ms for (sp, ph), v in sorted(
            _sum(((o.span, o.phase), o.seconds) for o in ops).items())},
        "span_group_ms": {f"{sp} {g}": v * ms
                          for (sp, g), v in sorted(by_group.items())},
        "top_elementwise": [
            {"kernel": name[:120], "ms": sum(spans.values()) * ms,
             "by_span_ms": {k: v * ms for k, v in spans.items()}}
            for name, spans in top],
        "unattributed": [  # the first few, by their place in the trace
            {"kernel": o.name[:80], "phase": o.phase, "index": i,
             "of": len(ops), "ms": o.seconds * 1e3}
            for i, o in enumerate(ops)
            if o.span == profiling.UNATTRIBUTED][:TOP],
        "idle_ms": {k: v * ms for k, v in
                    profiling.idle_by_span(prof).items()},
        "idle_before_ms": {k: v * ms for k, v in
                           _sum(idle_before(ops)).items()},
        "checks": {
            "spans_over_total": sum(by_span.values()) / total - 1.0
            if total else None,
            "unattributed_share": by_span.get(profiling.UNATTRIBUTED, 0.0)
            / total if total else None,
            "gemm_over_group": gemm / groups["gemm"] - 1.0
            if groups["gemm"] else None,
            "propagate_over_group": prop / groups["propagate"] - 1.0
            if groups["propagate"] else None,
        },
    }


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from benchmark import devtrace, harness
    from relgat_projector_tpu_torch.utils import profiling

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("span_table: no CUDA device", file=sys.stderr)
        return 2
    inputs = harness.make_inputs(cell, args.seed, "cuda")
    program = harness.make_program(cell, inputs)
    for i in range(WARM_STEPS):
        program.run(i)
    try:  # the head's fused-block counters, where the port has them
        from relgat_projector_tpu_torch.ops.cuda import gelu_layernorm
    except ImportError:
        gelu_layernorm = None
    try:  # the layers' tail counters, where the port has them
        from relgat_projector_tpu_torch.ops.cuda import layer_tail
    except ImportError:
        layer_tail = None
    from relgat_projector_tpu_torch.ops.cuda import fused
    designs = hasattr(fused, "design_counts")  # where the port has them
    if gelu_layernorm is not None:
        gelu_layernorm.reset_head_counts()
    if layer_tail is not None:
        layer_tail.reset_tail_counts()
    if designs:
        fused.reset_design_counts()
    win = harness.window(program, WARM_STEPS, args.seconds, "cuda")
    head_counts = (None if gelu_layernorm is None else
                   {k: v / win["steps"]
                    for k, v in gelu_layernorm.head_counts().items()})
    tail_counts = (None if layer_tail is None else
                   {k: v / win["steps"]
                    for k, v in layer_tail.tail_counts().items()})
    design_counts = ({k: v / win["steps"]
                      for k, v in fused.design_counts().items()}
                     if designs else None)
    ring_loops = ({k: v / win["steps"]
                   for k, v in fused.ring_loop_counts().items()}
                  if hasattr(fused, "ring_loop_counts") else None)
    traced = harness.traced_steps(program, win["next"], "cuda")
    steps = traced["steps"]
    line = {
        "workload": args.workload, "seed": args.seed,
        "root": str(Path(args.root).resolve()),
        "device": torch.cuda.get_device_name(0),
        "step_ms": 1e3 * win["window_s"] / win["steps"],
        "window_steps": win["steps"],
        "traced_step_ms": 1e3 * traced["traced_s"] / steps,
        "groups_ms": {k: 1e3 * v / steps
                      for k, v in traced["groups_s"].items()},
        "busy_ms": 1e3 * traced["busy_s"] / steps,
        "gaps_ms": {k: 1e3 * v / steps for k, v in traced["gaps"][:6]},
        "head_counts_per_step": head_counts,
        "tail_counts_per_step": tail_counts,
        "design_counts_per_step": design_counts,
        "ring_loop_counts_per_step": ring_loops,
    }
    if hasattr(profiling, "device_ops"):
        t0 = time.perf_counter()
        line.update(split(traced["profile"], steps, devtrace))
        line["read_s"] = time.perf_counter() - t0
    text = json.dumps(line)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.workload}.{args.seed}.json").write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
