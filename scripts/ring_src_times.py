"""Device time of the bf16 src pass by kernel, on a benchmark traffic's graph.

    python3 scripts/ring_src_times.py [--traffic zipf-inv-10m,...]
        [--shapes 12x256,...] [--seed 0] [--reps 10] [--root DIR] [--out DIR]

For each traffic (a name of ``benchmark/traffic/<name>.json``, or the path
of such a file) draws its graph from the seed as
the benchmark does (``benchmark/generate.py``), lays it out through the
port (``build_graph``), and at each HEADSxFEATURES makes
``chip_smoke.py``'s kernel inputs and the bf16 forward's statistics
(``chip_smoke.variant_calls``). Then it times ``relgat_bwd_src_bf16`` in
the design its dispatch takes: CUDA events around ``--reps`` calls after
two warm-up calls (``call_ms``, the mean), and a ``torch.profiler`` pass
over ``--reps`` more whose device time it sums a call by kernel (the ring
loop, and where the port has them its logits and fold kernels, the merge).
Where the port has both loops of the bf16 ring it also times each forced
(``loops_ms``: ``factored``, the design ``"ring"``, and ``per_edge``,
``"ring_per_edge"``) and, where the dispatch takes the ring, names the
loop it takes (``ring_loop``).
Beside them the row-gather floor, one H*F bf16 row an edge over 3.35 TB/s.
``--root`` imports the port, ``chip_smoke`` and the benchmark from another
checkout; one process times one tree, so to compare two trees run it once
from each. One JSON line a shape, with the card's name and power limit;
needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--traffic", default="zipf-inv-10m")
    p.add_argument("--shapes", default="12x256")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def by_kernel(prof, calls):
    """Device ms a call of each kernel in the profile, longest first."""
    rows = {}
    for evt in prof.key_averages():
        kind = getattr(evt, "device_type", None)
        if kind is None or kind.name != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows[evt.key] = rows.get(evt.key, 0.0) + us / 1e3 / calls
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ring_src_times: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lines = []
    for name in args.traffic.split(","):
        lines += traffic_lines(args, root, name, card)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with (out / "ring_src_times.jsonl").open("a") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


def traffic_lines(args, root, name, card):
    import torch

    import chip_smoke as cs
    from benchmark import generate
    from relgat_projector_tpu_torch.data.graph import build_graph
    from relgat_projector_tpu_torch.ops import cuda as kern

    path = Path(name)
    if path.suffix != ".json":
        path = root / "benchmark" / "traffic" / f"{name}.json"
    traffic = json.loads(path.read_text())
    src, dst, et, n, num_rel = generate.make_graph(
        traffic, generate.derived_seeds(args.seed, 1)[0])
    graph = build_graph(src, dst, et, n, num_rel=num_rel, csr=True,
                        device="cuda")
    csr = graph.csr
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    lines = []
    for shape in args.shapes.split(","):
        heads, feat = (int(x) for x in shape.split("x"))
        inputs = cs.make_kernel_inputs(csr, graph.num_nodes, heads, feat,
                                       num_rel, cs.SEED + 7)
        calls, _ = cs.variant_calls(inputs, True, kw)
        name = "relgat_bwd_src_bf16"
        call = calls[name]
        ms = cs.cuda_ms(lambda: call(kern.relgat_bwd_src_bf16),
                        reps=args.reps, warmup=2)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                call(kern.relgat_bwd_src_bf16)
            torch.cuda.synchronize()
        design = kern.design_of(kern.relgat_bwd_src_bf16, heads, feat)
        loops, ring_loop = {}, None
        if hasattr(kern, "kernel_of"):
            ring_loop = kern.RING_LOOPS.get(kern.kernel_of(
                kern.relgat_bwd_src_bf16, heads, feat, num_rel,
                num_edges=csr.num_edges, num_src=csr.num_src))
        elif hasattr(kern, "ring_src_loop") and design == "ring":
            # a checkout whose C entry points pick the loop from the design
            ring_loop = kern.ring_src_loop(csr.num_edges, csr.num_src,
                                           num_rel)
        if hasattr(kern, "ring_src_loop") and feat > 128:
            for loop, forced in (("factored", "ring"),
                                 ("per_edge", "ring_per_edge")):
                loops[loop] = cs.cuda_ms(
                    lambda: call(lambda *a, **k: kern.with_design(
                        kern.relgat_bwd_src_bf16, forced, *a, **k)),
                    reps=args.reps, warmup=2)
        floor = 2 * csr.num_edges * heads * feat / PEAK_BYTES_PER_S * 1e3
        line = {
            "root": str(root), "traffic": traffic["name"], "seed": args.seed,
            "heads": heads, "feat": feat, "num_rows": graph.num_nodes,
            "num_edges": csr.num_edges, "num_rel": num_rel,
            "edges_per_row_rel": csr.num_edges / (graph.num_nodes * num_rel),
            "design": design,
            "ring_loop": ring_loop, "call_ms": ms, "loops_ms": loops,
            "row_gather_floor_ms": floor,
            "kernels_ms": by_kernel(prof, args.reps),
            "card": card, "device": torch.cuda.get_device_name(0),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
        del calls, inputs
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    sys.exit(main())
