"""The plain reference's room on the card beside the program's, at sizes
that no cell runs (not run by the benchmark's own runs).

    python3 benchmark/reference_room.py --workload <cell> --nodes N [N ...] \
        [--remat] [--seed S] [--program-only] [--reference-twice] [--out FILE]

For each ``N`` it scales the cell's traffic to ``N`` nodes at the
traffic's own ratio of base edges to nodes, makes the inputs
through ``harness.make_inputs``, runs the program's three checked steps (with
``--remat`` the configuration's ``remat`` on) and reads the card's peak
from the start, frees the program and its graph, then runs
``harness.reference_steps`` and reads the peak from there, and compares
the two by ``judge.readings`` against the cell's limits; with
``--reference-twice`` it runs the reference a second time and says
whether every loss, gradient and parameter has the same bits. One JSON
line a size.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def same_bits(a: dict, b: dict) -> bool:
    import torch

    return (a["losses"] == b["losses"]
            and a["raw_grad_norms"] == b["raw_grad_norms"]
            and all(torch.equal(a[key][k], b[key][k])
                    for key in ("first_grad", "params") for k in a[key]))


def measure(cell, nodes: int, seed: int, remat: bool, program_only: bool,
            twice: bool) -> dict:
    import torch

    from benchmark import harness, judge

    base = cell.traffic
    ratio = base["num_edges"] / base["num_nodes"]
    cell.traffic = dict(base, num_nodes=nodes, num_edges=round(ratio * nodes))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        inputs = harness.make_inputs(cell, seed, "cuda")
        inputs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = harness.make_program(
            cell, inputs, variant={"remat": True} if remat else None)
        record = program.checked_steps()
        torch.cuda.synchronize()
        row = {"workload": cell.name, "nodes": nodes,
               "rows": int(inputs["node_emb"].shape[0]),
               "edges": int(inputs["edges"][0].shape[0]), "remat": remat,
               "seed": seed, "card": torch.cuda.get_device_name(0),
               "power_limit_w": harness.power_limit_w(),
               "inputs_s": inputs_s,
               "program_s": time.perf_counter() - t0,
               "program_peak_bytes": torch.cuda.max_memory_allocated(),
               "finite": record["finite"]}
        del program
        inputs.pop("graph")
        torch.cuda.empty_cache()
        if program_only:
            return row
        torch.cuda.reset_peak_memory_stats()
        row["reference_start_bytes"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ref = harness.reference_steps(cell, inputs, "cuda")
        torch.cuda.synchronize()
        row["reference_s"] = time.perf_counter() - t0
        row["reference_peak_bytes"] = torch.cuda.max_memory_allocated()
        numbers = judge.readings(record, ref)
        correct, checks = judge.judge(numbers, record["finite"], cell.limits)
        row.update({n: numbers[n] for n in judge.NUMBERS})
        row.update(correct=correct, checks=checks,
                   grad_leaf=numbers["grad_leaf"],
                   change_leaf=numbers["change_leaf"])
        if twice:
            t0 = time.perf_counter()
            again = harness.reference_steps(cell, inputs, "cuda")
            torch.cuda.synchronize()
            row["reference_again_s"] = time.perf_counter() - t0
            row["same_bits"] = same_bits(ref, again)
        return row
    finally:
        cell.traffic = base


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--nodes", type=int, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=3_100_000_000)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--program-only", action="store_true")
    p.add_argument("--reference-twice", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("reference_room: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for nodes in args.nodes:
        row = measure(cell, nodes, args.seed, args.remat, args.program_only,
                      args.reference_twice)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
