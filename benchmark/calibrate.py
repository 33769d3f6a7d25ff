"""Readings that the comparison's limits are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        [--first-seed N] [--control 3] [--faults 3] [--out FILE]

For each seed it makes the cell's inputs once, runs the plain reference's
three steps once, and then the program's checked steps (the same set-up
and step as a run's, without the window): sound, and on the first
``--control`` seeds the configuration's control (its ``control`` entry:
the program's own path in the nearest lower precision), and on the first
``--faults`` seeds each planted fault (``harness._fault``). One JSON line
a reading, then a summary: the lower reading (the largest over sound
runs) and the least reading of the control and of each fault, number by
number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, judge

    cell = harness.load_cell(args.workload)
    device = "cuda"
    name = torch.cuda.get_device_name(0)
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        inputs = harness.make_inputs(cell, seed, device)
        t0 = time.perf_counter()
        ref = harness.reference_steps(cell, inputs, device)
        ref_s = time.perf_counter() - t0
        kinds = [("sound", {})]
        if k < args.control:
            kinds.append(("control", {"variant": cell.config["control"]["model"]}))
        if k < args.faults:
            kinds += [("half_batch", {"fault": "half_batch"}),
                      ("unchanged", {"fault": "unchanged"})]
        for kind, kw in kinds:
            t0 = time.perf_counter()
            program = harness.make_program(cell, inputs, **kw)
            record = program.checked_steps()
            del program
            steps_s = time.perf_counter() - t0
            nums = judge.readings(record, ref)
            emit({"workload": cell.name, "seed": seed, "kind": kind,
                  "card": name, **{n: nums[n] for n in judge.NUMBERS},
                  "grad_leaf": nums["grad_leaf"],
                  "grad_leaves": nums["grad_leaves"],
                  "change_leaf": nums["change_leaf"],
                  "left_out": nums["left_out"], "finite": record["finite"],
                  "losses": record["losses"], "ref_losses": ref["losses"],
                  "reference_s": ref_s, "checked_steps_s": steps_s})
        del inputs, ref
        torch.cuda.empty_cache()

    summary = {"workload": cell.name, "card": name, "summary": True}
    for kind in ("sound", "control", "half_batch", "unchanged"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind == "sound" else min
            summary[kind] = {n: pick(r[n] for r in got) for n in judge.NUMBERS}
            summary[kind]["seeds"] = len(got)
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
