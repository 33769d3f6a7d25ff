"""The benchmark of relgat_projector_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the run makes every input from
``--seed``, builds the graph and the train state through the program's
normal path, warms up on the cell's shapes, trains for ``--seconds``,
optionally profiles a few more steps (``--trace 1``), compares the first
three steps with the plain reference, and prints one JSON line last on
standard output (the checks also go, last, to standard error).

It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits with code 2 and prints no result. It exits with code 3 and
prints no result if JAX or the JAX package got loaded. Kernel and
compiler caches live in ``.bench_cache/`` and the program's own
``relgat_projector_tpu_torch/_build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Import from the checkout's root (the benchmark and the program), not from
# this folder, whose file names must not shadow other modules.
sys.path[0] = str(ROOT)

CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    numbers = out["numbers"]
    print("benchmark: readings " + ", ".join(
        f"{k} {numbers[k]!r}" for k in harness.judge.NUMBERS), file=sys.stderr)
    print(f"benchmark: worst leaves: gradient {numbers['grad_leaf']}, "
          f"change {numbers['change_leaf']}; left out of the change: "
          f"{', '.join(numbers['left_out']) or 'none'}", file=sys.stderr)
    print("benchmark: set-up seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_parts"].items()),
        file=sys.stderr)
    if out["traced_s"] is not None:
        print(f"benchmark: traced steps {out['traced_s']:.6f} s for "
              f"{harness.TRACED_STEPS}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.result_line(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
