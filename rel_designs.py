#!/usr/bin/env python3
"""Time relgat_bwd_rel_bf16 in both designs, the tensor cores ("mma") and
the SIMT tile kernel ("tile"), on one NVIDIA GPU: the measurements the
dispatch rule ``ops.cuda.design_of`` (``MMA_RANGES``) follows.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 rel_designs.py [--shapes 16x128,12x300,...] [--passes 2]
                           [--reps 20] [--out DIR]

On ``chip_smoke.py``'s ``TRAIN`` graph (a seeded uniform graph of 100,000
nodes, 1,000,000 edges and 40 relations) and its kernel inputs, for each
(heads, features) shape: the bf16 forward and src pass make W and B, then
``chip_smoke``'s ``design_times`` times relgat_bwd_rel_bf16 through each
design with CUDA events (mean of ``--reps`` calls after two warm-up
calls), beside the design the dispatch takes and the bound of
``chip_smoke.bounds``. Every shape is timed ``--passes`` times, one pass
over all shapes after the other. It only times: ``chip_smoke.py`` and the
``gpu`` tests hold both designs to their float64 plain version. One JSON
line a (pass, shape), the card's name and power limit, and a last line
``{"ok": true, ...}``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from relgat_projector_tpu_torch.data.graph import build_graph

# The model's widths (16 x 128, 12 x 300, 16 x 200, 12 x 256), head tensor
# parallelism's tiles (8 x 128, 4 x 512, 2 x 1024, 3 x 301, 3 x 128,
# 1 x 128), narrow heads and widths across the wide-head range.
SHAPES = ("16x128,12x300,16x200,12x256,8x128,4x512,2x1024,3x301,3x128,"
          "1x128,16x64,4x32,16x32,20x136,18x168,13x232,9x336,8x384,6x520,"
          "5x640,3x896,3x1024")


def shape_row(csr, n, heads, feat, reps, card):
    """relgat_bwd_rel_bf16 at one shape: both designs' times."""
    t = cs.TRAIN
    inputs = cs.make_kernel_inputs(csr, n, heads, feat, t["num_rel"],
                                   cs.SEED + 7)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    calls, v = cs.variant_calls(inputs, True, kw)
    name = cs.VARIANTS[True][2]
    times = cs.design_times(calls, (name,), heads, feat, reps=reps)[name]
    best, by = cs.bound_ms(*cs.bounds(n, csr.num_edges, heads, feat,
                                      t["num_rel"], row_bytes=2)
                           ["relgat_bwd_rel"])
    del calls, v, inputs
    torch.cuda.empty_cache()
    return {"name": name, "heads": heads, "feat": feat, **times,
            "mma_over_tile": times["mma_ms"] / times["tile_ms"],
            "bound_ms": best, "bound_by": by, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated HEADSxFEATURES")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rel_designs: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t = cs.TRAIN
    src, dst, et, _, _ = cs.train_inputs(np.random.default_rng(cs.SEED))
    graph = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                        csr=True, device="cuda")
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    rows = []
    for p in range(args.passes):
        for heads, feat in shapes:
            row = {"pass": p, **shape_row(graph.csr, graph.num_nodes, heads,
                                          feat, args.reps, card)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "rel_designs.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    print(card)
    print(json.dumps({"ok": True, "rows": len(rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
