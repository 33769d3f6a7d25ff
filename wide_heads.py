#!/usr/bin/env python3
"""Time the wide-head forward and src pass in both designs, the ring kernel
and the one-warp-a-head template, on one NVIDIA GPU: the measurements the
width rule ``ops.cuda.design_of`` follows.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 wide_heads.py [--shapes 12x300,16x200,...] [--reps 20] [--out DIR]

On ``chip_smoke.py``'s ``TRAIN`` graph (a seeded uniform graph of 100,000
nodes, 1,000,000 edges and 40 relations) and its kernel inputs, for each
(heads, features) shape and for fp32 and bf16 rows, ``chip_smoke``'s
``design_times``: ``relgat_fwd`` and ``relgat_bwd_src`` (or their bf16
variants) through each design, timed with CUDA events (mean of ``--reps``
calls after two warm-up calls), and the design the dispatch takes (for the bf16 src pass
``ring_ms`` is its factored loop, ``ring_per_edge_ms`` its per-edge one,
and ``ring_loop`` the one its dispatch takes on this graph), beside
the row-gather floor (one H*F row an edge over 3.35 TB/s) and the bound of
``chip_smoke.bounds``. It only times: ``chip_smoke.py`` holds both designs
to their float64 plain versions. One JSON line a (shape, variant, kernel),
the card's name and power limit, and a last line ``{"ok": true, ...}``;
exits non-zero without a card.
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

# The model's widths (12 x 300, 16 x 200, 12 x 256), the tiles of head
# tensor parallelism chip_smoke.py holds (4 x 512, 2 x 1024, 3 x 301),
# widths across each of the template's buckets (F <= 256, 512, 1024) at
# about 3,000 features a row, and a few of them at 2 or 3 heads.
SHAPES = ("12x300,16x200,12x256,4x512,2x1024,3x301,23x136,18x168,13x232,"
          "12x264,10x301,9x336,8x384,7x448,6x512,6x520,5x640,4x768,3x896,"
          "3x1024,20x152,14x216,12x248,9x352,8x368,6x480,6x496,5x576,"
          "3x264,3x384,3x448,2x300,3x512")


def shape_rows(csr, n, heads, feat, reps, card):
    """The rows of one shape: each variant's forward and src pass."""
    t = cs.TRAIN
    inputs = cs.make_kernel_inputs(csr, n, heads, feat, t["num_rel"],
                                   cs.SEED + 7)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    rows = []
    for bf16 in (False, True):
        calls, v = cs.variant_calls(inputs, bf16, kw)
        fwd, src, _ = cs.VARIANTS[bf16]
        times = cs.design_times(calls, (fwd, src), heads, feat, reps=reps,
                                csr=csr, num_rel=t["num_rel"])
        nbytes = cs.bounds(n, csr.num_edges, heads, feat, t["num_rel"],
                           row_bytes=v["rh"].element_size())
        for name, kind in ((fwd, "relgat_fwd"), (src, "relgat_bwd_src")):
            best, by = cs.bound_ms(*nbytes[kind])
            row = {"name": name, "heads": heads, "feat": feat, **times[name],
                   "row_gather_bytes": (v["rh"].element_size()
                                        * csr.num_edges * heads * feat)}
            row.update(cs.row_gather_floor(row))
            row.update({"ring_over_lanes": row["ring_ms"] / row["lanes_ms"],
                        "bound_ms": best, "bound_by": by, "card": card})
            print(json.dumps(row), flush=True)
            rows.append(row)
        del calls, v
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated HEADSxFEATURES, each F > 128")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_heads: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t = cs.TRAIN
    src, dst, et, _, _ = cs.train_inputs(np.random.default_rng(cs.SEED))
    graph = build_graph(src, dst, et, t["num_nodes"], num_rel=t["num_rel"],
                        csr=True, device="cuda")
    rows = []
    for shape in args.shapes.split(","):
        heads, feat = (int(x) for x in shape.split("x"))
        rows += shape_rows(graph.csr, graph.num_nodes, heads, feat,
                           args.reps, card)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "wide_heads.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    print(card)
    print(json.dumps({"ok": True, "rows": len(rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
