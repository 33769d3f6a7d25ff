#!/usr/bin/env python3
"""Time the src pass at several work-item sizes on graphs of several degree
profiles, on one NVIDIA GPU: the measurements the src pass's item size
(``data/csr.py`` ``BWD_ITEM_EDGES``) follows.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 src_plans.py [--sizes 32,64,...,none] [--shapes 16x128,12x300]
                         [--graphs uniform,...] [--passes 2] [--reps 10]
                         [--out DIR]

Graphs, each of ``chip_smoke.py``'s ``TRAIN`` nodes (100,000) and 40
relations: ``uniform``, ``TRAIN``'s own 1M-edge graph (mean out-degree 10);
``uniform_8m``, ``chip_smoke``'s 8M-edge graph (mean 80, so small items
split ordinary rows); ``zipf``, ``chip_smoke``'s zipf graph (dst drawn with
p ~ 1/rank: in-degree hubs); ``zipf_src``, the same graph with src and dst
swapped (out-degree hubs, up to 82,541 out-edges a row); ``zipf_src_last``,
that graph with its node ids reversed, so that the hubs are the last source
rows and their chunks the last blocks to start (on ``zipf_src`` they are
the first: a hub's ids there follow its rank), the case where large items
leave a tail. For each graph,
(heads, features) shape and variant (``relgat_bwd_src``, fp32 rows, and
``relgat_bwd_src_bf16``, bf16 rows), the forward kernel makes the
statistics once; then the src pass is timed with CUDA events (mean of
``--reps`` calls after one warm-up call) through the layout's src-pass work
plan rebuilt at each item size (``data.csr.with_bwd_plan``; ``none``: one
item a row, as before the plan), ``--passes`` times over all sizes, with
the plan's split rows and partial slots, and its outputs' largest distance
from the unsplit plan's (max|a-b| / max|b|; the sums differ only in their
order). Each row names the kernel the dispatch takes
(``ops.cuda.kernel_of``: the ring kernel at 12 x 300).

One JSON line a (graph, shape, variant, pass, size), then a ``summary``
line: each size's worst time over every graph, shape, variant and pass
against that case's best size, and the sizes within 3% of the best
everywhere (sizes that give a case the same plan share their least time
there, ``summary``), and each graph's ``plan_spread``: the largest ratio of
one plan's slowest to its fastest time over the sizes and passes that ran
it, the run's resolution on that graph; the card's name and power limit,
and a last line ``{"ok": true, ...}``. Exits non-zero without a card.
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
from relgat_projector_tpu_torch.data.csr import with_bwd_plan
from relgat_projector_tpu_torch.data.graph import build_graph

SIZES = "32,64,128,256,512,1024,none"
SHAPES = "16x128,12x300"
WITHIN = 1.03  # a size within 3% of a case's best counts as the best there


def graphs():
    """(name, src, dst, etype) of the five graphs, as chip_smoke makes
    them."""
    t = cs.TRAIN
    src, dst, et, _, _ = cs.train_inputs(np.random.default_rng(cs.SEED))
    yield "uniform", src, dst, et
    rng = np.random.default_rng(cs.SEED + 17)  # phase_edges_8m's graph
    n, e = t["num_nodes"], cs.EDGES_8M["num_edges"]
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    yield "uniform_8m", src, dst, rng.integers(0, t["num_rel"], e)
    src, dst, et = cs.zipf_graph(np.random.default_rng(cs.SEED + 11))
    yield "zipf", src, dst, et
    yield "zipf_src", dst, src, et
    yield "zipf_src_last", n - 1 - dst, n - 1 - src, et


def case_rows(name, csr, n, heads, feat, sizes, passes, reps, card):
    """The timed rows of one graph at one shape, both variants."""
    t = cs.TRAIN
    inputs = cs.make_kernel_inputs(csr, n, heads, feat, t["num_rel"],
                                   cs.SEED + 7)
    kw = dict(seed=None, rate=0.0, negative_slope=0.2, eps=1e-16)
    outdeg = np.diff(csr.src_ptr.cpu().numpy())
    plans = {size: with_bwd_plan(csr, max(1, int(outdeg.max()))
                                 if size == "none" else int(size))
             for size in sizes}
    rows = []
    for bf16 in (False, True):
        fwd, bwd_src, _ = cs.VARIANTS[bf16]
        calls, v = cs.variant_calls(inputs, bf16, kw)
        args = (v["rh"], v["rg"], inputs["attn"], v["m"], v["l"],
                v["s_dot"], v["gsum"])
        src_pass = cs.KERNELS[bwd_src]
        want = src_pass(*args, plans["none"], **kw)
        for p in range(passes):
            for size, plan in plans.items():
                got = src_pass(*args, plan, **kw)
                err = max(cs.rel_err(a, b) for a, b in zip(got, want))
                del got
                ms = cs.cuda_ms(lambda: src_pass(*args, plan, **kw),
                                reps=reps, warmup=1)
                row = {"graph": name, "name": bwd_src, "heads": heads,
                       "feat": feat, "pass": p, "item_edges": size,
                       "ms": ms, "split_rows": plan.bwd_num_split,
                       "partial_slots": plan.bwd_num_parts,
                       "work_items": plan.bwd_num_items,
                       "max_out_degree": int(outdeg.max()),
                       "max_rel_err_vs_unsplit": err,
                       "kernel": cs.kern.kernel_of(
                           src_pass, heads, feat, t["num_rel"],
                           num_edges=plan.num_edges, num_src=plan.num_src),
                       "card": card}
                print(json.dumps(row), flush=True)
                rows.append(row)
        del calls, v, want, args
        torch.cuda.empty_cache()
    return rows


def summary(rows, sizes):
    """Each size's worst ratio to its case's best, over every case and
    pass, and the sizes within ``WITHIN`` of the best everywhere. Sizes
    that give a case the same plan (no row split at either: one item a
    row) launch the same work, so a plan's time is the least of theirs:
    their differences are the run's spread, not the size's
    (``raw_worst_over_best`` keeps each size's own times)."""
    def case(r):
        return (r["graph"], r["name"], r["heads"], r["feat"], r["pass"])

    def plan(r):
        return case(r) + (r["split_rows"], r["partial_slots"],
                          r["work_items"])

    plan_ms, best = {}, {}
    for r in rows:
        plan_ms[plan(r)] = min(plan_ms.get(plan(r), np.inf), r["ms"])
        best[case(r)] = min(best.get(case(r), np.inf), r["ms"])
    worst = {size: 0.0 for size in sizes}
    raw = {size: 0.0 for size in sizes}
    slowest = {}
    for r in rows:
        size = r["item_edges"]
        worst[size] = max(worst[size], plan_ms[plan(r)] / best[case(r)])
        raw[size] = max(raw[size], r["ms"] / best[case(r)])
        key = plan(r)[:4] + plan(r)[5:]  # one plan over every pass
        slowest[key] = max(slowest.get(key, 0.0), r["ms"])
    fastest = {}
    for key, ms in plan_ms.items():
        k = key[:4] + key[5:]
        fastest[k] = min(fastest.get(k, np.inf), ms)
    spread = {}
    for k, ms in slowest.items():
        spread[k[0]] = max(spread.get(k[0], 1.0), ms / fastest[k])
    return {"summary": True, "worst_over_best": worst,
            "raw_worst_over_best": raw, "plan_spread": spread,
            "within": WITHIN,
            "sizes_within": [s for s in sizes if worst[s] <= WITHIN]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=SIZES,
                    help="comma-separated most edges an item, or none")
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated HEADSxFEATURES")
    ap.add_argument("--graphs", default=None,
                    help="comma-separated graphs to time (default: all)")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("src_plans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sizes = args.sizes.split(",")
    t = cs.TRAIN
    rows = []
    chosen = None if args.graphs is None else set(args.graphs.split(","))
    for name, src, dst, et in graphs():
        if chosen is not None and name not in chosen:
            continue
        graph = build_graph(src, dst, et, t["num_nodes"],
                            num_rel=t["num_rel"], csr=True, device="cuda")
        for shape in args.shapes.split(","):
            heads, feat = (int(x) for x in shape.split("x"))
            rows += case_rows(name, graph.csr, graph.num_nodes, heads, feat,
                              sizes, args.passes, args.reps, card)
        del graph
        torch.cuda.empty_cache()
    result = summary(rows, sizes)
    print(json.dumps(result), flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "src_plans.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows + [result]))
    print(card)
    print(json.dumps({"ok": True, "rows": len(rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
