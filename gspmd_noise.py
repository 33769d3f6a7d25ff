#!/usr/bin/env python3
"""How far the plain route's own rounding moves the gspmd check.

On a card, at ``chip_smoke.py``'s gspmd setting (``TRAIN``'s model on
``PARITY``'s 20k-node graph, fp32, dropout off, the plain route): the
one-device run's first-step gradient three times with ``index_add_``'s
atomic sums and twice with ``ops.segment.segment_sum`` (sorted, the same
bits every call), per leaf as ||a-b|| / ||b|| between runs; then the
(1, 2, 1) gspmd grid twice against the sorted one-device run, as
``chip_smoke.py``'s ``grid_routes`` holds it; and the time of one segment
sum each way at the plain propagate's widths. The result line goes to
stdout and ``--out``.

    python3 gspmd_noise.py [--out DIR]
"""

import argparse
import itertools
import json
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from relgat_projector_tpu_torch.ops import relgat_ops, segment

SORTED_SUM = segment.segment_sum


def atomic_sum(data, segment_ids, num_segments):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def use_sum(fn):
    segment.segment_sum = relgat_ops.segment_sum = fn


def one_device(ref_path=None):
    """The one-device gspmd-graph run: (first-step gradient, leaf names,
    step ms); saved for the grid's ranks when ``ref_path`` is given."""
    (src, dst, et, emb, batches), n = cs.route_inputs("gspmd")
    graph = cs.build_graph(src, dst, et, n, num_rel=cs.TRAIN["num_rel"],
                           device=cs.DEVICE)
    node_emb = torch.from_numpy(
        cs.pad_node_embeddings(emb, graph.num_nodes)).to(cs.DEVICE)
    bf16, model = cs.route_model("gspmd", "fp32")
    mcfg, tcfg, opt, sched, state = cs.halo_setup(bf16, cs.DEVICE, **model)
    init = [p.detach().cpu() for p in cs.tree_leaves(state.params)]
    snapshots = []
    state, rec = cs.halo_steps(cs.make_train_step(mcfg, tcfg, opt, sched),
                               state, node_emb, graph, batches, snapshots)
    if ref_path is not None:
        cs.save_reference(ref_path, init, opt.grads, snapshots)
    return opt.grads[0], cs.leaf_names(state.params), rec["step_ms"]


def leaf_errors(a, b, names):
    return {n: cs.l2_rel_err(x, y) for n, x, y in zip(names, a, b)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    rec = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]}
    with tempfile.TemporaryDirectory(prefix="gspmd_noise_") as tmp:
        work = Path(tmp)
        use_sum(atomic_sum)
        atomic = [one_device() for _ in range(3)]
        names = atomic[0][1]
        rec["atomic_pairs"] = [
            leaf_errors(atomic[i][0], atomic[j][0], names)
            for i, j in itertools.combinations(range(3), 2)]
        use_sum(SORTED_SUM)
        ordered = [one_device(work / cs.REF_FILES["gspmd"])
                   for _ in range(2)]
        rec["sorted_same_bits"] = all(
            torch.equal(a, b) for a, b in zip(ordered[0][0], ordered[1][0]))
        rec["sorted_against_atomic"] = [
            leaf_errors(ordered[0][0], g, names) for g, _, _ in atomic]
        rec["step_ms"] = dict(atomic=[a[2] for a in atomic],
                              sorted=[o[2] for o in ordered])
        rec["grids"] = []
        for _ in range(2):
            cs.spawn_ranks("routes", 2, work, grid=(1, 2, 1),
                           runs=[("gspmd", "fp32")])
            rec["grids"].append([
                {k: r[0][k] for k in ("rank", "grad_err", "grad_err_leaf",
                                      "grad_err_by_step", "ranks_agree")}
                for r in (json.loads((work / f"routes_1x2x1_{i}.json")
                                     .read_text()) for i in range(2))])
    e, n = cs.PARITY["num_edges"], cs.PARITY["num_nodes"]
    hf = cs.TRAIN["heads"] * cs.TRAIN["feat"]
    ids = torch.randint(0, n, (e,), device=cs.DEVICE).sort().values
    data = torch.randn((e, hf), device=cs.DEVICE)
    rec["sum_ms"] = {name: cs.cuda_ms(lambda: fn(data, ids, n), 10)
                     for name, fn in (("atomic", atomic_sum),
                                      ("sorted", SORTED_SUM))}
    line = json.dumps({"gspmd_noise": rec})
    print(line)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "gspmd_noise.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
