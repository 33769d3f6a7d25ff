#!/usr/bin/env python3
"""Read where a halo grid's first-step gradient departs from one device's.

On a card, at ``chip_smoke.py``'s ``TRAIN`` (fp32, dropout off, the kernel
route): the first step's gradient on one device and on a (1, G) grid whose
ranks share the card over gloo, per leaf as max|a-b| / max|b| and as
||a-b|| / ||b||. Then, for one GAT layer, the (head, relation) of its
attention bank where the two differ most; the source row whose summed logit
gradient W[src, head, relation] differs most (the grid's local and remote
subsets added up by global row); and for each of that row's edges of that
relation: the attention logit from each side's rows (a float64 dot product
of the fp32 rows with the relation's attention vector), the LeakyReLU
derivative that logit selects, W on each side, and the destination's
statistics on each side. The result lines go to stdout and ``--out``.

    python3 halo_reading.py [--graph 4] [--layer 1] [--out DIR]
"""

import argparse
import json
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from relgat_projector_tpu_torch.config import MeshConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.ops import propagate
from relgat_projector_tpu_torch.parallel import (
    initialize_distributed,
    make_grid,
    place_graph,
)
from relgat_projector_tpu_torch.parallel.distributed import shutdown
from relgat_projector_tpu_torch.train.step import loss_and_grads
from relgat_projector_tpu_torch.utils.tree import tree_leaves

T = cs.TRAIN
SLOPE = 0.2  # the propagate's LeakyReLU slope (the layers pass no other)


def step1(graph, node_emb, grid=None, capture=None):
    """The first step's gradient leaves and parameters; with ``capture =
    (head, rel)`` the src pass of every layer keeps that head's W column,
    rows and destination statistics."""
    calls = []
    fwd, bsrc, brel = propagate._KERNELS[False]

    def kept_bsrc(h, g, attn, m, l, s_dot, gsum, csr, **kw):
        res = bsrc(h, g, attn, m, l, s_dot, gsum, csr, **kw)
        hd, rl = capture
        heads = attn.shape[0]
        calls.append({
            "W": res[1][:, hd, rl].cpu(),
            "h": h.detach().view(h.shape[0], heads, -1)[:, hd].float().cpu(),
            "g": g.view(g.shape[0], heads, -1)[:, hd].float().cpu(),
            "m": m[:, hd].cpu(), "l": l[:, hd].cpu(), "s": s_dot[:, hd].cpu(),
        })
        return res

    if capture is not None:
        propagate._KERNELS[False] = (fwd, kept_bsrc, brel)
    mcfg, tcfg, _, _, state = cs.halo_setup(False, cs.DEVICE)
    src, rel, dst = cs.halo_inputs()[4][0]
    weight = torch.ones(T["batch"], device=cs.DEVICE)
    _, _, grads = loss_and_grads(state.params, mcfg, tcfg, node_emb, graph,
                                 src, rel, dst, weight, rng=state.rng,
                                 grid=grid)
    propagate._KERNELS[False] = (fwd, bsrc, brel)
    return ([g.detach().cpu() for g in tree_leaves(grads)],
            [p.detach().cpu() for p in tree_leaves(state.params)], calls)


def rank_main(rank, world, port, work, capture):
    torch.set_num_threads(2)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=cs.DEVICE)
    grid = make_grid(MeshConfig(graph_axis=world))
    src, dst, et, emb, _ = cs.halo_inputs()
    base = build_graph(src, dst, et, T["num_nodes"], num_rel=T["num_rel"],
                       halo_shards=world, halo_overlap=True,
                       device=cs.DEVICE)
    graph = place_graph(base, grid, T["num_rel"], csr=True)
    lo, hi = graph.halo.row_range
    node_emb = torch.from_numpy(np.ascontiguousarray(
        pad_node_embeddings(emb, graph.num_nodes)[lo:hi])).to(cs.DEVICE)
    grads, _, calls = step1(graph, node_emb, grid, capture)
    hg = base.halo
    slot_global = np.concatenate([o * hg.rows_per_shard + hg.send_idx[o, rank]
                                  for o in range(world)])
    torch.save(dict(grads=grads if rank == 0 else None, calls=calls, lo=lo,
                    rows=hg.rows_per_shard, slot_global=slot_global),
               work / f"rank{rank}.pt")
    shutdown()


def spawn(world, work, capture):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    cap = "none" if capture is None else f"{capture[0]},{capture[1]}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--work", str(work),
         "--capture", cap],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise SystemExit(f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def leaf_errors(names, got, want):
    out = {}
    for n, a, b in zip(names, got, want):
        a, b = a.double(), b.double()
        out[n] = dict(max_rel=float((a - b).abs().max() / b.abs().max()),
                      l2_rel=float((a - b).norm() / b.norm()))
    return out


def reading(args, work, emit):
    src, dst, et, emb, _ = cs.halo_inputs()
    graph = build_graph(src, dst, et, T["num_nodes"], num_rel=T["num_rel"],
                        csr=True, device=cs.DEVICE)
    node_emb = torch.from_numpy(
        pad_node_embeddings(emb, graph.num_nodes)).to(cs.DEVICE)
    names = cs.leaf_names(cs.halo_setup(False, cs.DEVICE)[4].params)
    ref, params, _ = step1(graph, node_emb)
    grid = spawn(args.graph, work, None)[0]["grads"]
    errs = leaf_errors(names, grid, ref)
    emit({"what": "step-1 gradient per leaf, grid (1, %d) against one "
                  "device" % args.graph, "leaves": errs})
    leaf = names.index(f"layers[{args.layer}].attn")
    diff = (grid[leaf].double() - ref[leaf].double()).abs()   # [H, R, F]
    hd, rl = np.unravel_index(int(diff.amax(2).argmax()), diff.shape[:2])
    hd, rl = int(hd), int(rl)
    emit({"what": "largest attention-bank difference", "layer": args.layer,
          "head": hd, "relation": rl,
          "by_head": diff.amax((1, 2)).tolist(),
          "by_relation": diff.amax((0, 2)).tolist()})

    # The same step with that head's src-pass inputs and outputs kept.
    back = T["layers"] - 1 - args.layer   # the backward runs the last first
    one = step1(graph, node_emb, capture=(hd, rl))[2][back]
    ranks = spawn(args.graph, work, (hd, rl))
    n = one["W"].shape[0]
    w_grid = torch.zeros(n + ranks[0]["rows"] * args.graph, dtype=torch.float64)
    for r in ranks:
        loc, rem = r["calls"][2 * back], r["calls"][2 * back + 1]
        own = torch.arange(r["lo"], r["lo"] + loc["W"].shape[0])
        w_grid.index_add_(0, own, loc["W"].double())
        w_grid.index_add_(0, torch.from_numpy(r["slot_global"].astype(
            np.int64)), rem["W"].double())
    wdiff = (w_grid[:n] - one["W"].double()).abs()
    s = int(wdiff.argmax())
    attn = params[names.index(f"layers[{args.layer}].attn")][hd, rl].double()
    edges = []
    for e in np.flatnonzero((src == s) & (et == rl)):
        d = int(dst[e])
        q = d // ranks[0]["rows"]
        r = ranks[q]
        loc, rem = r["calls"][2 * back], r["calls"][2 * back + 1]
        if s // ranks[0]["rows"] == q:
            h_grid, w_side = loc["h"][s - r["lo"]], loc["W"][s - r["lo"]]
        else:
            k = int(np.flatnonzero(r["slot_global"] == s)[0])
            h_grid, w_side = rem["h"][k], rem["W"][k]
        logit = {"one_device": float(one["h"][s].double() @ attn),
                 "grid": float(h_grid.double() @ attn)}
        edges.append({
            "edge": int(e), "dst": d, "dst_rank": q, "logit": logit,
            "leaky_derivative": {k: 1.0 if v >= 0 else SLOPE
                                 for k, v in logit.items()},
            "row_diff": float((h_grid.double() - one["h"][s].double())
                              .abs().max()),
            "W": {"one_device": float(one["W"][s]),
                  "grid": float(w_side)},
            "dst_stats": {k: {"one_device": float(one[k][d]),
                              "grid": float(loc[k][d - r["lo"]])}
                          for k in ("m", "l", "s")},
            "dst_g_diff": float((loc["g"][d - r["lo"]].double()
                                 - one["g"][d].double()).abs().max()),
        })
    emit({"what": "source row with the largest W difference", "src": s,
          "W_one_device": float(one["W"][s]), "W_grid": float(w_grid[s]),
          "W_column_max": float(one["W"].abs().max()),
          "W_diff_next": float(torch.topk(wdiff, 2).values[1]),
          "edges": edges})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", type=int, default=4)
    ap.add_argument("--layer", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    for flag in ("--rank", "--world", "--port", "--work", "--capture"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        cap = (None if args.capture == "none"
               else tuple(int(x) for x in args.capture.split(",")))
        rank_main(int(args.rank), int(args.world), int(args.port),
                  Path(args.work), cap)
        return 0
    if cs.DEVICE == "cuda":
        if not torch.cuda.is_available():
            print("halo_reading: no CUDA device", file=sys.stderr)
            return 2
        cs.build_all()
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory(prefix="halo_reading_") as tmp:
        reading(args, Path(tmp), emit)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "halo_reading.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
