"""One rank of the port's multi-process tests (``tests/test_torch_distributed.py``).

Run as ``python tests/torch_dist_worker.py MODE RANK WORLD INIT WORKDIR``
with the repo on ``PYTHONPATH``; it imports torch and the port only. It
joins a gloo process group whose ranks meet at ``INIT``, an init URL
(``file://`` of a path no earlier group used, as the tests pass, or
``tcp://host:port``), reads its inputs from ``WORKDIR`` and writes
``WORKDIR/out_RANK.npz`` (``.json`` for ``cli``).

Modes:

- ``propagate``: the propagate of ``in.json``'s route on this rank's part
  of ``in.npz`` (global ``h``, a cotangent ``g``, the graph and the
  settings), forward and backward. ``halo``: on a (graph, model) grid of
  ``model`` heads' tiles, it writes its tile of the output and of ``dh``,
  its heads' ``dattn`` and its ``dbias``; ``replicated`` and ``gspmd``
  (features replicated, the output on every rank, each rank's backward
  from ``g / ranks`` as the step's ``loss / ranks``): the whole output and
  this rank's ``dh``, ``dattn`` and ``dbias``. The caller sums the partial
  gradients over the ranks, as the step does.
- ``trainer``: a ``RelGATTrainer`` on the grid of ``config.json`` over the
  synthetic KG it names, ``steps`` train steps over the first batches
  (with the injected negatives of ``neg.npy`` if present; in one call when
  the config's ``steps_per_call`` is ``steps``); writes the parameter
  leaves and each step's loss.
- ``cli``: ``cli.main`` with ``--distributed`` and the argv of
  ``argv.json``, counting the checkpoint writes of this rank; then a
  trainer built from the same argv resumes from the run's final
  checkpoint, and its state and one step from it are held to the trainer
  the CLI ran; then ``cli.main`` again with ``--resume``.
- ``partition``: ``partition_node_permutation`` of ``in.npz``'s graph with
  ``in.json``'s shards and rows, the ranks in its ``numpy_ranks`` on the
  NumPy route (``RELGAT_NO_NATIVE``); writes the permutation, the cut and
  whether this rank loaded the native library.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from relgat_projector_tpu_torch.parallel import (
    initialize_distributed,
    is_primary,
)


def _propagate(rank, world, work):
    from relgat_projector_tpu_torch.config import MeshConfig
    from relgat_projector_tpu_torch.data.graph import build_graph
    from relgat_projector_tpu_torch.parallel import (
        build_halo_graph,
        halo_propagate,
        make_grid,
        place_graph,
        place_halo_graph,
    )
    from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate

    z = np.load(work / "in.npz")
    cfg = json.loads((work / "in.json").read_text())
    route, model = cfg.get("route", "halo"), cfg.get("model", 1)
    grid = make_grid(MeshConfig(graph_axis=world // model, model_axis=model))
    kw = dict(attn_dropout_rate=cfg["rate"], dropout_seed=cfg["seed"])
    if route == "halo":
        hg = build_halo_graph(z["src"], z["dst"], z["et"], cfg["num_nodes"],
                              grid.graph, overlap=cfg["overlap"])
        shard = place_halo_graph(hg, grid, cfg["num_rel"],
                                 torch.device("cpu"), csr=cfg["use_pallas"])
        lo, hi = shard.row_range
        per = z["attn"].shape[0] // model
        heads = slice(grid.model_index * per, (grid.model_index + 1) * per)
        h = torch.from_numpy(z["h"][lo:hi, heads]).requires_grad_(True)
        attn = torch.from_numpy(z["attn"][heads]).requires_grad_(True)
        bias = torch.from_numpy(z["bias"]).requires_grad_(True)
        out = halo_propagate(h, attn, bias, shard,
                             use_pallas=cfg["use_pallas"], **kw)
        g = torch.from_numpy(z["g"][lo:hi, heads])
    else:
        graph = build_graph(z["src"], z["dst"], z["et"], cfg["num_nodes"],
                            num_rel=cfg["num_rel"], csr=route == "replicated",
                            graph_shards=world, device="cpu")
        graph = place_graph(graph, grid, cfg["num_rel"],
                            csr=route == "replicated")
        h = torch.from_numpy(z["h"]).requires_grad_(True)
        attn = torch.from_numpy(z["attn"]).requires_grad_(True)
        bias = (torch.from_numpy(z["bias"]).requires_grad_(True)
                if cfg.get("use_bias", True) else None)
        out = relgat_propagate(
            h, attn, bias, graph.src, graph.dst, graph.etype,
            num_nodes=graph.num_nodes, use_pallas=route == "replicated",
            edge_shard=graph.edge_shard, **kw)
        g = torch.from_numpy(z["g"]) / world
    out.backward(g)
    np.savez(work / f"out_{rank}.npz", out=out.detach().numpy(),
             dh=h.grad.numpy(), dattn=attn.grad.numpy(),
             dbias=(bias.grad.numpy() if bias is not None
                    else np.zeros(0, np.float32)),
             model_index=grid.model_index, graph_index=grid.graph_index)


def _kg(cfg):
    from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg

    return generate_synthetic_kg(**cfg["kg"])


def _trainer(rank, world, work):
    from relgat_projector_tpu_torch.config import RunConfig
    from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
    from relgat_projector_tpu_torch.utils.tree import tree_leaves

    cfg = json.loads((work / "config.json").read_text())
    run = RunConfig.from_dict(cfg["run"])
    tr = RelGATTrainer(run, *_kg(cfg), log_to_console=False, device="cpu")
    if (work / "params.npz").exists():  # shared initial weights
        z = np.load(work / "params.npz")
        for i, leaf in enumerate(tree_leaves(tr.state.params)):
            leaf.copy_(torch.from_numpy(z[f"p{i}"]))
    negs = (np.load(work / "neg.npy") if (work / "neg.npy").exists()
            else None)
    batches = tr.dataset.train_batches(run.train.train_batch_size)
    if tr._scan_step is not None:  # all steps in one call
        group = [next(batches) for _ in range(cfg["steps"])]
        tr.state, m = tr._scan_step(tr.state, tr.node_emb, tr.graph,
                                    *tr._device_batch(group))
        losses = m["loss"].tolist()
    else:
        losses = []
        for step in range(cfg["steps"]):
            batch = tr._device_batch(next(batches))
            neg = None if negs is None else torch.from_numpy(negs[step])
            tr.state, m = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                         *batch, neg_dst=neg)
            losses.append(float(m["loss"]))
    leaves = {f"p{i}": t.detach().numpy()
              for i, t in enumerate(tree_leaves(tr.state.params))}
    halo = tr.graph.halo
    np.savez(work / f"out_{rank}.npz", losses=np.asarray(losses),
             rows=np.asarray(tr.dataset.features_materialized_rows),
             overlap=np.asarray(halo is not None and halo.overlap),
             **leaves)


def _cli(rank, world, work, init):
    from relgat_projector_tpu_torch import cli
    from relgat_projector_tpu_torch.train.checkpoint import RelGATStorage
    from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
    from relgat_projector_tpu_torch.utils.tree import tree_leaves

    argv = json.loads((work / "argv.json").read_text()) + [
        "--distributed", "--num-processes", str(world), "--process-id",
        str(rank), "--coordinator-address", init,
    ]
    writes, trainers = [], []
    save, train = RelGATStorage.save_checkpoint, RelGATTrainer.train

    def spy_save(self, subdir, *a, **kw):
        writes.append(subdir)
        return save(self, subdir, *a, **kw)

    def keep(self, *a, **kw):
        trainers.append(self)
        return train(self, *a, **kw)

    RelGATStorage.save_checkpoint = spy_save
    RelGATTrainer.train = keep
    cli.main(argv)
    first_writes = list(writes)

    # The trainer the CLI ran, and one built from the same argv that
    # resumes from the run's final checkpoint.
    live = trainers[0]
    args = cli.get_args(argv)
    resumed = RelGATTrainer(cli.build_run_config(args), *cli.load_kg(args),
                            log_to_console=False, device="cpu")
    assert resumed.maybe_resume()

    def state_leaves(st):
        return (tree_leaves(st.params) + tree_leaves(st.opt_state.mu)
                + tree_leaves(st.opt_state.nu))

    same_state = all(torch.equal(a, b) for a, b in
                     zip(state_leaves(live.state), state_leaves(resumed.state)))
    batch = next(iter(live.dataset.train_batches(
        live.train_cfg.train_batch_size)))
    for tr in (live, resumed):
        tr.state, _ = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                     *tr._device_batch(batch))
    same_step = all(torch.equal(a, b) for a, b in
                    zip(state_leaves(live.state), state_leaves(resumed.state)))
    writes.clear()
    cli.main(argv + ["--resume"])
    (work / f"out_{rank}.json").write_text(json.dumps(dict(
        first_writes=first_writes, resume_writes=list(writes),
        same_state=same_state, same_step=same_step,
        step=int(live.state.step),
    )))
    dist.destroy_process_group()


def _partition(rank, world, work):
    from relgat_projector_tpu_torch.data import native
    from relgat_projector_tpu_torch.data.partition import (
        partition_node_permutation,
    )

    cfg = json.loads((work / "in.json").read_text())
    if rank in cfg["numpy_ranks"]:
        os.environ["RELGAT_NO_NATIVE"] = "1"
    z = np.load(work / "in.npz")
    perm, stats = partition_node_permutation(
        z["src"], z["dst"], cfg["num_nodes"], cfg["shards"], cfg["rows"])
    np.savez(work / f"out_{rank}.npz", perm=perm,
             cut_after=stats["edge_cut_after"],
             native=native.load_native() is not None)


def main():
    mode, rank, world, init = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    work = Path(sys.argv[5])
    torch.set_num_threads(1)
    if mode == "cli":
        return _cli(rank, world, work, init)
    initialize_distributed(init, world, rank, backend="gloo", timeout_s=120)
    assert is_primary() == (rank == 0)
    try:
        {"propagate": _propagate, "trainer": _trainer,
         "partition": _partition}[mode](rank, world, work)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
