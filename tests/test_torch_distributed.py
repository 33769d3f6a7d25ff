"""The port on a grid of processes: gloo on the CPU, one process a rank,
mirroring ``tests/test_distributed.py`` and ``tests/test_halo.py``.

Each test starts its ranks as ``tests/torch_dist_worker.py`` processes that
meet through a file store (they import torch and the port only), waits for
them with a time limit, and compares what they wrote:

- the halo propagate, forward and backward, gathered from 2 and 4 ranks,
  against JAX's ``halo_propagate`` on the 8-virtual-device mesh (``graph``
  = G), at forward rtol 1e-4 / atol 1e-5 and gradients rtol 1e-3 /
  atol 1e-5, on the plain route and the kernels' plain versions, with and
  without the overlap split;
- the trainer on (data, graph) = (1, 4) and (2, 2), on (2, 1) with the 3
  steps in one call (``steps_per_call``), and on (1, 2) with
  ``scan_segments`` 4 (which turns the overlap split off, as in the JAX
  trainer: the unsplit halo propagate), ends within 1e-4 of the port's
  one-device trainer after 3 steps without injected negatives (every rank
  draws the global batch's negatives from generators in the same state),
  every rank holding the same parameters and building only its shard's
  rows of the embeddings; and on (2, 2) with JAX's weights
  (``interop.params_from_jax``) and its negatives injected, within 1e-4 of
  JAX's mesh trainer;
- the CLI with ``--distributed --num-processes 2 --mesh-graph 2`` trains,
  writes checkpoints on rank 0 only, resumes with the same bits (the state
  a trainer resumes from its final checkpoint equals the state of the
  trainer the CLI ran, and one step from each gives the same bits), and
  runs again with ``--resume``.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from relgat_projector_tpu.config import MeshConfig as JaxMeshConfig
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import RunConfig as JaxRunConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.data.synthetic import (
    generate_synthetic_kg as jax_synthetic_kg,
)
from relgat_projector_tpu.ops.sampling import sample_negative_dst
from relgat_projector_tpu.parallel import make_mesh
from relgat_projector_tpu.parallel.halo import build_halo_graph, halo_propagate
from relgat_projector_tpu.train.trainer import RelGATTrainer as JaxTrainer
from relgat_projector_tpu_torch.config import RunConfig
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
from relgat_projector_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
TIMEOUT_S = 240
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _run_ranks(mode, world, work):
    """``world`` worker ranks of ``mode`` on ``work``; their outputs.

    The ranks meet through a file store in ``work``, not a TCP store on a
    port picked from the ephemeral range: another suite's process that
    picks a free port and binds it a few seconds later (the JAX package's
    ``tests/test_distributed.py`` hands such a port to its coordinator)
    must not find it taken by these ranks' store. Each rank runs one
    thread."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = (Path(tempfile.mkdtemp(prefix="rendezvous-", dir=work))
            / "store").as_uri()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(r), str(world),
             init, str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shards,route,overlap", [
    (2, "plain", True), (2, "kernels", False),
    (4, "plain", False), (4, "kernels", True),
])
def test_halo_propagate_matches_jax_mesh(tmp_path, shards, route, overlap):
    n, e, r, heads, f = 300, 2000, 5, 3, 16
    rng = np.random.default_rng(shards)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    et = rng.integers(0, r, e).astype(np.int32)
    attn = (rng.standard_normal((heads, r, f)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(r) * 0.1).astype(np.float32)
    hg = build_halo_graph(src, dst, et, n, shards, overlap=overlap)
    hg = hg.with_mesh(make_mesh(data=1, graph=shards))
    h = rng.standard_normal((hg.num_nodes, heads, f)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)

    @jax.jit
    def forward_and_back(a, b, c, cot):
        out, vjp = jax.vjp(lambda x, y, z: halo_propagate(x, y, z, hg),
                           a, b, c)
        return (out,) + vjp(cot)

    want = [np.asarray(x) for x in
            forward_and_back(*map(jnp.asarray, (h, attn, bias, g)))]

    np.savez(tmp_path / "in.npz", h=h, g=g, attn=attn, bias=bias, src=src,
             dst=dst, et=et)
    (tmp_path / "in.json").write_text(json.dumps(dict(
        num_nodes=n, num_rel=r, overlap=overlap,
        use_pallas=route == "kernels", rate=0.0, seed=None)))
    _run_ranks("propagate", shards, tmp_path)
    parts = [np.load(tmp_path / f"out_{k}.npz") for k in range(shards)]
    got_out = np.concatenate([p["out"] for p in parts])
    got_dh = np.concatenate([p["dh"] for p in parts])
    real = slice(0, n)  # JAX's XLA path gives padded rows a bias
    np.testing.assert_allclose(got_out[real], want[0][real], **FWD)
    np.testing.assert_allclose(got_dh, want[1], **GRAD)
    np.testing.assert_allclose(sum(p["dattn"] for p in parts), want[2],
                               **GRAD)
    np.testing.assert_allclose(sum(p["dbias"] for p in parts), want[3],
                               **GRAD)


KG = dict(num_nodes=160, num_edges=1600, num_rel=4, emb_dim=16, seed=0)
MODEL = dict(in_dim=16, num_rel=4, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.0, projection_layers=2,
             use_pallas=True)
TRAIN = dict(epochs=1, train_batch_size=50, eval_batch_size=50, num_neg=4,
             lr=1e-3, lr_scheduler="constant", warmup_steps=0,
             eval_ks_ranks=(1, 2), seed=3, use_self_adv_neg=True,
             log_every_n_steps=10_000)
STEPS = 3


def _run_config(data, graph, out_dir, steps_per_call=1, scan_segments=0):
    from relgat_projector_tpu_torch.config import (
        MeshConfig, ModelConfig, TrainConfig,
    )

    return RunConfig(model=ModelConfig(**MODEL, scan_segments=scan_segments),
                     train=TrainConfig(**TRAIN, out_dir=str(out_dir),
                                       steps_per_call=steps_per_call),
                     mesh=MeshConfig(data_axis=data, graph_axis=graph))


def _grid_params(tmp_path, data, graph, steps_per_call=1, scan_segments=0):
    run = _run_config(data, graph, tmp_path / "out", steps_per_call,
                      scan_segments)
    (tmp_path / "config.json").write_text(json.dumps(dict(
        run=run.to_dict(), kg=KG, steps=STEPS)))
    _run_ranks("trainer", data * graph, tmp_path)
    return [np.load(tmp_path / f"out_{k}.npz") for k in range(data * graph)]


@pytest.mark.parametrize("data,graph,steps_per_call,scan_segments", [
    (1, 4, 1, 0), (2, 2, 1, 0), (2, 1, STEPS, 0), (1, 2, 1, 4)])
def test_trainer_on_the_grid_matches_one_device(tmp_path, data, graph,
                                                steps_per_call,
                                                scan_segments):
    one = RelGATTrainer(_run_config(1, 1, tmp_path / "one"),
                        *generate_synthetic_kg(**KG), log_to_console=False,
                        device="cpu")
    batches = one.dataset.train_batches(TRAIN["train_batch_size"])
    losses = []
    for _ in range(STEPS):
        one.state, m = one._train_step(one.state, one.node_emb, one.graph,
                                       *one._device_batch(next(batches)))
        losses.append(float(m["loss"]))
    want = [t.numpy() for t in tree_leaves(one.state.params)]

    ranks = _grid_params(tmp_path, data, graph, steps_per_call,
                         scan_segments)
    # a rank builds its shard's rows alone; without a graph axis the
    # dataset stacks the whole matrix and builds no rows one by one
    rows = 0
    if graph > 1:
        rows = -(-(-(-(KG["num_nodes"] + 1) // graph)) // 8) * 8
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
        for i, w in enumerate(want):
            assert _rel_err(out[f"p{i}"], w) <= 1e-4, i
            assert np.array_equal(out[f"p{i}"], ranks[0][f"p{i}"])
        assert int(out["rows"]) == rows
        assert bool(out["overlap"]) == (graph > 1 and scan_segments == 0)


def test_trainer_on_the_grid_matches_jax_mesh_trainer(tmp_path):
    """(data, graph) = (2, 2), shared weights, JAX's negatives injected."""
    run = JaxRunConfig(
        model=JaxModelConfig(**{**MODEL, "use_pallas": False}),
        train=JaxTrainConfig(**TRAIN, out_dir=str(tmp_path / "jax")),
        mesh=JaxMeshConfig(data_axis=2, graph_axis=2),
    )
    jt = JaxTrainer(run, *jax_synthetic_kg(**KG), log_to_console=False)
    params0 = [t.numpy() for t in tree_leaves(params_from_jax(
        jax.device_get(jt.state.params), device="cpu"))]
    negs = []
    batches = jt.dataset.train_batches(TRAIN["train_batch_size"])
    for _ in range(STEPS):
        batch = next(batches)
        st = jt.state
        step_rng = jax.random.fold_in(st.rng, st.step)
        _, neg_rng = jax.random.split(step_rng)
        negs.append(np.asarray(sample_negative_dst(
            neg_rng, jnp.asarray(batch.dst), num_nodes=KG["num_nodes"],
            num_neg=TRAIN["num_neg"])))
        jt.state, _ = jt._train_step(jt.state, jt.node_emb, jt.graph,
                                     *jt._device_batch(batch))
    want = [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.device_get(jt.state.params))]

    np.savez(tmp_path / "params.npz",
             **{f"p{i}": p for i, p in enumerate(params0)})
    np.save(tmp_path / "neg.npy", np.stack(negs).astype(np.int64))
    for out in _grid_params(tmp_path, 2, 2):
        for i, w in enumerate(want):
            assert _rel_err(out[f"p{i}"], w) <= 1e-4, i


def test_cli_trains_and_resumes_on_two_processes(tmp_path):
    save = tmp_path / "save"
    argv = ["--synthetic", "--synthetic-nodes", "200", "--synthetic-edges",
            "1500", "--synthetic-rels", "4", "--synthetic-dim", "16",
            "--epochs", "1", "--batch-size", "64", "--gat-out-dim", "8",
            "--heads", "2", "--num-neg", "3", "--project-to-input-size",
            "--use-pallas", "--log-every-n-steps", "10", "--mesh-graph", "2",
            "--save-dir", str(save), "--device", "cpu"]
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    outs = _run_ranks("cli", 2, tmp_path)
    res = [json.loads((tmp_path / f"out_{k}.json").read_text())
           for k in range(2)]
    final = "relgat_scorer-distmult_lrscheduler-linear"
    assert res[0]["first_writes"] == [final]
    assert res[0]["resume_writes"] == [final]
    assert res[1]["first_writes"] == res[1]["resume_writes"] == []
    assert all(r["same_state"] and r["same_step"] for r in res)
    assert (save / final / "train-state.pt").is_file()
    assert "Resumed from" in outs[0] and "Resumed from" not in outs[1]
    assert "Training finished" not in outs[1]
