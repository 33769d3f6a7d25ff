"""The rest of the multi-device modes on a grid of gloo processes: head
tensor parallelism on the halo route, the ``replicated`` route and the
``gspmd`` route, each held to the JAX package on the CPU.

Ranks run as ``tests/torch_dist_worker.py`` processes, as in
``tests/test_torch_distributed.py`` (kept apart: ``--dist loadfile`` runs a
file on one worker):

- head TP: the halo propagate on (graph, model) = (2, 2) and (1, 2), 4 and
  6 heads (3 a tile, an odd count), plain route and the kernels' plain
  versions, with and without the overlap split, against JAX's
  ``halo_propagate`` on its (1, graph, 2) mesh: forward rtol 1e-4 /
  atol 1e-5, gradients rtol 1e-3 / atol 1e-5;
- the replicated route at G = 2 and 4 against JAX's
  ``pallas_sharded_propagate`` (Pallas in interpret mode) at the same bars;
  with attention dropout, masks that are the one-device port's bit for bit;
  an empty shard;
- the gspmd route against JAX's one-device XLA propagate, and with
  dropout against the one-device port;
- trainers: (data, graph, model) = (2, 2, 2) halo + head TP, (2, 2, 1)
  replicated and (2, 2, 1) gspmd within 1e-4 of the port's one-device
  trainer after 3 steps, every rank with the same parameters; (2, 2, 2)
  against JAX's mesh trainer on shared weights with its negatives;
- the config: the port raises a ValueError exactly where JAX's trainer
  does, and accepts what it trains;
- the grid: the rank <-> (d, g, m) map, the lines, and the tiles' seeds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.config import MeshConfig as JaxMeshConfig
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import RunConfig as JaxRunConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.data.synthetic import (
    generate_synthetic_kg as jax_synthetic_kg,
)
from relgat_projector_tpu.ops.relgat_ops import (
    relgat_propagate as jax_relgat_propagate,
)
from relgat_projector_tpu.ops.sampling import sample_negative_dst
from relgat_projector_tpu.parallel import make_mesh
from relgat_projector_tpu.parallel.halo import build_halo_graph, halo_propagate
from relgat_projector_tpu.parallel.pallas_sharded import (
    pallas_sharded_propagate,
    shard_blocked_graph,
)
from relgat_projector_tpu.train.trainer import RelGATTrainer as JaxTrainer
from relgat_projector_tpu_torch import config as tconfig
from relgat_projector_tpu_torch.data.graph import build_graph
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.ops.dropout import edge_keep_mask_all_heads
from relgat_projector_tpu_torch.ops.relgat_ops import relgat_propagate
from relgat_projector_tpu_torch.parallel import Grid, shard_seed
from relgat_projector_tpu_torch.parallel.mesh import grid_coords, grid_lines
from relgat_projector_tpu_torch.parallel.pallas_sharded import (
    shard_csr_layout,
)
from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_distributed import (
    FWD,
    GRAD,
    KG,
    STEPS,
    TRAIN,
    _rel_err,
    _run_ranks,
)

N, E, R, F = 300, 2000, 5, 16


def _case(seed, heads, n=N, dst_hi=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, dst_hi or n, E).astype(np.int32)
    et = rng.integers(0, R, E).astype(np.int32)
    attn = (rng.standard_normal((heads, R, F)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(R) * 0.1).astype(np.float32)
    return rng, src, dst, et, attn, bias


def _write(work, h, g, attn, bias, src, dst, et, **cfg):
    np.savez(work / "in.npz", h=h, g=g, attn=attn, bias=bias, src=src,
             dst=dst, et=et)
    base = dict(num_nodes=N, num_rel=R, overlap=False, use_pallas=False,
                rate=0.0, seed=None)
    (work / "in.json").write_text(json.dumps({**base, **cfg}))


def _jax_fwd_bwd(fn, h, attn, bias, g):
    @jax.jit
    def run(a, b, c, cot):
        out, vjp = jax.vjp(fn, a, b, c)
        return (out,) + vjp(cot)

    return [np.asarray(x) for x in
            run(*map(jnp.asarray, (h, attn, bias, g)))]


# ---------------------------------------------------------------------------
# Head tensor parallelism on the halo route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph,route,overlap,heads", [
    (2, "plain", True, 6), (2, "kernels", False, 6),
    (2, "plain", False, 4), (2, "kernels", True, 4),
    (1, "plain", True, 6), (1, "kernels", True, 6),
    (1, "plain", False, 4), (1, "kernels", False, 4),
])
def test_head_tp_halo_propagate_matches_jax_mesh(tmp_path, graph, route,
                                                 overlap, heads):
    model = 2
    rng, src, dst, et, attn, bias = _case(10 * graph + heads, heads)
    hg = build_halo_graph(src, dst, et, N, graph, overlap=overlap)
    hg = hg.with_mesh(make_mesh(data=1, graph=graph, model=model))
    h = rng.standard_normal((hg.num_nodes, heads, F)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    want = _jax_fwd_bwd(lambda x, y, z: halo_propagate(x, y, z, hg),
                        h, attn, bias, g)

    _write(tmp_path, h, g, attn, bias, src, dst, et, overlap=overlap,
           use_pallas=route == "kernels", model=model)
    _run_ranks("propagate", graph * model, tmp_path)
    out, dh = np.zeros_like(h), np.zeros_like(h)
    dattn, dbias = np.zeros_like(attn), np.zeros_like(bias)
    rows, per = hg.rows_per_shard, heads // model
    for k in range(graph * model):
        p = np.load(tmp_path / f"out_{k}.npz")
        gi, mi = int(p["graph_index"]), int(p["model_index"])
        tile = (slice(gi * rows, (gi + 1) * rows),
                slice(mi * per, (mi + 1) * per))
        out[tile], dh[tile] = p["out"], p["dh"]
        dattn[tile[1]] += p["dattn"]
        dbias += p["dbias"]
    real = slice(0, N)  # JAX's XLA path gives padded rows a bias
    np.testing.assert_allclose(out[real], want[0][real], **FWD)
    np.testing.assert_allclose(dh, want[1], **GRAD)
    np.testing.assert_allclose(dattn, want[2], **GRAD)
    np.testing.assert_allclose(dbias, want[3], **GRAD)


# ---------------------------------------------------------------------------
# The replicated and gspmd routes
# ---------------------------------------------------------------------------

def _padded(n):
    return -(-(n + 1) // 8) * 8


@pytest.mark.parametrize("shards,bias_on,dst_hi", [
    (2, True, None), (4, False, None), (4, True, 100)])
def test_replicated_propagate_matches_jax_pallas_sharded(tmp_path, shards,
                                                         bias_on, dst_hi):
    """G = 2 and 4, with and without the relation bias; ``dst_hi`` = 100
    leaves the last two shards without an edge (JAX
    ``test_pallas_sharded.py:126``)."""
    n_pad = _padded(N)
    rng, src, dst, et, attn, bias = _case(shards, 3, dst_hi=dst_hi)
    h = rng.standard_normal((n_pad, 3, F)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    sbg = shard_blocked_graph(src, dst, et, n_pad, shards, block_nodes=64,
                              chunk_edges=128)
    sbg = sbg.with_mesh(make_mesh(data=1, graph=shards))
    want = _jax_fwd_bwd(
        lambda x, y, z: pallas_sharded_propagate(
            x, y, z if bias_on else None, sbg), h, attn, bias, g)

    _write(tmp_path, h, g, attn, bias, src, dst, et, route="replicated",
           use_bias=bias_on)
    _run_ranks("propagate", shards, tmp_path)
    parts = [np.load(tmp_path / f"out_{k}.npz") for k in range(shards)]
    for p in parts:  # every rank holds the joined output
        np.testing.assert_allclose(p["out"], want[0], **FWD)
    np.testing.assert_allclose(sum(p["dh"] for p in parts), want[1], **GRAD)
    np.testing.assert_allclose(sum(p["dattn"] for p in parts), want[2],
                               **GRAD)
    if bias_on:
        np.testing.assert_allclose(sum(p["dbias"] for p in parts), want[3],
                                   **GRAD)


def _one_device(route, h, attn, bias, src, dst, et, seed, rate, g):
    """The one-device port's propagate (kernels' plain versions for the
    replicated route, the plain route for gspmd), forward and backward."""
    graph = build_graph(src, dst, et, N, num_rel=R, csr=True, device="cpu")
    h_t = torch.from_numpy(h).requires_grad_(True)
    a_t = torch.from_numpy(attn).requires_grad_(True)
    b_t = torch.from_numpy(bias).requires_grad_(True)
    out = relgat_propagate(
        h_t, a_t, b_t, graph.src, graph.dst, graph.etype,
        num_nodes=graph.num_nodes, use_pallas=route == "replicated",
        csr=graph.csr, attn_dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(g))
    return graph, [t.detach().numpy() for t in
                   (out, h_t.grad, a_t.grad, b_t.grad)]


@pytest.mark.parametrize("route,shards", [("replicated", 4), ("gspmd", 3)])
def test_dropout_masks_are_one_devices(tmp_path, route, shards):
    """The same seed on every rank and global edge ids: the ranks' masks
    are the one-device port's, so the output and gradients agree with it
    (and differ from no dropout)."""
    seed, rate = 1234, 0.3
    rng, src, dst, et, attn, bias = _case(7, 3)
    h = rng.standard_normal((_padded(N), 3, F)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    graph, want = _one_device(route, h, attn, bias, src, dst, et, seed,
                              rate, g)
    _, undropped = _one_device(route, h, attn, bias, src, dst, et, None,
                               0.0, g)
    assert np.abs(undropped[0] - want[0]).max() > 1e-3

    if route == "replicated":
        plan = build_graph(src, dst, et, N, num_rel=R, csr=True,
                           graph_shards=shards, device="cpu").edge_shard
        eids = torch.cat([shard_csr_layout(plan, k, R, torch.device("cpu"))
                          .eid for k in range(shards)])
        assert torch.equal(eids, graph.csr.eid)
        assert torch.equal(edge_keep_mask_all_heads(eids, 3, seed, rate),
                           edge_keep_mask_all_heads(graph.csr.eid, 3, seed,
                                                    rate))

    _write(tmp_path, h, g, attn, bias, src, dst, et, route=route, rate=rate,
           seed=seed)
    _run_ranks("propagate", shards, tmp_path)
    parts = [np.load(tmp_path / f"out_{k}.npz") for k in range(shards)]
    tight = dict(rtol=1e-5, atol=1e-6)
    for p in parts:
        np.testing.assert_allclose(p["out"], want[0], **tight)
    for i, key in enumerate(("dh", "dattn", "dbias"), start=1):
        np.testing.assert_allclose(sum(p[key] for p in parts), want[i],
                                   **GRAD)


def test_gspmd_propagate_matches_jax(tmp_path):
    shards = 2
    rng, src, dst, et, attn, bias = _case(21, 3)
    n_pad = _padded(N)
    h = rng.standard_normal((n_pad, 3, F)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    # JAX's one-device graph: the padded dst-sorted COO the route splits
    jg = jax_build_graph(src, dst, et, N)
    assert jg.num_nodes == n_pad
    want = _jax_fwd_bwd(
        lambda x, y, z: jax_relgat_propagate(x, y, z, jg.src, jg.dst,
                                             jg.etype, num_nodes=n_pad),
        h, attn, bias, g)
    _write(tmp_path, h, g, attn, bias, src, dst, et, route="gspmd")
    _run_ranks("propagate", shards, tmp_path)
    parts = [np.load(tmp_path / f"out_{k}.npz") for k in range(shards)]
    for p in parts:
        np.testing.assert_allclose(p["out"], want[0], **FWD)
    np.testing.assert_allclose(sum(p["dh"] for p in parts), want[1], **GRAD)
    np.testing.assert_allclose(sum(p["dattn"] for p in parts), want[2],
                               **GRAD)
    np.testing.assert_allclose(sum(p["dbias"] for p in parts), want[3],
                               **GRAD)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

MODEL = dict(in_dim=16, num_rel=4, gat_out_dim=4, gat_heads=6,
             gat_num_layers=2, dropout=0.0, projection_layers=2)


def _run_config(out_dir, mesh=(1, 1, 1), **model):
    return tconfig.RunConfig(
        model=tconfig.ModelConfig(**{**MODEL, **model}),
        train=tconfig.TrainConfig(**TRAIN, out_dir=str(out_dir)),
        mesh=tconfig.MeshConfig(*mesh))


def _grid_outputs(tmp_path, mesh, **model):
    run = _run_config(tmp_path / "out", mesh, **model)
    (tmp_path / "config.json").write_text(json.dumps(dict(
        run=run.to_dict(), kg=KG, steps=STEPS)))
    world = int(np.prod(mesh))
    _run_ranks("trainer", world, tmp_path)
    return [np.load(tmp_path / f"out_{k}.npz") for k in range(world)]


@pytest.mark.parametrize("mesh,route,use_pallas", [
    ((2, 2, 2), "halo", True), ((2, 2, 1), "replicated", True),
    ((2, 2, 1), "gspmd", False)])
def test_trainer_routes_match_one_device(tmp_path, mesh, route, use_pallas):
    one = RelGATTrainer(_run_config(tmp_path / "one", use_pallas=use_pallas),
                        *generate_synthetic_kg(**KG), log_to_console=False,
                        device="cpu")
    batches = one.dataset.train_batches(TRAIN["train_batch_size"])
    losses = []
    for _ in range(STEPS):
        one.state, m = one._train_step(one.state, one.node_emb, one.graph,
                                       *one._device_batch(next(batches)))
        losses.append(float(m["loss"]))
    want = [t.numpy() for t in tree_leaves(one.state.params)]

    ranks = _grid_outputs(tmp_path, mesh, mesh_propagate=route,
                          use_pallas=use_pallas)
    # the halo route builds its shard's rows alone; the others replicate
    rows = (-(-(-(-(KG["num_nodes"] + 1) // mesh[1])) // 8) * 8
            if route == "halo" else 0)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
        for i, w in enumerate(want):
            assert _rel_err(out[f"p{i}"], w) <= 1e-4, i
            assert np.array_equal(out[f"p{i}"], ranks[0][f"p{i}"])
        assert int(out["rows"]) == rows
        assert bool(out["overlap"]) == (route == "halo")


def test_head_tp_trainer_matches_jax_mesh_trainer(tmp_path):
    """(data, graph, model) = (2, 2, 2), shared weights, JAX's negatives
    injected."""
    model = {**MODEL, "use_pallas": False}
    run = JaxRunConfig(
        model=JaxModelConfig(**model),
        train=JaxTrainConfig(**TRAIN, out_dir=str(tmp_path / "jax")),
        mesh=JaxMeshConfig(data_axis=2, graph_axis=2, model_axis=2),
    )
    jt = JaxTrainer(run, *jax_synthetic_kg(**KG), log_to_console=False)
    params0 = [t.numpy() for t in tree_leaves(params_from_jax(
        jax.device_get(jt.state.params), device="cpu"))]
    negs = []
    batches = jt.dataset.train_batches(TRAIN["train_batch_size"])
    for _ in range(STEPS):
        batch = next(batches)
        st = jt.state
        _, neg_rng = jax.random.split(jax.random.fold_in(st.rng, st.step))
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
    for out in _grid_outputs(tmp_path, (2, 2, 2), use_pallas=False):
        for i, w in enumerate(want):
            assert _rel_err(out[f"p{i}"], w) <= 1e-4, i


# ---------------------------------------------------------------------------
# The config: where JAX's trainer raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,mesh,raises", [
    (dict(mesh_propagate="replicated"), (1, 2, 1), True),
    (dict(mesh_propagate="replicated", use_pallas=True, scan_segments=4),
     (1, 2, 1), True),
    (dict(mesh_propagate="gspmd", use_pallas=True), (2, 1, 1), True),
    (dict(mesh_propagate="replicated", use_pallas=True), (1, 1, 2), True),
    (dict(gat_heads=3), (1, 2, 2), True),
    (dict(gat_heads=4), (2, 2, 2), False),
    (dict(gat_heads=4), (1, 1, 2), False),
    (dict(mesh_propagate="replicated", use_pallas=True), (2, 2, 1), False),
    (dict(mesh_propagate="gspmd"), (1, 4, 1), False),
    (dict(mesh_propagate="replicated"), (2, 1, 1), False),
    (dict(mesh_propagate="replicated", scan_segments=4), (1, 1, 1), False),
    (dict(mesh_propagate="gspmd", use_pallas=True), (1, 1, 1), False),
])
def test_config_raises_where_jax_trainer_raises(tmp_path, model, mesh,
                                                raises):
    kw = {**dict(in_dim=8, num_rel=2, gat_out_dim=4, gat_heads=2), **model}
    mesh_kw = dict(zip(("data_axis", "graph_axis", "model_axis"), mesh))
    jax_run = JaxRunConfig(
        model=JaxModelConfig(**kw),
        train=JaxTrainConfig(epochs=1, out_dir=str(tmp_path)),
        mesh=JaxMeshConfig(**mesh_kw))
    kg = jax_synthetic_kg(num_nodes=40, num_edges=120, num_rel=2, emb_dim=8,
                          seed=0)
    try:
        JaxTrainer(jax_run, *kg, log_to_console=False)
        jax_raised = None
    except ValueError as e:
        jax_raised = e
    assert (jax_raised is not None) == raises, jax_raised
    port = tconfig.RunConfig.from_json(jax_run.to_json()) if not raises \
        else None
    if raises:
        with pytest.raises(ValueError):
            tconfig.RunConfig.from_json(jax_run.to_json())
    else:
        assert port.mesh.num_devices == int(np.prod(mesh))


def test_a_jax_head_tp_config_loads():
    run = JaxRunConfig(model=JaxModelConfig(in_dim=8, num_rel=2,
                                            gat_heads=4),
                       mesh=JaxMeshConfig(graph_axis=2, model_axis=2))
    port = tconfig.RunConfig.from_json(run.to_json())
    assert port.mesh == tconfig.MeshConfig(graph_axis=2, model_axis=2)
    assert port.to_dict()["mesh"] == json.loads(run.to_json())["mesh"]


# ---------------------------------------------------------------------------
# The grid without processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,graph,model", [
    (1, 2, 2), (2, 2, 2), (2, 3, 1), (1, 1, 4), (3, 1, 2)])
def test_grid_rank_map_and_lines(data, graph, model):
    world = data * graph * model
    coords = [grid_coords(r, data, graph, model) for r in range(world)]
    # JAX's create_device_mesh order: the rank is the mesh position
    assert coords == [(d, g, m) for d in range(data) for g in range(graph)
                      for m in range(model)]
    for r, (d, g, m) in enumerate(coords):
        grid = Grid(data, graph, model, d, g, None, None, None, "gloo",
                    model_index=m)
        assert grid.rank == r and grid.size == world
    lines = grid_lines(data, graph, model)
    assert set(lines) == ({"graph", "data", "model"} if model > 1
                          else {"graph", "data"})
    for key, axis in (("graph", 1), ("data", 0), ("model", 2)):
        if key not in lines:
            continue
        # each rank in exactly one line; a line varies only its own axis,
        # in that axis's order
        members = sorted(r for line in lines[key] for r in line)
        assert members == list(range(world))
        for line in lines[key]:
            cs = [coords[r] for r in line]
            assert [c[axis] for c in cs] == list(range(len(line)))
            rest = {tuple(c[i] for i in range(3) if i != axis) for c in cs}
            assert len(rest) == 1
    if model == 1:  # the lines of a data x graph grid, in their order
        assert lines["graph"] == [[d * graph + g for g in range(graph)]
                                  for d in range(data)]
        assert lines["data"] == [[d * graph + g for d in range(data)]
                                 for g in range(graph)]


def _fmix_seed(seed, shard):
    """The graph-only seed rule, written out."""
    x = (seed + (shard + 1) * 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x - (1 << 32) if x >= 1 << 31 else x


@pytest.mark.parametrize("graph,model", [(1, 2), (2, 2), (4, 3)])
def test_tile_seeds_are_distinct_and_keep_the_graph_seeds(graph, model):
    for seed in (-(2**31), -1, 0, 7, 2**31 - 1):
        tiles = [shard_seed(seed, g, model_index=m, num_shards=graph)
                 for g in range(graph) for m in range(model)]
        assert len(set(tiles)) == graph * model
        assert all(-(2**31) <= s < 2**31 for s in tiles)
        for g in range(graph):
            assert (shard_seed(seed, g, model_index=0, num_shards=graph)
                    == shard_seed(seed, g) == _fmix_seed(seed, g))
