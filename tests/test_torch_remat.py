"""Remat: each GAT layer recomputed in the backward (``torch.utils.checkpoint``).

- Against JAX's ``jax.checkpoint`` layers, on shared weights with dropout
  off: the representations, their loss and every gradient agree to 1e-4
  (the repo's parity contract), on the plain path against the XLA path and
  on the kernels' route against the XLA and Pallas (interpret mode) paths.
- Against the port without remat, with output, attention and projection
  dropout on, on both routes: one train step gives gradients within 1e-6
  and parameters within 1e-6, and leaves both generators (host and device)
  in the same state. The layer's random draws are made before the
  checkpointed function, so its recompute draws nothing.
- Under remat the propagate's forward runs twice a layer (once in the
  forward, once in the backward's recompute), and once without it.
- ``--remat`` through the CLI, with dropout on, ends an epoch at the
  parameters of the same run without it (1e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu.models.model import single_gat_step as jax_gat_step
from relgat_projector_tpu_torch import cli
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.models.model import init_model, single_gat_step
from relgat_projector_tpu_torch.ops import propagate
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import loss_and_grads, make_train_step
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_trainer import (  # noqa: F401 (a fixture)
    _cli_argv,
    one_thread,
)

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-6, atol=1e-6)
N, E, R, D = 60, 300, 4, 16
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.0, project_to_input_size=True,
             projection_layers=2)
DROPOUT = dict(dropout=0.3, rel_attn_dropout=0.2, projection_dropout=0.3)


def _graph_inputs(seed=0):
    rng = np.random.default_rng(seed)
    src, dst, et = (rng.integers(0, N, E), rng.integers(0, N, E),
                    rng.integers(0, R, E))
    emb = rng.standard_normal((N, D)).astype(np.float32)
    return src, dst, et, emb


@pytest.mark.parametrize("port_pallas,ref_pallas",
                         [(False, False), (True, False), (True, True)],
                         ids=["plain-xla", "kernels-xla", "kernels-pallas"])
def test_remat_matches_jax_remat(port_pallas, ref_pallas):
    src, dst, et, emb = _graph_inputs()
    jg = jax_build_graph(src, dst, et, N, blocked=ref_pallas, block_nodes=16,
                         chunk_edges=64)
    jcfg = JaxModelConfig(**MODEL, remat=True, use_pallas=ref_pallas)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jx = jnp.asarray(pad_node_embeddings(emb, jg.num_nodes))
    wsum = np.random.default_rng(1).standard_normal(
        (jg.num_nodes, D)).astype(np.float32)

    def jloss(p):
        out = jax_gat_step(p, jcfg, jx, jg)[:N]
        return jnp.sum(jnp.sin(out) * wsum[:N]), out

    (want_loss, want_out), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)

    cfg = ModelConfig(**MODEL, remat=True, use_pallas=port_pallas)
    g = build_graph(src, dst, et, N, num_rel=R, csr=port_pallas, device="cpu")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    out = single_gat_step(params, cfg,
                          torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)),
                          g)[:N]
    loss = (torch.sin(out) * torch.from_numpy(wsum[:N])).sum()
    grads = [torch.zeros_like(p) if d is None else d for p, d in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **JAX_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **JAX_TOL)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL)


def _step_setup(remat, use_pallas):
    src, dst, et, emb = _graph_inputs(2)
    cfg = ModelConfig(**{**MODEL, **DROPOUT}, remat=remat,
                      use_pallas=use_pallas)
    tc = TrainConfig(train_batch_size=16, num_neg=4, lr=1e-3,
                     lr_scheduler="constant", warmup_steps=0,
                     eval_ks_ranks=(1,))
    g = build_graph(src, dst, et, N, num_rel=R, csr=use_pallas, device="cpu")
    sched = make_lr_schedule(tc.lr, "constant", 10, 0)
    opt = make_optimizer(tc, sched)
    state = create_train_state(init_model(cfg, seed=3, device="cpu"), opt,
                               seed=5)
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    rng = np.random.default_rng(7)
    batch = [torch.from_numpy(rng.integers(0, n, 16))
             for n in (N, R, N)] + [torch.ones(16)]
    return cfg, tc, opt, sched, state, x, g, batch


@pytest.mark.parametrize("use_pallas", (False, True), ids=("plain", "kernels"))
def test_remat_equals_no_remat_with_dropout(use_pallas, one_thread):
    runs = {}
    for remat in (False, True):
        cfg, tc, opt, sched, state, x, g, batch = _step_setup(remat,
                                                              use_pallas)
        loss, _, grads = loss_and_grads(state.params, cfg, tc, x, g, *batch,
                                        rng=state.rng)
        step = make_train_step(cfg, tc, opt, sched)
        state, metrics = step(state, x, g, *batch)
        runs[remat] = (loss, tree_leaves(grads), state)
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    np.testing.assert_allclose(float(l1), float(l0), **SELF_TOL)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SELF_TOL)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s0.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SELF_TOL)
    for name in ("host", "device"):
        assert torch.equal(getattr(s1.rng, name).get_state(),
                           getattr(s0.rng, name).get_state())


@pytest.mark.parametrize("remat,forwards", [(False, 2), (True, 4)])
def test_remat_recomputes_the_propagate_forward(monkeypatch, remat, forwards):
    """Two layers: the kernels' forward runs once a layer, twice under remat
    (the recompute); the backward once a layer either way."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = propagate.RelGATPropagate.forward, propagate.RelGATPropagate.backward

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return staticmethod(run)

    monkeypatch.setattr(propagate.RelGATPropagate, "forward",
                        counted("forward", fwd))
    monkeypatch.setattr(propagate.RelGATPropagate, "backward",
                        counted("backward", bwd))
    cfg, tc, _, _, state, x, g, batch = _step_setup(remat, True)
    loss_and_grads(state.params, cfg, tc, x, g, *batch, rng=state.rng)
    assert calls == {"forward": forwards, "backward": 2}


def test_cli_trains_with_remat_to_the_same_parameters(tmp_path, one_thread):
    """``--remat`` through the CLI, with output and attention dropout on:
    the epoch ends at the parameters of the same run without it (1e-6) and
    the saved training-config.json records the setting."""
    final = "relgat_scorer-distmult_lrscheduler-linear"
    ends = []
    for flags in ([], ["--remat"]):
        out = tmp_path / ("remat" if flags else "plain")
        cli.main(_cli_argv(out) + flags + [
            "--dropout", "0.3", "--dropout-relation-attention", "0.2"])
        saved = json.loads((out / final / "training-config.json").read_text())
        assert saved["model"]["remat"] is bool(flags)
        ends.append(torch.load(out / final / "relgat-model.pt",
                               weights_only=True))
    for a, b in zip(tree_leaves(ends[1]), tree_leaves(ends[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SELF_TOL)
