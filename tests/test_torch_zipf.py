"""Eight train steps on a zipf graph, the port against the JAX step.

On a graph whose in-degree sits on hubs (dst drawn with p ~ 1/rank, as
``bench.py``'s zipf class draws it) the gradient norm grows step by step.
This holds the port to the JAX train step over 8 steps on ~300 nodes, on
shared weights and the JAX step's own negatives (handed to the port), with
dropout off: the loss and the gradient norm of every step agree to 1e-4
(the repo's parity contract), as do the parameters after the last step. So
the growth is the model's behaviour on such graphs, not the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.data.graph import build_graph as jax_build_graph
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu.ops.sampling import sample_negative_dst
from relgat_projector_tpu.schedules import make_lr_schedule as jax_schedule
from relgat_projector_tpu.train import state as jax_state
from relgat_projector_tpu.train import step as jax_step
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import make_train_step
from relgat_projector_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
N, E, R, D, B, K, STEPS = 300, 1500, 6, 16, 32, 8, 8
# The production script's loss and optimizer (run-relgat-trainer-base-
# model.sh), at a learning rate that moves the small model within 8 steps.
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.0, projection_layers=2,
             projection_dropout=0.0, scorer_type="distmult")
TRAIN = dict(train_batch_size=B, num_neg=K, lr=1e-2, lr_scheduler="linear",
             warmup_steps=2, weight_decay=1e-4, use_self_adv_neg=True,
             self_adv_alpha=1.0, mse_weight=0.0, eval_ks_ranks=(1, 2))


def _zipf_inputs():
    rng = np.random.default_rng(41)
    p = 1.0 / np.arange(1, N + 1)
    src = rng.integers(0, N, E)
    dst = rng.choice(N, size=E, p=p / p.sum())
    et = rng.integers(0, R, E)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    picks = rng.integers(0, E, (STEPS, B))
    return src, dst, et, emb, picks


@pytest.mark.parametrize("port_pallas", (False, True),
                         ids=("plain", "kernels"))
def test_eight_zipf_steps_match_jax(port_pallas):
    src, dst, et, emb, picks = _zipf_inputs()
    assert np.bincount(dst, minlength=N).max() > 200  # a hub row
    jg = jax_build_graph(src, dst, et, N)
    jcfg = JaxModelConfig(**MODEL)
    jtc = JaxTrainConfig(**TRAIN)
    jsched = jax_schedule(jtc.lr, "linear", 20, 2)
    jopt = jax_state.make_optimizer(jtc, jsched)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jstate = jax_state.create_train_state(jparams, jopt, jax.random.PRNGKey(1))
    jstep = jax_step.make_train_step(jcfg, jtc, jopt, jsched)
    jx = jnp.asarray(pad_node_embeddings(emb, jg.num_nodes))

    cfg = ModelConfig(**MODEL, use_pallas=port_pallas)
    tc = TrainConfig(**TRAIN)
    g = build_graph(src, dst, et, N, num_rel=R, csr=port_pallas, device="cpu")
    sched = make_lr_schedule(tc.lr, "linear", 20, 2)
    opt = make_optimizer(tc, sched)
    state = create_train_state(
        params_from_jax(jax.device_get(jparams), device="cpu"), opt, seed=1)
    step = make_train_step(cfg, tc, opt, sched)
    x = torch.from_numpy(pad_node_embeddings(emb, g.num_nodes))
    weight = np.ones((B,), np.float32)

    norms = []
    for t in range(STEPS):
        batch = [src[picks[t]], et[picks[t]], dst[picks[t]]]
        jb = [jnp.asarray(a, jnp.int32) for a in batch] + [jnp.asarray(weight)]
        step_rng = jax.random.fold_in(jstate.rng, jstate.step)
        _, neg_rng = jax.random.split(step_rng)
        neg = sample_negative_dst(neg_rng, jb[2], num_nodes=N, num_neg=K)
        jstate, jm = jstep(jstate, jx, jg, *jb)
        state, pm = step(
            state, x, g, *(torch.from_numpy(a) for a in batch),
            torch.from_numpy(weight),
            neg_dst=torch.from_numpy(np.asarray(neg).astype(np.int64)),
        )
        assert bool(pm["finite"]) and bool(jm["finite"])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        norms.append(float(jm["grad_norm"]))
    for got, want in zip(tree_leaves(state.params),
                         jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(state.step) == int(jstate.step) == STEPS
    assert all(np.isfinite(norms))
