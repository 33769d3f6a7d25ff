"""The port's train step against the JAX train step, step for step.

Shared weights (JAX ``init_model`` -> ``params_from_jax``), shared data, and
the JAX step's own negatives (recomputed from its key and handed to the port
as ``neg_dst``); dropout is off, since those random streams cannot be shared.
Over three steps the loss, every gradient leaf, every parameter after the
update and the step count agree to 1e-4, for Adam with weight decay, AdamW
and clipping. A non-finite loss skips the update and leaves ``step`` alone
on both sides.
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
from relgat_projector_tpu_torch.train.step import (
    loss_and_grads,
    make_eval_step,
    make_train_step,
)
from relgat_projector_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
N, E, R, D, B, K = 100, 500, 4, 16, 32, 5
OPTIMIZERS = {
    "adam_wd": dict(optimizer="adam", weight_decay=1e-2),
    "adamw_wd": dict(optimizer="adamw", weight_decay=1e-2),
    "adam_clip": dict(optimizer="adam", grad_clip_norm=0.05),
}


def _setup(opt_name, port_pallas, ref_pallas, nan_row=False):
    rng = np.random.default_rng(13)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    et = rng.integers(0, R, E)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    batch = [rng.integers(0, N, B), rng.integers(0, R, B), rng.integers(0, N, B)]
    if nan_row:
        emb[batch[0][0]] = np.nan
    model = dict(
        in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2, gat_num_layers=2,
        dropout=0.0, projection_layers=2,
    )
    train = dict(
        train_batch_size=B, num_neg=K, lr=1e-3, lr_scheduler="linear",
        warmup_steps=1, eval_ks_ranks=(1, 2), use_self_adv_neg=True,
        **OPTIMIZERS[opt_name],
    )
    jg = jax_build_graph(src, dst, et, N, blocked=ref_pallas, block_nodes=16,
                         chunk_edges=64)
    jcfg = JaxModelConfig(**model, use_pallas=ref_pallas)
    jtc = JaxTrainConfig(**train)
    jsched = jax_schedule(jtc.lr, "linear", 10, 1)
    jopt = jax_state.make_optimizer(jtc, jsched)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jx = jnp.asarray(pad_node_embeddings(emb, jg.num_nodes))
    jb = [jnp.asarray(a, jnp.int32) for a in batch] + [jnp.ones((B,), jnp.float32)]
    jax_side = dict(
        cfg=jcfg, tc=jtc, graph=jg, x=jx, batch=jb,
        state=jax_state.create_train_state(jparams, jopt, jax.random.PRNGKey(1)),
        step=jax_step.make_train_step(jcfg, jtc, jopt, jsched),
    )

    cfg = ModelConfig(**model, use_pallas=port_pallas)
    tc = TrainConfig(**train)
    g = build_graph(src, dst, et, N, num_rel=R, csr=port_pallas, device="cpu")
    sched = make_lr_schedule(tc.lr, "linear", 10, 1)
    opt = make_optimizer(tc, sched)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    port_side = dict(
        cfg=cfg, tc=tc, graph=g,
        x=torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)),
        batch=[torch.from_numpy(a) for a in batch] + [torch.ones(B)],
        state=create_train_state(params, opt, seed=1),
        step=make_train_step(cfg, tc, opt, sched),
    )
    return jax_side, port_side


def _jax_negatives_and_grads(j):
    """The negatives the JAX step draws at its current step, and its loss
    and gradients on them."""
    st = j["state"]
    step_rng = jax.random.fold_in(st.rng, st.step)
    _, neg_rng = jax.random.split(step_rng)
    neg = sample_negative_dst(neg_rng, j["batch"][2], num_nodes=N, num_neg=K)

    def loss_fn(p):
        return jax_step.batch_forward(
            p, j["cfg"], j["tc"], j["x"], j["graph"], *j["batch"],
            rng=step_rng, train=True,
        )

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(st.params)
    return np.asarray(neg), float(loss), jax.tree_util.tree_leaves(grads)


# The batch and its negatives touch real rows only, so the kernels' step and
# the XLA step compute the same loss and gradients (the XLA path's nonzero
# padded row never reaches a real one); the Pallas step, slow in interpret
# mode, is compared once.
@pytest.mark.parametrize(
    "opt_name,port_pallas,ref_pallas",
    [(name, True, False) for name in sorted(OPTIMIZERS)]
    + [("adam_wd", False, False), ("adam_wd", True, True)],
)
def test_three_steps_match_jax(opt_name, port_pallas, ref_pallas):
    j, p = _setup(opt_name, port_pallas, ref_pallas)
    for t in range(3):
        neg, want_loss, want_grads = _jax_negatives_and_grads(j)
        neg_t = torch.from_numpy(neg.astype(np.int64))
        loss, _, grads = loss_and_grads(
            p["state"].params, p["cfg"], p["tc"], p["x"], p["graph"],
            *p["batch"], rng=None, neg_dst=neg_t,
        )
        np.testing.assert_allclose(float(loss), want_loss, **TOL)
        got_grads = tree_leaves(grads)
        assert len(got_grads) == len(want_grads)
        for got, want in zip(got_grads, want_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

        j["state"], jm = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
        p["state"], pm = p["step"](
            p["state"], p["x"], p["graph"], *p["batch"], neg_dst=neg_t
        )
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(
            float(pm["grad_norm"]), float(jm["grad_norm"]), **TOL
        )
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), **TOL)
        np.testing.assert_allclose(float(pm["mrr"]), float(jm["mrr"]), **TOL)
        assert int(p["state"].step) == int(j["state"].step) == t + 1
        for got, want in zip(
            tree_leaves(p["state"].params),
            jax.tree_util.tree_leaves(j["state"].params),
        ):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nonfinite_loss_skips_update_without_advancing_step():
    j, p = _setup("adam_wd", True, False, nan_row=True)
    neg, want_loss, _ = _jax_negatives_and_grads(j)
    assert not np.isfinite(want_loss)
    before = [t.clone() for t in tree_leaves(p["state"].params)]
    j["state"], jm = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
    p["state"], pm = p["step"](
        p["state"], p["x"], p["graph"], *p["batch"],
        neg_dst=torch.from_numpy(neg.astype(np.int64)),
    )
    assert not bool(pm["finite"]) and not bool(jm["finite"])
    assert int(p["state"].step) == int(j["state"].step) == 0
    assert int(p["state"].nonfinite_steps) == int(j["state"].nonfinite_steps) == 1
    assert int(p["state"].opt_state.count) == 0
    for a, b in zip(tree_leaves(p["state"].params), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sampled_negatives_run_without_injection():
    _, p = _setup("adamw_wd", True, False)
    state, m = p["step"](p["state"], p["x"], p["graph"], *p["batch"])
    assert bool(m["finite"]) and float(m["grad_norm"]) > 0
    assert int(state.step) == 1


@pytest.mark.parametrize("port_pallas", (False, True))
def test_eval_step_matches_jax(port_pallas):
    """``eval_repr`` once, then ``eval_step``'s example-weighted sums on the
    JAX eval step's own negatives; real rows of the representations."""
    j, p = _setup("adam_wd", port_pallas, False)
    j_repr, j_eval = jax_step.make_eval_step(j["cfg"], j["tc"])
    p_repr, p_eval = make_eval_step(p["cfg"], p["tc"])
    rng = jax.random.PRNGKey(5)
    _, neg_rng = jax.random.split(rng)
    neg = sample_negative_dst(neg_rng, j["batch"][2], num_nodes=N, num_neg=K)
    jx = j_repr(j["state"].params, j["x"], j["graph"])
    px = p_repr(p["state"].params, p["x"], p["graph"])
    np.testing.assert_allclose(px.numpy()[:N], np.asarray(jx)[:N], **TOL)
    want = j_eval(j["state"].params, jx, j["graph"], *j["batch"], rng)
    got = p_eval(
        p["state"].params, px, p["graph"], *p["batch"],
        neg_dst=torch.from_numpy(np.asarray(neg).astype(np.int64)),
    )
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL)
