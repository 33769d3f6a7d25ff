"""bf16 parameters (``param_dtype="bfloat16"``), the port against JAX.

- ``init_model`` stores every leaf in the parameter dtype, as JAX's does.
- Three train steps against the JAX step on shared bf16 weights (carried
  across bit for bit by ``params_from_jax``) and the JAX step's own
  negatives, with fp32 compute and in the full bf16 mode (bf16 compute and
  the kernels' bf16 rows): the loss and the parameters within 1e-2 of the
  largest value, the bf16 mode's bar. A leaf drawn at random is held to
  its own largest value (``max|a - b| <= 1e-2 * max|b|``; a rounding that
  falls the other way moves a bf16 value by 2^-8 of the leaf's size). The
  leaves that start at zero (``rel_bias``, ``ln_bias``) are held to the
  largest parameter of the tree: they hold nothing but three Adam updates
  of about ``lr`` each, every one the bf16 quotient of bf16 moments, so
  one flipped rounding upstream of it moves them by 2^-7 of their own size
  and more where two steps' gradients nearly cancel in the moment (and on
  the Pallas route JAX keeps those of ``rel_bias`` in fp32, below).
- Adam's moments take each parameter's dtype, as optax's ``scale_by_adam``
  makes them, leaf by leaf, with one difference pinned here: on the Pallas
  route JAX returns an fp32 gradient for a bf16 ``rel_bias`` (its custom
  VJP does not cast it), so optax's moments of that leaf become fp32 after
  the first step, where the port's autograd casts the gradient to the
  leaf's bf16 (``ROADMAP.md`` Queue 3, "Known and kept").
- The train state round-trips bit for bit through a checkpoint, mixed
  dtypes included, and the trainer trains and resumes with bf16 parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from relgat_projector_tpu_torch.models.model import init_model
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
)
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import make_train_step
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.test_torch_trainer import _assert_states_equal, _trainer

BF16_TOL = 1e-2  # of the largest value
N, E, R, D, B, K = 100, 500, 4, 16, 32, 5
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.0, projection_layers=2,
             param_dtype="bfloat16")
TRAIN = dict(train_batch_size=B, num_neg=K, lr=1e-3, lr_scheduler="linear",
             warmup_steps=1, eval_ks_ranks=(1, 2), use_self_adv_neg=True,
             optimizer="adam", weight_decay=1e-2)
MODES = {"fp32_compute": {},
         "bf16_mode": dict(compute_dtype="bfloat16",
                           kernel_precision="default")}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bits(t):
    """A bf16 tensor's or array's 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _setup(mode, port_pallas, ref_pallas):
    rng = np.random.default_rng(21)
    src, dst, et = (rng.integers(0, N, E), rng.integers(0, N, E),
                    rng.integers(0, R, E))
    emb = rng.standard_normal((N, D)).astype(np.float32)
    batch = [rng.integers(0, N, B), rng.integers(0, R, B),
             rng.integers(0, N, B)]
    model = dict(MODEL, **MODES[mode])
    jg = jax_build_graph(src, dst, et, N, blocked=ref_pallas, block_nodes=16,
                         chunk_edges=64)
    jcfg = JaxModelConfig(**model, use_pallas=ref_pallas)
    jtc = JaxTrainConfig(**TRAIN)
    jsched = jax_schedule(jtc.lr, "linear", 10, 1)
    jopt = jax_state.make_optimizer(jtc, jsched)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    j = dict(cfg=jcfg, graph=jg,
             x=jnp.asarray(pad_node_embeddings(emb, jg.num_nodes)),
             batch=[jnp.asarray(a, jnp.int32) for a in batch]
             + [jnp.ones((B,), jnp.float32)],
             state=jax_state.create_train_state(jparams, jopt,
                                                jax.random.PRNGKey(1)),
             step=jax_step.make_train_step(jcfg, jtc, jopt, jsched))
    cfg = ModelConfig(**model, use_pallas=port_pallas)
    tc = TrainConfig(**TRAIN)
    g = build_graph(src, dst, et, N, num_rel=R, csr=port_pallas, device="cpu")
    sched = make_lr_schedule(tc.lr, "linear", 10, 1)
    opt = make_optimizer(tc, sched)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    p = dict(cfg=cfg, graph=g,
             x=torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)),
             batch=[torch.from_numpy(a) for a in batch] + [torch.ones(B)],
             state=create_train_state(params, opt, seed=1),
             step=make_train_step(cfg, tc, opt, sched))
    return j, p


def _jax_negatives(j):
    step_rng = jax.random.fold_in(j["state"].rng, j["state"].step)
    _, neg_rng = jax.random.split(step_rng)
    neg = sample_negative_dst(neg_rng, j["batch"][2], num_nodes=N, num_neg=K)
    return torch.from_numpy(np.asarray(neg).astype(np.int64))


def _jax_adam(opt_state):
    (adam,) = [s for s in opt_state
               if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _run_steps(j, p, steps):
    """The worst relative errors over ``steps`` steps: of the loss, of the
    leaves drawn at random (to each leaf's largest value) and of the
    leaves that start at zero (to the tree's largest value)."""
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(j["state"].params)[0]]
    worst = {"loss": 0.0, "random_leaves": 0.0, "zero_leaves": 0.0}
    for _ in range(steps):
        neg = _jax_negatives(j)
        j["state"], jm = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
        p["state"], pm = p["step"](p["state"], p["x"], p["graph"],
                                   *p["batch"], neg_dst=neg)
        assert bool(pm["finite"]) and bool(jm["finite"])
        worst["loss"] = max(worst["loss"],
                            _rel(float(pm["loss"]), float(jm["loss"])))
        got = [t.float().numpy() for t in tree_leaves(p["state"].params)]
        want = [np.asarray(a, np.float32)
                for a in jax.tree_util.tree_leaves(j["state"].params)]
        top = max(np.abs(w).max() for w in want)
        for path, a, b in zip(paths, got, want):
            if "bias" in path:
                err = float(np.abs(a - b).max() / top)
                worst["zero_leaves"] = max(worst["zero_leaves"], err)
            else:
                worst["random_leaves"] = max(worst["random_leaves"],
                                             _rel(a, b))
        for t, a in zip(tree_leaves(p["state"].params),
                        jax.tree_util.tree_leaves(j["state"].params)):
            assert t.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
    return worst


def test_init_model_stores_the_parameter_dtype():
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        cfg = ModelConfig(**{**MODEL, "param_dtype": dtype})
        params = init_model(cfg, seed=0, device="cpu")
        assert {t.dtype for t in tree_leaves(params)} == {want}
        jparams = jax.eval_shape(
            lambda k: jax_init_model(
                k, JaxModelConfig(**{**MODEL, "param_dtype": dtype})),
            jax.random.PRNGKey(0))
        assert [tuple(t.shape) for t in tree_leaves(params)] == [
            a.shape for a in jax.tree_util.tree_leaves(jparams)]
        assert {a.dtype.name for a in jax.tree_util.tree_leaves(jparams)} \
            == {dtype}


def test_params_from_jax_carries_bf16_bit_for_bit():
    jparams = jax.device_get(jax_init_model(
        jax.random.PRNGKey(4), JaxModelConfig(**MODEL)))
    params = params_from_jax(jparams, device="cpu")
    for got, want in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_bits(got), _bits(want))
    mixed = params_from_jax({"a": np.ones(3, np.float32),
                             "b": np.asarray(jnp.ones(3, jnp.bfloat16))},
                            device="cpu")
    assert (mixed["a"].dtype, mixed["b"].dtype) == (torch.float32,
                                                    torch.bfloat16)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("port_pallas,ref_pallas",
                         [(False, False), (True, False), (True, True)],
                         ids=["plain-xla", "kernels-xla", "kernels-pallas"])
def test_three_steps_match_jax_with_bf16_params(mode, port_pallas,
                                                ref_pallas):
    j, p = _setup(mode, port_pallas, ref_pallas)
    worst = _run_steps(j, p, 3)
    assert max(worst.values()) <= BF16_TOL, worst
    assert int(p["state"].step) == int(j["state"].step) == 3


@pytest.mark.parametrize("ref_pallas", (False, True), ids=("xla", "pallas"))
def test_moment_dtypes_follow_optax(ref_pallas):
    """Leaf by leaf after one step: the port's moments are bf16 everywhere;
    optax's are too on the XLA route, and on the Pallas route all but
    ``layers[*].rel_bias``'s, which the fp32 gradient made fp32."""
    j, p = _setup("fp32_compute", True, ref_pallas)
    _run_steps(j, p, 1)
    adam = _jax_adam(j["state"].opt_state)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(adam.mu)[0]]
    for got_tree, want_tree in ((p["state"].opt_state.mu, adam.mu),
                                (p["state"].opt_state.nu, adam.nu)):
        got = [t.dtype for t in tree_leaves(got_tree)]
        want = [a.dtype.name for a in jax.tree_util.tree_leaves(want_tree)]
        assert got == [torch.bfloat16] * len(paths)
        differ = [path for path, w in zip(paths, want) if w != "bfloat16"]
        if ref_pallas:
            assert differ == ["['layers'][0]['rel_bias']",
                              "['layers'][1]['rel_bias']"]
            assert {want[paths.index(d)] for d in differ} == {"float32"}
        else:
            assert differ == []


def test_jax_pallas_route_returns_an_fp32_rel_bias_gradient():
    """The JAX quirk the moment test pins, at its source: the gradient tree
    of a bf16 model on the Pallas route."""
    j, p = _setup("fp32_compute", True, True)
    step_rng = jax.random.fold_in(j["state"].rng, j["state"].step)

    def loss_fn(params):
        return jax_step.batch_forward(
            params, j["cfg"], TrainConfig(**TRAIN), j["x"], j["graph"],
            *j["batch"], rng=step_rng, train=True)[0]

    grads = jax.eval_shape(jax.grad(loss_fn), j["state"].params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    fp32 = [jax.tree_util.keystr(k) for k, a in flat if a.dtype != jnp.bfloat16]
    assert fp32 == ["['layers'][0]['rel_bias']", "['layers'][1]['rel_bias']"]


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    _, p = _setup("fp32_compute", True, False)
    p["state"], _ = p["step"](p["state"], p["x"], p["graph"], *p["batch"])
    state = p["state"]
    # A mixed tree: one leaf fp32 among the bf16 ones.
    state.params["layers"][0]["rel_bias"] = \
        state.params["layers"][0]["rel_bias"].float()
    path = str(tmp_path / "train-state.pt")
    save_train_state(path, state)
    back = load_train_state(path, state)
    _assert_states_equal(state, back)
    for a, b in zip(tree_leaves(state.params) + tree_leaves(state.opt_state.mu),
                    tree_leaves(back.params) + tree_leaves(back.opt_state.mu)):
        assert a.dtype == b.dtype
    assert back.params["layers"][0]["rel_bias"].dtype == torch.float32
    assert back.params["layers"][0]["proj"].dtype == torch.bfloat16


def test_trainer_trains_and_resumes_with_bf16_params(tmp_path):
    """The trainer (the CLI has no flag for it, as in the JAX package):
    an epoch in bf16 parameters and moments, a finite eval, and a resume
    that restores every leaf with its dtype."""
    model = dict(param_dtype="bfloat16", use_pallas=True)
    tr = _trainer(tmp_path, model=model, epochs=1)
    tr.train()
    assert int(tr.state.step) > 0
    assert np.isfinite(tr.evaluate()[0])
    for t in (tree_leaves(tr.state.params) + tree_leaves(tr.state.opt_state.mu)
              + tree_leaves(tr.state.opt_state.nu)):
        assert t.dtype == torch.bfloat16
    again = _trainer(tmp_path, model=model, epochs=1)
    assert again.maybe_resume()
    _assert_states_equal(tr.state, again.state)
    assert tree_map(lambda t: t.dtype, again.state.params) == tree_map(
        lambda t: t.dtype, tr.state.params)
