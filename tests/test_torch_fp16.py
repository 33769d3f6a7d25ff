"""float16 compute and parameters, and every dtype name, the port against
JAX.

- Every dtype name a config could hold resolves as the JAX package's
  ``jnp.dtype`` and storage resolve it (x64 off: ``float64`` is stored as
  float32): ``param_dtype`` stores what JAX's ``init_model`` stores, or
  raises the class of error JAX raises; ``compute_dtype`` gives JAX's
  product and gradients (``device.compute_matmul`` against ``jnp.dot(x.
  astype(t), w.astype(t), preferred_element_type=float32)``), float,
  integer, boolean and complex types alike.
- ``compute_dtype="float16"`` (fp32 parameters): one training forward and
  backward on shared weights and the JAX step's own negatives, JAX's XLA
  route against the port's plain route and JAX's Pallas route (interpret
  mode) against the kernels' plain versions. The loss within 1e-3
  (relative) and every gradient within 1e-2 of its largest value, the bf16
  mode's bars (measured 3.8e-7 and 9.0e-4 on both pairs of routes); with
  a test-local backward that keeps the cotangent fp32, as JAX's VJP does
  on the CPU, within 1e-3 (measured 3.4e-4). Three Adam steps then keep
  the loss within 1e-2 (measured at most 2.8e-5).
- ``param_dtype="float16"``: three steps on shared fp16 weights. JAX's
  fp16 Adam divides by ``sqrt(nu) + eps`` in fp16, where eps (1e-8)
  rounds to 0 and a small gradient's square to 0, so some updates are
  0 / 0 and the parameters go non-finite: JAX's ``finite`` flag and
  ``nonfinite_scores`` are held step for step (the port reproduces the
  steps JAX skips, and does not repair them), and the losses of finite
  steps within 1e-2. The storage types of the parameters and of both Adam
  moments are pinned leaf by leaf, with JAX's fp32 moments of
  ``rel_bias`` on its Pallas route (``ROADMAP.md`` Queue 3).
- A float16 JAX tree comes across bit for bit through ``params_from_jax``,
  through a JAX msgpack checkpoint (``load_from_pretrained``), and through
  a reference ``state_dict`` round trip whose import names
  ``param_dtype="float16"``.
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
from relgat_projector_tpu.models.model import (
    save_pretrained as jax_save_pretrained,
)
from relgat_projector_tpu.ops.sampling import sample_negative_dst
from relgat_projector_tpu.schedules import make_lr_schedule as jax_schedule
from relgat_projector_tpu.train import state as jax_state
from relgat_projector_tpu.train import step as jax_step
from relgat_projector_tpu_torch import config as tconfig
from relgat_projector_tpu_torch import device
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.graph import build_graph, pad_node_embeddings
from relgat_projector_tpu_torch.device import compute_matmul
from relgat_projector_tpu_torch.interop import (
    export_torch_state_dict,
    import_torch_state_dict,
    params_from_jax,
)
from relgat_projector_tpu_torch.models.model import load_from_pretrained
from relgat_projector_tpu_torch.schedules import make_lr_schedule
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import loss_and_grads, make_train_step
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_bf16 import _Fp32CotangentMatMul

STEP_LOSS_TOL = 1e-3       # relative
STEP_GRAD_TOL = 1e-2       # of each gradient's largest value
FP32_COTANGENT_GRAD_TOL = 1e-3
LOSS_TOL = 1e-2            # three Adam steps
N, E, R, D, B, K = 100, 500, 4, 16, 32, 5
MODEL = dict(in_dim=D, num_rel=R, gat_out_dim=8, gat_heads=2,
             gat_num_layers=2, dropout=0.0, projection_layers=2)
TRAIN = dict(train_batch_size=B, num_neg=K, lr=1e-3, lr_scheduler="linear",
             warmup_steps=1, eval_ks_ranks=(1, 2), use_self_adv_neg=True,
             optimizer="adam", weight_decay=1e-2)
ROUTES = dict(argnames="port_pallas,ref_pallas",
              argvalues=[(False, False), (True, True)],
              ids=["plain-xla", "kernels-pallas"])
NAMES = ("float16", "half", "f2", "float64", "double", "float", "single",
         "bfloat16", "float8_e4m3fn", "float8_e5m2", "int32", "int8",
         "uint8", "bool", "complex64", "float128", "float17")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_outcome(fn):
    try:
        return fn(), None
    except Exception as exc:  # the class of JAX's error is the answer
        return None, exc


@pytest.mark.parametrize("name", NAMES)
def test_param_dtype_names_store_what_jax_stores(name):
    def init_and_promote(key):
        params = jax_init_model(key, JaxModelConfig(
            **dict(MODEL, param_dtype=name)))
        leaves = jax.tree_util.tree_leaves(params)
        # JAX's forward is where float8 parameters fail.
        jnp.ones((2,), jnp.float32) * leaves[0].reshape(-1)[:2]
        return params

    def jax_init():
        params = jax.eval_shape(init_and_promote, jax.random.PRNGKey(0))
        return {a.dtype.name for a in jax.tree_util.tree_leaves(params)}

    want, err = _jax_outcome(jax_init)
    if err is not None:
        # JAX's TypePromotionError is a ValueError.
        want_err = ValueError if isinstance(err, ValueError) else type(err)
        with pytest.raises(want_err, match="param_dtype"):
            ModelConfig(**dict(MODEL, param_dtype=name))
        return
    cfg = ModelConfig(**dict(MODEL, param_dtype=name))
    assert {str(torch.zeros(0, dtype=tconfig.torch_dtype(cfg.param_dtype))
                .dtype).removeprefix("torch.")} == want


@pytest.mark.parametrize("name", NAMES)
def test_compute_dtype_names_give_jax_products(name):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((12, 24)) * 3).astype(np.float32)
    w = (rng.standard_normal((24, 10)) * 2).astype(np.float32)
    g = rng.standard_normal((12, 10)).astype(np.float32)

    def jax_fn():
        def f(a, b):
            return jnp.dot(a.astype(name), b.astype(name),
                           preferred_element_type=jnp.float32)

        y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        return [np.asarray(t, np.float32) for t in (y, *vjp(jnp.asarray(g)))]

    want, err = _jax_outcome(jax_fn)
    if err is not None:
        with pytest.raises(TypeError, match="compute_dtype"):
            ModelConfig(**dict(MODEL, compute_dtype=name))
        return
    cfg = ModelConfig(**dict(MODEL, compute_dtype=name))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = compute_matmul(xt, wt, tconfig.torch_dtype(cfg.compute_dtype))
    assert y.dtype == torch.float32
    if y.requires_grad:
        # The port rounds the cotangent of a half-type product to that
        # type; JAX keeps it fp32. Round it here so the two take the same.
        gt = torch.from_numpy(g)
        if tconfig.torch_dtype(name) in device.HALF_TYPES:
            gt = gt.to(tconfig.torch_dtype(name)).float()
        dx, dw = torch.autograd.grad(y, (xt, wt), gt)
        want_g = jax.vjp(
            lambda a, b: jnp.dot(a.astype(name), b.astype(name),
                                 preferred_element_type=jnp.float32),
            jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(gt.numpy()))
        want = want[:1] + [np.asarray(t, np.float32) for t in want_g]
        got = [y.detach(), dx, dw]
    else:
        got = [y, torch.zeros_like(xt), torch.zeros_like(wt)]
    for a, b in zip(got, want):
        a = a.detach().numpy()
        assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0), name


def _graph_inputs(seed):
    rng = np.random.default_rng(seed)
    src, dst, et = (rng.integers(0, N, E), rng.integers(0, N, E),
                    rng.integers(0, R, E))
    emb = rng.standard_normal((N, D)).astype(np.float32)
    batch = [rng.integers(0, N, B), rng.integers(0, R, B),
             rng.integers(0, N, B)]
    return src, dst, et, emb, batch


def _setup(model, port_pallas, ref_pallas, seed=21):
    src, dst, et, emb, batch = _graph_inputs(seed)
    jg = jax_build_graph(src, dst, et, N, blocked=ref_pallas, block_nodes=16,
                         chunk_edges=64)
    jcfg = JaxModelConfig(**model, use_pallas=ref_pallas)
    jtc = JaxTrainConfig(**TRAIN)
    jsched = jax_schedule(jtc.lr, "linear", 10, 1)
    jopt = jax_state.make_optimizer(jtc, jsched)
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    j = dict(cfg=jcfg, tc=jtc, graph=jg,
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
    p = dict(cfg=cfg, tc=tc, graph=g,
             x=torch.from_numpy(pad_node_embeddings(emb, g.num_nodes)),
             batch=[torch.from_numpy(a) for a in batch] + [torch.ones(B)],
             state=create_train_state(params, opt, seed=1),
             step=make_train_step(cfg, tc, opt, sched))
    return j, p


def _jax_negatives(j):
    step_rng = jax.random.fold_in(j["state"].rng, j["state"].step)
    _, neg_rng = jax.random.split(step_rng)
    neg = sample_negative_dst(neg_rng, j["batch"][2], num_nodes=N, num_neg=K)
    return step_rng, torch.from_numpy(np.asarray(neg).astype(np.int64))


def _step_errors(port_pallas, ref_pallas, seed):
    """Loss error (relative) and the worst gradient error (to each
    gradient's largest value) of one fp16-compute training forward and
    backward."""
    model = dict(MODEL, compute_dtype="float16")
    j, p = _setup(model, port_pallas, ref_pallas, seed)
    step_rng, neg = _jax_negatives(j)

    def loss_fn(params):
        return jax_step.batch_forward(params, j["cfg"], j["tc"], j["x"],
                                      j["graph"], *j["batch"], rng=step_rng,
                                      train=True)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        j["state"].params)
    loss, _, grads = loss_and_grads(p["state"].params, p["cfg"], p["tc"],
                                    p["x"], p["graph"], *p["batch"],
                                    rng=None, neg_dst=neg)
    errs = [_rel(a.numpy(), b) for a, b in
            zip(tree_leaves(grads), jax.tree_util.tree_leaves(want))]
    return _rel(float(loss), float(want_loss)), max(errs)


@pytest.mark.parametrize(**ROUTES)
def test_fp16_compute_step_matches_jax(port_pallas, ref_pallas):
    loss_err, grad_err = _step_errors(port_pallas, ref_pallas, 13)
    assert loss_err <= STEP_LOSS_TOL
    assert grad_err <= STEP_GRAD_TOL


@pytest.mark.parametrize(**ROUTES)
def test_fp16_compute_step_with_fp32_cotangent_meets_jax_closely(
        port_pallas, ref_pallas, monkeypatch):
    monkeypatch.setattr(device, "_CastMatMul", _Fp32CotangentMatMul)
    loss_err, grad_err = _step_errors(port_pallas, ref_pallas, 13)
    assert loss_err <= STEP_LOSS_TOL
    assert grad_err <= FP32_COTANGENT_GRAD_TOL


def _run_steps(j, p, steps):
    """Each step's ``(finite, nonfinite_scores, loss)`` in both packages."""
    out = []
    for _ in range(steps):
        _, neg = _jax_negatives(j)
        j["state"], jm = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
        p["state"], pm = p["step"](p["state"], p["x"], p["graph"],
                                   *p["batch"], neg_dst=neg)
        out.append(((bool(pm["finite"]), int(pm["nonfinite_scores"]),
                     float(pm["loss"])),
                    (bool(jm["finite"]), int(jm["nonfinite_scores"]),
                     float(jm["loss"]))))
    return out


@pytest.mark.parametrize(**ROUTES)
def test_three_fp16_compute_steps_match_jax(port_pallas, ref_pallas):
    j, p = _setup(dict(MODEL, compute_dtype="float16"), port_pallas,
                  ref_pallas)
    for got, want in _run_steps(j, p, 3):
        assert got[0] and want[0]
        assert _rel(got[2], want[2]) <= LOSS_TOL


@pytest.mark.parametrize(**ROUTES)
def test_fp16_params_take_jax_steps_finite_flags_included(port_pallas,
                                                          ref_pallas):
    j, p = _setup(dict(MODEL, param_dtype="float16"), port_pallas,
                  ref_pallas)
    steps = _run_steps(j, p, 3)
    assert [s[0][:2] for s in steps] == [s[1][:2] for s in steps]
    assert not steps[-1][1][0]  # JAX's fp16 Adam does go non-finite
    for got, want in steps:
        if want[0]:
            assert _rel(got[2], want[2]) <= LOSS_TOL
    assert int(p["state"].step) == int(j["state"].step)
    assert int(p["state"].nonfinite_steps) == int(j["state"].nonfinite_steps)

    # Storage types leaf by leaf: fp16 everywhere in the port; optax's
    # too, but for the fp32 moments of rel_bias on JAX's Pallas route.
    (adam,) = [s for s in j["state"].opt_state
               if isinstance(s, optax.ScaleByAdamState)]
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(adam.mu)[0]]
    fp32 = (["['layers'][0]['rel_bias']", "['layers'][1]['rel_bias']"]
            if ref_pallas else [])
    for got_tree, want_tree in ((p["state"].params, j["state"].params),
                                (p["state"].opt_state.mu, adam.mu),
                                (p["state"].opt_state.nu, adam.nu)):
        got = [t.dtype for t in tree_leaves(got_tree)]
        want = [a.dtype.name for a in jax.tree_util.tree_leaves(want_tree)]
        assert got == [torch.float16] * len(paths)
        params = want_tree is j["state"].params
        assert [pa for pa, w in zip(paths, want) if w != "float16"] == (
            [] if params else fp32)


def _fp16_jax_params():
    return jax.device_get(jax_init_model(jax.random.PRNGKey(4), JaxModelConfig(
        **dict(MODEL, param_dtype="float16"))))


def _bits_equal(got, want):
    assert got.dtype == torch.float16
    return np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


def test_params_from_jax_carries_fp16_bit_for_bit():
    jparams = _fp16_jax_params()
    params = params_from_jax(jparams, device="cpu")
    assert all(_bits_equal(a, b) for a, b in
               zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)))
    mixed = params_from_jax({"a": np.ones(3, np.float32),
                             "b": np.ones(3, np.float16),
                             "c": np.asarray(jnp.ones(3, jnp.bfloat16))},
                            device="cpu")
    assert [mixed[k].dtype for k in "abc"] == [torch.float32, torch.float16,
                                               torch.bfloat16]


def test_fp16_jax_checkpoint_and_state_dict_round_trip(tmp_path):
    jparams = _fp16_jax_params()
    jcfg = JaxModelConfig(**dict(MODEL, param_dtype="float16"))
    jax_save_pretrained(str(tmp_path / "jax"), jparams, jcfg)
    params, cfg = load_from_pretrained(
        str(tmp_path / "jax"), node_emb=np.zeros((1, D), np.float32),
        device="cpu")
    assert cfg.param_dtype == "float16"
    assert all(_bits_equal(a, b) for a, b in
               zip(tree_leaves(params), jax.tree_util.tree_leaves(jparams)))
    sd = export_torch_state_dict(params)
    assert {t.dtype for k, t in sd.items()
            if k != "node_emb_fixed"} == {torch.float16}
    back, back_cfg = import_torch_state_dict(sd, device="cpu")
    assert back_cfg.param_dtype == "float16"
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(params)))
