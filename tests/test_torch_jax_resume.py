"""A run trained with the JAX package resumes in the port.

- A JAX train state after two steps (Adam with weight decay, AdamW with
  weight decay, Adam with clipping: Adam's entry sits at another index of
  optax's chain in each), saved by JAX's ``save_train_state``, loads bit for
  bit: parameters, moments, ``count``, ``step``. One port step from it then
  agrees with one JAX step from the same state within 1e-4: the loss, the
  parameters and both moments. The JAX step's negatives are injected and
  output dropout is off (the RNG rule: JAX's streams do not carry over).
- JAX's key seeds the port's streams deterministically.
- bf16 parameters: on its Pallas route JAX keeps the moments of a bf16
  ``rel_bias`` in fp32 (``tests/test_torch_param_bf16.py`` pins that); such
  a state loads with those moments rounded to bf16, the parameter's type.
- The trainer's ``maybe_resume`` picks a JAX trainer's checkpoint up, with
  its loop state, and trains on.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.models.model import init_model as jax_init_model
from relgat_projector_tpu.train import checkpoint as jax_ckpt
from relgat_projector_tpu.train import state as jax_state
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.models.model import init_model
from relgat_projector_tpu_torch.train.checkpoint import (
    RelGATStorage,
    load_train_state,
)
from relgat_projector_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_train import OPTIMIZERS, TOL, _jax_negatives_and_grads
from tests.test_torch_train import _setup
from tests.test_torch_trainer import _jax_trainer, _trainer


def _jax_adam(state):
    """optax's Adam entry of the chain, wherever clipping and decay put it."""
    found = [s for s in state.opt_state if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _assert_loaded_bit_for_bit(port, jax_st):
    adam = _jax_adam(jax_st)
    for got, want in ((port.params, jax_st.params), (port.opt_state.mu, adam.mu),
                      (port.opt_state.nu, adam.nu)):
        got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(port.opt_state.count) == int(adam.count)
    assert int(port.step) == int(jax_st.step)
    assert int(port.nonfinite_steps) == int(jax_st.nonfinite_steps)
    for t in (port.step, port.opt_state.count, port.nonfinite_steps):
        assert t.dtype == torch.int32 and t.shape == ()


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_one_step_after_resume_matches_jax(tmp_path, opt_name):
    j, p = _setup(opt_name, True, False)
    for _ in range(2):
        j["state"], _ = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
    jax_ckpt.save_train_state(str(tmp_path / "train-state.msgpack"),
                              j["state"])
    state = load_train_state(str(tmp_path / "train-state.pt"), p["state"])
    _assert_loaded_bit_for_bit(state, j["state"])

    neg, _, _ = _jax_negatives_and_grads(j)
    j["state"], jm = j["step"](j["state"], j["x"], j["graph"], *j["batch"])
    state, pm = p["step"](state, p["x"], p["graph"], *p["batch"],
                          neg_dst=torch.from_numpy(neg.astype(np.int64)))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), **TOL)
    assert int(state.step) == int(j["state"].step) == 3
    assert int(state.opt_state.count) == 3
    adam = _jax_adam(j["state"])
    for got, want in ((state.params, j["state"].params),
                      (state.opt_state.mu, adam.mu),
                      (state.opt_state.nu, adam.nu)):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_jax_key_seeds_the_streams(tmp_path):
    j, p = _setup("adam_wd", True, False)
    path = str(tmp_path / "train-state.msgpack")
    draws = []
    for key in (1, 1, 2):
        st = dataclasses.replace(j["state"], rng=jax.random.PRNGKey(key))
        jax_ckpt.save_train_state(path, st)
        rng = load_train_state(path, p["state"]).rng
        draws.append((rng.int32_seed(),
                      float(torch.rand((), generator=rng.device))))
    assert draws[0] == draws[1] != draws[2]


def test_bf16_rel_bias_moments_are_rounded_to_bf16(tmp_path):
    model = dict(in_dim=12, num_rel=3, gat_out_dim=4, gat_heads=2,
                 gat_num_layers=2, projection_layers=2,
                 param_dtype="bfloat16")
    jparams = jax_init_model(jax.random.PRNGKey(0), JaxModelConfig(**model))
    opt = jax_state.make_optimizer(JaxTrainConfig(),
                                   optax.constant_schedule(1e-3))
    jst = jax_state.create_train_state(jparams, opt, jax.random.PRNGKey(1))
    adam = _jax_adam(jst)
    # fp32 moments of rel_bias, as JAX's Pallas route leaves them; values
    # that bf16 cannot hold (a third, and one just past a rounding tie).
    fp32 = {"mu": np.float32([1 / 3, -2 / 3, 1 + 2**-8 + 2**-20]),
            "nu": np.float32([1e-7 / 3, 2.5e-9, 7 / 3])}
    moments = {}
    for name in ("mu", "nu"):
        tree = jax.tree_util.tree_map(lambda a: a, getattr(adam, name))
        for layer in tree["layers"]:
            layer["rel_bias"] = jnp.asarray(fp32[name])
        moments[name] = tree
    jst = dataclasses.replace(jst, opt_state=tuple(
        s._replace(**moments) if isinstance(s, optax.ScaleByAdamState) else s
        for s in jst.opt_state))
    assert _jax_adam(jst).mu["layers"][0]["rel_bias"].dtype == jnp.float32
    jax_ckpt.save_train_state(str(tmp_path / "train-state.msgpack"), jst)

    cfg = ModelConfig(**model)
    params = init_model(cfg, device="cpu")
    template = create_train_state(
        params, make_optimizer(TrainConfig(), lambda c: torch.tensor(1e-3)))
    state = load_train_state(str(tmp_path / "train-state.pt"), template)
    for name in ("mu", "nu"):
        for layer in getattr(state.opt_state, name)["layers"]:
            got = layer["rel_bias"]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, torch.from_numpy(fp32[name]).bfloat16())
        for leaf in tree_leaves(getattr(state.opt_state, name)):
            assert leaf.dtype == torch.bfloat16
    for g, w in zip(tree_leaves(state.params),
                    jax.tree_util.tree_leaves(jparams)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_trainer_resumes_a_jax_trainers_checkpoint(tmp_path):
    jtr = _jax_trainer(tmp_path / "jax", model=dict(gat_num_layers=2))
    jtr.state = dataclasses.replace(jtr.state, step=jnp.asarray(5, jnp.int32))
    jtr.global_step = 5
    ckpt = jtr._save_checkpoint("from_jax")
    loop = json.loads((tmp_path / "jax" / "from_jax" /
                       RelGATStorage.LOOP_STATE_FILE).read_text())
    tr = _trainer(tmp_path / "jax", model=dict(gat_num_layers=2))
    assert tr.storage.latest_resumable() == ckpt
    assert tr.maybe_resume()
    assert tr.global_step == 5 and tr.dispatch_step == loop["dispatch_step"]
    _assert_loaded_bit_for_bit(tr.state, jtr.state)
    batch = tr._device_batch(next(iter(tr.dataset.train_batches(128))))
    tr.state, metrics = tr._train_step(tr.state, tr.node_emb, tr.graph, *batch)
    assert bool(metrics["finite"]) and int(tr.state.step) == 6
