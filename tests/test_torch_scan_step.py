"""``steps_per_call > 1``: several train steps a call, the scanned epoch.

Mirrors the JAX package's ``tests/test_train.py`` on the port:

- two epochs at 4 steps a call end at the per-step epochs' parameters
  (1e-6) and step count, with output, attention and projection dropout on
  (both dispatch modes draw the same numbers in the same order), and
  ``make_scan_train_step`` equals 4 calls of ``make_train_step`` on
  injected negatives;
- a zero-weight batch (the tail padding) changes no parameter, moment,
  count or step, and a padding step draws nothing from the generators, so
  the next epoch draws what it would after a per-step epoch;
- logs report the means over a call's finite steps of the point metrics
  and ``train/edges_per_sec``, and fire only in log windows;
- the save gate is a window of ``steps_per_call`` dispatched steps;
- a scanned run's checkpoint resumes in per-step mode and the other way
  round;
- the eval cadence does not drift when steps are skipped as non-finite.
"""

import os

import numpy as np
import pytest
import torch

from relgat_projector_tpu_torch import cli
from relgat_projector_tpu_torch.data.dataset import Batch
from relgat_projector_tpu_torch.train.step import (
    make_scan_train_step,
    make_train_step,
)
from relgat_projector_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_trainer import (  # noqa: F401 (a fixture)
    MODEL_WITH_DROPOUT,
    _assert_states_equal,
    _cli_argv,
    _trainer,
    one_thread,
)

SELF_TOL = dict(rtol=1e-6, atol=1e-6)
S = 4


def _assert_params_close(a, b):
    assert int(a.step) == int(b.step)
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state.mu),
                    tree_leaves(b.params) + tree_leaves(b.opt_state.mu)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **SELF_TOL)


@pytest.mark.parametrize("use_pallas", (False, True), ids=("plain", "kernels"))
def test_scanned_epoch_matches_per_step_epoch(tmp_path, use_pallas,
                                              one_thread):
    model = dict(MODEL_WITH_DROPOUT, use_pallas=use_pallas)
    per_step = _trainer(tmp_path / "a", model=model, epochs=1)
    scanned = _trainer(tmp_path / "b", model=model, epochs=1,
                       steps_per_call=S)
    assert per_step._scan_step is None and scanned._scan_step is not None
    for epoch in (1, 2):  # the second epoch after a padded tail
        per_step._single_epoch(epoch, 2)
        scanned._single_epoch(epoch, 2)
    steps = per_step.dataset.steps_per_epoch(128)
    assert steps % S != 0  # the tail is padded
    assert int(scanned.state.step) == int(per_step.state.step) == 2 * steps
    assert scanned.dispatch_step == 2 * -(-steps // S) * S
    _assert_params_close(scanned.state, per_step.state)
    for name in ("host", "device"):
        assert torch.equal(getattr(scanned.state.rng, name).get_state(),
                           getattr(per_step.state.rng, name).get_state())


def test_scan_step_equals_single_steps_on_injected_negatives(tmp_path):
    tr = _trainer(tmp_path, model=dict(use_pallas=True), steps_per_call=S)
    args = (tr.model_cfg, tr.train_cfg, tr.optimizer, tr.lr_schedule)
    single, scan = make_train_step(*args), make_scan_train_step(*args, S)
    group = list(tr.dataset.train_batches(128))[:S]
    src, rel, dst, weight = tr._device_batch(group)
    neg = torch.randint(0, tr.graph.num_real_nodes, (S, 128, 4),
                        generator=torch.Generator().manual_seed(0))
    state, metrics = scan(tr.state, tr.node_emb, tr.graph, src, rel, dst,
                          weight, neg_dst_s=neg)
    ref = tr.state
    losses = []
    for i in range(S):
        ref, m = single(ref, tr.node_emb, tr.graph, src[i], rel[i], dst[i],
                        weight[i], neg_dst=neg[i])
        losses.append(float(m["loss"]))
    assert all(v.shape == (S,) for v in metrics.values())
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, **SELF_TOL)
    _assert_params_close(state, ref)
    with pytest.raises(ValueError, match="4 steps a call"):
        scan(tr.state, tr.node_emb, tr.graph, src[:2], rel[:2], dst[:2],
             weight[:2])


def test_zero_weight_batch_is_a_full_no_op(tmp_path):
    tr = _trainer(tmp_path, steps_per_call=S)
    batch = next(iter(tr.dataset.train_batches(128)))
    tr.state, _ = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                 *tr._device_batch(batch))
    pad = Batch(src=batch.src, rel=batch.rel, dst=batch.dst,
                weight=np.zeros_like(batch.weight))
    before = tr.state.rng.get_state()
    state, metrics = tr._scan_step(tr.state, tr.node_emb, tr.graph,
                                   *tr._device_batch([pad] * S), pad=S)
    _assert_states_equal(state, tr.state)
    for name in ("host", "device"):
        assert torch.equal(getattr(state.rng, name).get_state(), before[name])
    assert not bool(metrics["finite"].any())
    assert int(state.nonfinite_steps) == 0


def test_scanned_logs_are_window_means_of_finite_steps(tmp_path):
    tr = _trainer(tmp_path, epochs=1, steps_per_call=S, log_every_n_steps=S)
    real = tr._scan_step

    def wrapped(*args, **kw):
        state, m = real(*args, **kw)
        m = dict(m)
        # The last step marked non-finite: the means cover the first three.
        m["finite"] = torch.tensor([True, True, True, False])
        m["mrr"] = torch.tensor([0.2, 0.4, 0.6, 99.0])
        m["grad_norm"] = torch.tensor([1.0, 2.0, 3.0, 99.0])
        m["lr"] = torch.tensor([1.0, 2.0, 3.0, 4.0])
        return state, m

    tr._scan_step = wrapped
    logged = []
    tr.log_adapter.log_metrics = lambda metrics, step: logged.append(metrics)
    tr._single_epoch(1, 1)
    rows = [m for m in logged if "train/mrr" in m]
    steps = tr.dataset.steps_per_epoch(128)
    assert len(rows) == -(-steps // S)  # one a call at log_every == S
    np.testing.assert_allclose(rows[0]["train/mrr"], 0.4, rtol=1e-6)
    np.testing.assert_allclose(rows[0]["train/grad_norm"], 2.0, rtol=1e-6)
    assert rows[0]["train/lr"] == 4.0
    assert rows[0]["train/nonfinite_loss_steps"] == 1
    for key in ("train/loss_step", "train/edges_per_sec", "train/hits@1",
                "train/cosine_pos", "train/mse", "train/step_time"):
        assert key in rows[0], key
    assert rows[0]["train/edges_per_sec"] > 0


def test_scanned_logs_fire_only_at_windows(tmp_path):
    tr = _trainer(tmp_path, epochs=1, steps_per_call=S, log_every_n_steps=10)
    at = []
    tr.log_adapter.log_metrics = (
        lambda metrics, step: at.append(tr.dispatch_step)
        if "train/loss_step" in metrics else None)
    tr._single_epoch(1, 1)
    assert at == [d for d in range(S, tr.dispatch_step + 1, S) if d % 10 < S]


def test_scanned_save_gate_is_a_window(tmp_path):
    tr = _trainer(tmp_path / "scan", epochs=1, steps_per_call=8,
                  save_every_n_steps=100)
    tr.dispatch_step = 104  # 104 % 100 < 8
    assert not tr._on_eval_end(mrr=0.9, cosine=None)
    assert [d for d in os.listdir(tmp_path / "scan")
            if d.startswith("best_checkpoint")]
    tr1 = _trainer(tmp_path / "step", epochs=1, save_every_n_steps=100)
    tr1.dispatch_step = 104  # per-step mode: not a save step
    assert not tr1._on_eval_end(mrr=0.9, cosine=None)
    assert not [d for d in os.listdir(tmp_path / "step")
                if d.startswith("best_checkpoint")]
    tr1.dispatch_step = 200
    assert not tr1._on_eval_end(mrr=0.95, cosine=None)
    assert [d for d in os.listdir(tmp_path / "step")
            if d.startswith("best_checkpoint")]


@pytest.mark.parametrize("first,then", [(8, 1), (1, 8)],
                         ids=("scanned-then-per-step",
                              "per-step-then-scanned"))
def test_resume_across_dispatch_modes(tmp_path, first, then):
    tr = _trainer(tmp_path, epochs=1, steps_per_call=first)
    tr.train()
    done = int(tr.state.step)
    tr2 = _trainer(tmp_path, epochs=1, steps_per_call=then)
    assert tr2.maybe_resume()
    _assert_states_equal(tr.state, tr2.state)
    assert tr2.dispatch_step == tr.dispatch_step
    tr2._single_epoch(2, 2)
    assert int(tr2.state.step) == 2 * done


def test_scanned_cadence_under_nonfinite_skips(tmp_path):
    tr = _trainer(tmp_path, epochs=2, steps_per_call=S, log_every_n_steps=S,
                  eval_every_n_steps=8)
    batches = list(tr.dataset.train_batches(128))
    n = len(batches)

    def poisoned(bs):
        for i, b in enumerate(batches):
            if i % 4 == 1:  # active (sum > 0) and non-finite
                w = b.weight.copy()
                w[0] = np.inf
                b = Batch(src=b.src, rel=b.rel, dst=b.dst, weight=w)
            yield b

    tr.dataset.train_batches = poisoned
    evals = []
    real_eval = tr.evaluate
    tr.evaluate = lambda ks=None: evals.append(tr.dispatch_step) or \
        real_eval(ks)
    tr.train(epochs=2)
    total = 2 * -(-n // S) * S
    assert tr.dispatch_step == total
    assert evals == [8 * (i + 1) for i in range(total // 8)]
    skipped = 2 * sum(1 for i in range(n) if i % 4 == 1)
    assert int(tr.state.step) == 2 * n - skipped
    assert int(tr.state.nonfinite_steps) == skipped


def test_cli_trains_and_resumes_at_several_steps_a_call(tmp_path, capsys):
    argv = _cli_argv(tmp_path) + ["--steps-per-call", str(S)]
    cli.main(argv)
    steps = -(-int(0.9 * 1000) // 64)
    padded = -(-steps // S) * S
    final = tmp_path / "relgat_scorer-distmult_lrscheduler-linear"
    capsys.readouterr()
    cli.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert f"Resumed from {final} at step {steps}" in out
    state = torch.load(final / "train-state.pt", weights_only=True)
    assert int(state["step"]) + int(state["nonfinite_steps"]) == 2 * steps
    assert '"dispatch_step": %d' % (2 * padded) in (
        final / "loop-state.json").read_text().replace("\n", "").replace(
            "  ", " ")
