"""The port's trainer, checkpoints and CLI, held to the JAX package's.

Where the random streams allow, against the JAX trainer itself:

- the CLI builds the same ``RunConfig`` from the same argv (the production
  script's flags, an empty ``--warmup-steps``, a preset under an explicit
  override, and the ``--config`` layer fed a JAX trainer's own
  ``training-config.json``); values this package cannot run raise;
- the JSON sidecars of a checkpoint are equal key for key;
- on shared weights (``params_from_jax``), ``evaluate()``'s cosine, MSE and
  positive-score mean agree to 1e-4 (none of them reads the negatives),
  with and without the kernels' path.

The rest mirrors ``tests/test_train.py`` on the port alone (skip on a
non-finite loss, learning on the structured KG, checkpoint round trip,
resume of the loop state, pruning, early-stop directions, the eval
namespace, hoisted eval) and adds what only the port's stateful generators
make necessary: one step after resume is bit-identical to the step from
the live state, an ``evaluate()`` between two steps changes neither the
next negatives nor the parameters, and a CLI run resumed with ``--resume``
ends at twice the steps.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from relgat_projector_tpu import cli as jax_cli
from relgat_projector_tpu.config import MeshConfig as JaxMeshConfig
from relgat_projector_tpu.config import ModelConfig as JaxModelConfig
from relgat_projector_tpu.config import RunConfig as JaxRunConfig
from relgat_projector_tpu.config import TrainConfig as JaxTrainConfig
from relgat_projector_tpu.train.trainer import RelGATTrainer as JaxTrainer
from relgat_projector_tpu_torch import cli
from relgat_projector_tpu_torch.config import (
    ModelConfig,
    RunConfig,
    TrainConfig,
)
from relgat_projector_tpu_torch.data.synthetic import generate_synthetic_kg
from relgat_projector_tpu_torch.interop import params_from_jax
from relgat_projector_tpu_torch.models.model import (
    load_from_pretrained,
    save_pretrained,
)
from relgat_projector_tpu_torch.train.checkpoint import RelGATStorage
from relgat_projector_tpu_torch.train.step import batch_forward
from relgat_projector_tpu_torch.train.trainer import RelGATTrainer
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
KG = dict(num_nodes=300, num_edges=3000, num_rel=4, emb_dim=32, seed=0)
MODEL = dict(in_dim=32, num_rel=4, gat_out_dim=16, gat_heads=2,
             gat_num_layers=1, dropout=0.0, project_to_input_size=True,
             projection_layers=1, projection_dropout=0.0)
TRAIN = dict(epochs=2, train_batch_size=128, num_neg=4, lr=5e-3,
             lr_scheduler="constant", warmup_steps=0, log_every_n_steps=50,
             eval_ks_ranks=(1, 2, 4), seed=7)
PRODUCTION_FLAGS = [
    "--architecture-name", "small", "--epochs", "60", "--batch-size", "128",
    "--num-neg", "32", "--gat-out-dim", "128", "--gat-num-layers", "2",
    "--heads", "16", "--scorer", "distmult", "--project-to-input-size",
    "--projection-layers", "2", "--projection-dropout", "0.3",
    "--dropout", "0.3", "--lr", "2e-5", "--lr-scheduler", "linear",
    "--weight-decay", "1e-4", "--use-self-adv-neg", "--self-adv-alpha", "1.0",
    "--relgat-weight", "1.0", "--pos-cosine-weight", "1.0",
    "--neg-cosine-weight", "1.0", "--mse-weight", "0.0",
    "--early-stop-patience", "10", "--eval-every-n-steps", "500",
    "--save-every-n-steps", "500", "--save-dir", "relgat-out",
    "--use-pallas",
]


def _kg(**kw):
    return generate_synthetic_kg(**{**KG, **kw})


def _run(tmp_path, model=None, **train):
    return (dict(MODEL, **(model or {})),
            dict(TRAIN, out_dir=str(tmp_path), **train))


def _trainer(tmp_path, model=None, kg=None, **train):
    m, t = _run(tmp_path, model, **train)
    run = RunConfig(model=ModelConfig(**m), train=TrainConfig(**t))
    return RelGATTrainer(run, *(kg or _kg()), log_to_console=False,
                         device="cpu")


def _jax_trainer(tmp_path, model=None, kg=None, **train):
    m, t = _run(tmp_path, model, **train)
    run = JaxRunConfig(model=JaxModelConfig(**m), train=JaxTrainConfig(**t))
    return JaxTrainer(run, *(kg or _kg()), log_to_console=False)


def _state_leaves(state):
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu)
            + [state.opt_state.count, state.step, state.nonfinite_steps])


def _assert_states_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# CLI against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--synthetic"] + PRODUCTION_FLAGS,
    ["--synthetic", "--warmup-steps", "", "--eval-every-n-steps", " "],
    ["--synthetic", "--architecture-name", "medium", "--heads", "4",
     "--warmup-steps", "30", "--save-every-n-steps", "0", "--optimizer",
     "adamw", "--grad-clip-norm", "1.5", "--lr-decay", "0.99"],
], ids=["production", "empty_warmup", "preset_override"])
def test_cli_builds_the_jax_run_config(argv):
    want = jax_cli.build_run_config(jax_cli.get_args(argv)).to_dict()
    got = cli.build_run_config(cli.get_args(argv + ["--device", "cpu"]))
    assert got.to_dict() == want


def test_cli_config_layer_reads_a_jax_training_config(tmp_path):
    jtr = _jax_trainer(tmp_path, model=dict(gat_num_layers=2),
                       early_stop_patience=3, eval_every_n_steps=10)
    ckpt = jtr._save_checkpoint("from_jax")
    path = os.path.join(ckpt, "training-config.json")
    for extra in ([], ["--lr", "1e-2", "--heads", "6"]):
        argv = ["--config", path, "--synthetic"] + extra
        want = jax_cli.build_run_config(jax_cli.get_args(argv)).to_dict()
        got = cli.build_run_config(cli.get_args(argv)).to_dict()
        assert got == want
    assert got["model"]["gat_num_layers"] == 2 and got["train"]["lr"] == 1e-2


@pytest.mark.parametrize("model,mesh,field", [
    (dict(param_dtype="float16"), {}, "param_dtype"),
    (dict(mesh_propagate="replicated"), dict(graph_axis=4), "graph_axis=4"),
    (dict(compute_dtype="float16"), {}, "compute_dtype"),
])
def test_cli_config_layer_refuses_what_is_not_ported(tmp_path, model, mesh,
                                                     field):
    run = JaxRunConfig(model=JaxModelConfig(in_dim=8, num_rel=2, **model),
                       mesh=JaxMeshConfig(**mesh))
    path = tmp_path / "training-config.json"
    path.write_text(run.to_json())
    # a dtype is not ported; a mesh and route JAX's trainer refuses is
    # refused with its ValueError
    refusal = NotImplementedError if field.endswith("dtype") else ValueError
    with pytest.raises(refusal, match=field):
        cli.get_args(["--config", str(path), "--synthetic"])


@pytest.mark.parametrize("flags,field", [
    (["--mesh-graph", "2", "--mesh-propagate", "replicated"], "graph_axis=2"),
    (["--mesh-model", "2"], "model_axis=2"),
    (["--mesh-data", "2", "--mesh-model", "2"], "data_axis=2"),
    ({"param_dtype": "float16"}, "param_dtype"),
    ({"compute_dtype": "float16"}, "compute_dtype"),
    (["--distributed", "--mesh-graph", "2", "--mesh-propagate", "gspmd"],
     "gspmd"),
    (["--num-processes", "2", "--mesh-model", "4"], "model_axis=4"),
])
def test_cli_refuses_flags_it_cannot_run(tmp_path, flags, field):
    """A flag, or (a dict) model fields of a ``--config`` file that the CLI
    has no flag for. A dtype is not ported; a mesh the process group cannot
    hold, or a route JAX's trainer refuses, raises a ValueError naming it."""
    if isinstance(flags, dict):
        run = JaxRunConfig(model=JaxModelConfig(in_dim=8, num_rel=2, **flags))
        path = tmp_path / "training-config.json"
        path.write_text(run.to_json())
        flags = ["--config", str(path)]
    refusal = NotImplementedError if field.endswith("dtype") else ValueError
    with pytest.raises(refusal, match=field):
        cli.main(["--synthetic", "--synthetic-nodes", "20",
                  "--synthetic-edges", "50", "--device", "cpu",
                  "--save-dir", str(tmp_path)] + flags)


def _cli_argv(out):
    return ["--synthetic", "--synthetic-nodes", "200", "--synthetic-edges",
            "1000", "--synthetic-rels", "3", "--synthetic-dim", "16",
            "--epochs", "1", "--batch-size", "64", "--gat-out-dim", "8",
            "--heads", "2", "--num-neg", "3", "--project-to-input-size",
            "--use-pallas", "--eval-every-n-steps", "4",
            "--save-every-n-steps", "4", "--log-every-n-steps", "5",
            "--save-dir", str(out), "--device", "cpu"]


def test_cli_trains_and_resumes(tmp_path, capsys):
    final = tmp_path / "relgat_scorer-distmult_lrscheduler-linear"
    cli.main(_cli_argv(tmp_path))
    steps = -(-int(0.9 * 1000) // 64)

    def saved():
        state = torch.load(final / "train-state.pt", weights_only=True)
        loop = json.loads((final / "loop-state.json").read_text())
        return (int(state["step"]) + int(state["nonfinite_steps"]),
                loop["dispatch_step"])

    assert saved() == (steps, steps)
    assert sorted(os.listdir(final)) == sorted([
        "config.json", "training-config.json", "relations-map.json",
        "loop-state.json", "relgat-model.pt", "train-state.pt"])
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("best_checkpoint_")]) <= 5
    capsys.readouterr()
    cli.main(_cli_argv(tmp_path) + ["--resume"])
    assert f"Resumed from {final} at step {steps}" in capsys.readouterr().out
    assert saved() == (2 * steps, 2 * steps)


# ---------------------------------------------------------------------------
# Against the JAX trainer
# ---------------------------------------------------------------------------

def test_sidecars_equal_the_jax_trainers(tmp_path):
    model = dict(gat_num_layers=2, use_pallas=True)
    port = _trainer(tmp_path, model=model, eval_every_n_steps=5)
    ref = _jax_trainer(tmp_path, model=model, eval_every_n_steps=5)
    for tr, sub in ((port, "port"), (ref, "jax")):
        tr.dispatch_step = tr.global_step = 10
        tr.best_metric_value, tr._no_improve_steps = 0.25, 2
        tr._save_checkpoint(sub)
        tr.storage.wait_for_writes()
    for name in ("config.json", "training-config.json", "relations-map.json",
                 "loop-state.json"):
        got = json.loads((tmp_path / "port" / name).read_text())
        want = json.loads((tmp_path / "jax" / name).read_text())
        assert got == want, name
    assert (tmp_path / "port" / "relgat-model.pt").is_file()


@pytest.mark.parametrize("use_pallas", (False, True))
def test_eval_matches_the_jax_trainer_on_shared_weights(tmp_path, use_pallas):
    model = dict(gat_num_layers=2, projection_layers=2)
    ref = _jax_trainer(tmp_path / "jax", model=model)
    port = _trainer(tmp_path / "port", model=dict(model, use_pallas=use_pallas))
    port.state.params = params_from_jax(
        jax.device_get(ref.state.params), device="cpu")
    _, _, _, j_cos, _, j_mse = ref.evaluate()
    _, _, _, p_cos, _, p_mse = port.evaluate()
    np.testing.assert_allclose(p_cos, j_cos, **TOL)
    np.testing.assert_allclose(p_mse, j_mse, **TOL)
    np.testing.assert_allclose(
        port._last_eval_extra["eval/pos_score_mean"],
        ref._last_eval_extra["eval/pos_score_mean"], **TOL)


# ---------------------------------------------------------------------------
# Mirrored from tests/test_train.py
# ---------------------------------------------------------------------------

def test_nonfinite_loss_skips_update(tmp_path):
    tr = _trainer(tmp_path)
    before = [t.clone() for t in tree_leaves(tr.state.params)]
    bad_emb = tr.node_emb.clone()
    bad_emb[0, 0] = float("nan")
    batch = next(iter(tr.dataset.train_batches(128)))
    new_state, metrics = tr._train_step(
        tr.state, bad_emb, tr.graph, *tr._device_batch(batch))
    assert not bool(metrics["finite"])
    assert int(new_state.step) == 0 and int(new_state.nonfinite_steps) == 1
    for a, b in zip(tree_leaves(new_state.params), before):
        assert torch.equal(a, b)


def test_end_to_end_training_improves(tmp_path):
    tr = _trainer(tmp_path, epochs=12, lr=1e-2)
    mrr0, _, loss0, cos0, _, _ = tr.evaluate()
    tr.train()
    mrr1, _, loss1, cos1, _, _ = tr.evaluate()
    k = tr.train_cfg.num_neg
    random_mrr = sum(1.0 / r for r in range(1, k + 2)) / (k + 1)
    assert mrr1 > random_mrr + 0.05, (mrr0, mrr1, random_mrr)
    assert mrr1 > mrr0
    assert cos1 < cos0
    assert loss1 < loss0


def test_checkpoint_resume_roundtrip(tmp_path):
    tr = _trainer(tmp_path, epochs=1)
    tr.train()
    assert int(tr.state.step) > 0
    tr2 = _trainer(tmp_path, epochs=1)
    assert int(tr2.state.step) == 0
    assert tr2.maybe_resume()
    _assert_states_equal(tr.state, tr2.state)
    for name in ("host", "device"):
        assert torch.equal(getattr(tr.state.rng, name).get_state(),
                           getattr(tr2.state.rng, name).get_state())
    assert tr2.dispatch_step == tr.dispatch_step


def test_resume_restores_early_stop_state(tmp_path):
    tr = _trainer(tmp_path, epochs=1, save_every_n_steps=1,
                  early_stop_patience=5)
    tr.dispatch_step = tr.global_step = 10
    assert not tr._on_eval_end(mrr=0.6, cosine=None)   # best=0.6, saves
    assert not tr._on_eval_end(mrr=0.5, cosine=None)   # no improvement
    assert tr._no_improve_steps == 1
    final_dir = tr._save_checkpoint(subdir=None)
    tr.storage.wait_for_writes()

    tr2 = _trainer(tmp_path, epochs=1, save_every_n_steps=1,
                   early_stop_patience=5)
    assert tr2.maybe_resume(final_dir)
    assert tr2.best_metric_value == pytest.approx(0.6)
    assert tr2._no_improve_steps == 1
    assert tr2.best_ckpt_dir == tr.best_ckpt_dir
    assert tr2.dispatch_step == 10
    assert not tr2._on_eval_end(mrr=0.55, cosine=None)
    assert tr2._no_improve_steps == 2


def test_checkpoint_pruning_works(tmp_path):
    tr = _trainer(tmp_path, max_checkpoints=2)
    for i in range(4):
        tr.storage.save_checkpoint(
            f"best_checkpoint_{i}", tr.state, tr.model_cfg, files=[],
            async_write=True,
        )
        tr.storage.prune_checkpoints()
    kept = sorted(
        d for d in os.listdir(tmp_path) if d.startswith("best_checkpoint")
    )
    assert kept == ["best_checkpoint_2", "best_checkpoint_3"]
    assert all((tmp_path / d / "train-state.pt").is_file() for d in kept)


def test_early_stop_counts_and_direction(tmp_path):
    tr = _trainer(tmp_path, early_stop_patience=2)
    assert not tr._on_eval_end(mrr=0.5, cosine=0.5)
    assert not tr._on_eval_end(mrr=0.5, cosine=0.6)  # worse
    assert tr._on_eval_end(mrr=0.5, cosine=0.7)      # worse again -> stop
    assert tr.training_should_stop

    tr2 = _trainer(tmp_path, early_stop_patience=2)
    assert not tr2._on_eval_end(mrr=0.5, cosine=None)
    assert not tr2._on_eval_end(mrr=0.6, cosine=None)  # improvement
    assert tr2._no_improve_steps == 0

    tr3 = _trainer(tmp_path, early_stop_patience=None)
    for _ in range(5):
        assert not tr3._on_eval_end(mrr=0.5, cosine=0.9)


def test_eval_metric_namespace_superset_of_reference(tmp_path):
    tr = _trainer(tmp_path, eval_ks_ranks=(1, 2))
    logged = {}
    tr.log_adapter.log_metrics = (
        lambda metrics, step=None: logged.update(metrics))
    tr._run_eval_and_maybe_early_stop(epoch=1)
    reference_namespace = {
        "eval/loss", "eval/mrr", "eval/hits@1", "eval/hits@2",
        "eval/cosine_pos", "eval/cosine_neg", "eval/mse",
        "eval/pos_score_mean", "eval/neg_score_mean",
        "eval/cosine_mean_batch_pos", "eval/cosine_mean_batch_neg",
        "eval/mse_mean_batch",
    }
    assert not reference_namespace - set(logged)


def test_train_log_namespace(tmp_path):
    tr = _trainer(tmp_path, epochs=1, log_every_n_steps=5)
    logged = []
    tr.log_adapter.log_metrics = (
        lambda metrics, step=None: logged.append(metrics))
    tr._single_epoch(1, 1)
    rows = [m for m in logged if "train/loss_step" in m]
    assert len(rows) == tr.dataset.steps_per_epoch(128) // 5
    for key in ("train/grad_norm", "train/lr", "train/edges_per_sec",
                "train/mrr", "train/hits@1", "train/cosine_pos", "train/mse",
                "train/step_in_epoch"):
        assert key in rows[-1], key
    assert rows[-1]["train/edges_per_sec"] > 0
    assert np.isfinite(rows[-1]["train/loss_step"])


@pytest.mark.parametrize("use_pallas", (False, True))
def test_hoisted_eval_matches_per_batch_recompute(tmp_path, use_pallas):
    tr = _trainer(tmp_path, model=dict(gat_num_layers=2, projection_layers=2,
                                       use_pallas=use_pallas),
                  eval_batch_size=48)
    x = tr._eval_repr(tr.state.params, tr.node_emb, tr.graph)
    gen = torch.Generator().manual_seed(3)
    for batch in tr.dataset.eval_batches(48):
        dev = tr._device_batch(batch)
        neg = torch.randint(0, tr.graph.num_real_nodes, (48, 4),
                            generator=gen)
        out = tr._eval_step(tr.state.params, x, tr.graph, *dev, neg_dst=neg)
        loss_ref, fwd_ref = batch_forward(
            tr.state.params, tr.model_cfg, tr.train_cfg, tr.node_emb,
            tr.graph, *dev, rng=None, train=False, neg_dst=neg)
        n = float(dev[3].sum())
        np.testing.assert_allclose(float(out["loss_sum"]),
                                   float(loss_ref) * n, rtol=1e-5, atol=1e-5)
        for key in ("pos_score_mean", "neg_score_mean"):
            np.testing.assert_allclose(float(out[key]), float(fwd_ref[key]),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# What the port's stateful streams make necessary
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """Bit-identity needs deterministic ops: on the CPU, PyTorch's
    multithreaded accumulating index ops add in a varying order (on the
    card the kernels use no atomics)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL_WITH_DROPOUT = dict(gat_num_layers=2, dropout=0.3,
                          rel_attn_dropout=0.2, projection_dropout=0.3,
                          projection_layers=2)


@pytest.mark.parametrize("use_pallas", (False, True))
def test_step_after_resume_is_bit_identical(tmp_path, use_pallas,
                                            one_thread):
    model = dict(MODEL_WITH_DROPOUT, use_pallas=use_pallas)
    live = _trainer(tmp_path, model=model, epochs=1)
    live._single_epoch(1, 1)
    ckpt = live._save_checkpoint("resume_check")
    live.storage.wait_for_writes()
    resumed = _trainer(tmp_path, model=model, epochs=1)
    assert resumed.maybe_resume(ckpt)
    _assert_states_equal(live.state, resumed.state)
    batch = live._device_batch(next(iter(live.dataset.train_batches(128))))
    live.state, _ = live._train_step(live.state, live.node_emb, live.graph,
                                     *batch)
    resumed.state, _ = resumed._train_step(
        resumed.state, resumed.node_emb, resumed.graph, *batch)
    assert int(live.state.step) == int(live.state.opt_state.count) > 0
    _assert_states_equal(live.state, resumed.state)


def test_evaluate_leaves_training_unchanged(tmp_path, one_thread):
    a = _trainer(tmp_path, model=MODEL_WITH_DROPOUT)
    b = _trainer(tmp_path, model=MODEL_WITH_DROPOUT)
    batches = [a._device_batch(x) for x in a.dataset.train_batches(128)][:2]
    for tr in (a, b):
        tr.state, _ = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                     *batches[0])
        tr.global_step = 1
    a.evaluate()
    for name in ("host", "device"):
        assert torch.equal(getattr(a.state.rng, name).get_state(),
                           getattr(b.state.rng, name).get_state())
    for tr in (a, b):
        tr.state, _ = tr._train_step(tr.state, tr.node_emb, tr.graph,
                                     *batches[1])
    _assert_states_equal(a.state, b.state)


def test_latest_resumable_skips_an_unfinished_write(tmp_path):
    tr = _trainer(tmp_path)
    done = tr._save_checkpoint("best_checkpoint_1")
    tr.storage.wait_for_writes()
    killed = tmp_path / "best_checkpoint_2"
    killed.mkdir()
    (killed / "train-state.pt.tmp").write_bytes(b"half a file")
    later = os.stat(done).st_mtime + 10
    os.utime(killed, (later, later))
    assert RelGATStorage(str(tmp_path)).latest_resumable() == done


def test_resume_from_a_jax_checkpoint_is_refused(tmp_path):
    """A JAX train state that is not whole (here an empty file) is refused,
    naming the byte where it breaks off; a whole one resumes
    (``tests/test_torch_jax_resume.py``)."""
    tr = _trainer(tmp_path)
    jax_dir = tmp_path / "relgat_scorer-distmult_lrscheduler-constant"
    jax_dir.mkdir()
    (jax_dir / "train-state.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="at byte 0"):
        tr.maybe_resume(str(jax_dir))
    with pytest.raises(ValueError, match="msgpack"):
        tr.maybe_resume()


def test_generator_state_keeps_its_device_type():
    state = RngStreams.from_seed(5, "cpu").get_state()
    restored = RngStreams.from_state(state, "cpu")
    assert torch.equal(restored.device.get_state(), state["device"])
    state["device_type"] = "cuda"
    with pytest.raises(ValueError, match="cuda generator state"):
        RngStreams.from_state(state, "cpu")


def test_save_and_load_pretrained_roundtrip(tmp_path):
    tr = _trainer(tmp_path, model=dict(gat_num_layers=2))
    save_pretrained(str(tmp_path / "m"), tr.state.params, tr.model_cfg,
                    add_files=[("extra.json", {"a": 1})])
    params, cfg = load_from_pretrained(str(tmp_path / "m"),
                                       node_emb=tr.dataset.node_emb,
                                       device="cpu")
    assert cfg == tr.model_cfg
    for a, b in zip(tree_leaves(params), tree_leaves(tr.state.params)):
        assert torch.equal(a, b)
    assert json.loads((tmp_path / "m" / "extra.json").read_text()) == {"a": 1}
    with pytest.raises(ValueError, match="Input dim mismatch"):
        load_from_pretrained(str(tmp_path / "m"), node_emb=np.zeros((3, 5)),
                             device="cpu")
