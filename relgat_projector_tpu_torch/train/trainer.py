"""RelGATTrainer — the training runtime, on one device.

Port of ``relgat_projector_tpu/train/trainer.py`` with the same wiring
order (seed -> dataset -> schedule -> optimizer -> storage -> logger ->
model and state), the same loop (periodic step logs, step or epoch eval,
early stopping, best-checkpoint saves, a final save), the same log keys,
checkpoint directory names and resume. The fixes over the reference carry
over: metric direction by metric (cosine lower is better, the MRR fallback
higher), ``early_stop_patience=None`` disables early stopping, pruning
works, and training resumes from a checkpoint with its loop state.

What stays on the card: the step is a function of device tensors, and its
metrics stay on the device until a log boundary, where one copy fetches
all the steps since the last one; the loop counts steps on the host
(``dispatch_step``), and a batch's example count comes from its host mask.
So no step waits for the card outside the log, eval and save cadence.

Evaluation draws its negatives from a generator of its own, seeded from
``(seed, global_step)`` (``utils/seeding.py``), never from the train
streams: an evaluation leaves the next train step unchanged, and resume
stays exact.

``steps_per_call > 1`` runs the JAX package's scanned epoch: the epoch's
batches go in groups of that many (the tail padded with zero-weight copies
of the last batch, which change nothing), each group up in one copy and
through ``make_scan_train_step``; logs and evals fire in windows of the
dispatch counter, a log reporting the means over the finite steps of the
call that crossed its boundary. Both dispatch modes write the same
checkpoints, so either resumes the other's. The JAX package's
multi-process and mesh branches are not ported: their config values raise
``NotImplementedError`` when the config is built, and so does a process
group of more than one process here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from relgat_projector_tpu_torch.config import Defaults, RunConfig
from relgat_projector_tpu_torch.data.dataset import Batch, RelGATData
from relgat_projector_tpu_torch.device import DeviceLike, resolve_device
from relgat_projector_tpu_torch.models.model import init_model
from relgat_projector_tpu_torch.schedules import (
    compute_total_and_warmup_steps,
    make_lr_schedule,
)
from relgat_projector_tpu_torch.train.checkpoint import RelGATStorage
from relgat_projector_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_optimizer,
)
from relgat_projector_tpu_torch.train.step import (
    make_eval_step,
    make_scan_train_step,
    make_train_step,
)
from relgat_projector_tpu_torch.utils.logging_adapter import LoggerAdapter
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.seeding import RandomSeed


def _to_host(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar device tensors as Python floats, in one device-to-host copy."""
    keys = list(values)
    host = torch.stack([values[k].to(torch.float64) for k in keys]).tolist()
    return dict(zip(keys, host))


class RelGATTrainer:
    def __init__(
        self,
        run_config: RunConfig,
        node2emb: Dict[int, np.ndarray],
        rel2idx: Dict[str, int],
        edge_index_raw: List[Tuple[int, int, str]],
        *,
        log_to_wandb: bool = False,
        log_to_console: bool = True,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        if (
            torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1
        ):
            raise NotImplementedError(
                "multi-process training is not ported yet"
            )
        tc = run_config.train

        # Seed first so the split is reproducible (reference ``trainer:97-99``).
        self.seeder = RandomSeed(tc.seed)
        self.dataset = RelGATData(
            node2emb,
            rel2idx,
            edge_index_raw,
            train_ratio=tc.train_ratio,
            seed=tc.seed,
            csr=run_config.model.use_pallas,
            device=self.device,
        )

        # Derive data-dependent model dims.
        self.model_cfg = dataclasses.replace(
            run_config.model,
            in_dim=self.dataset.emb_dim,
            num_rel=self.dataset.num_rel,
        )
        self.run_config = dataclasses.replace(run_config, model=self.model_cfg)
        self.train_cfg = tc

        self.total_steps, self.warmup_steps = compute_total_and_warmup_steps(
            self.dataset.num_train,
            tc.train_batch_size,
            tc.epochs,
            tc.warmup_steps,
        )
        self.lr_schedule = make_lr_schedule(
            tc.lr, tc.lr_scheduler, self.total_steps, self.warmup_steps,
            tc.lr_decay,
        )
        self.optimizer = make_optimizer(tc, self.lr_schedule)

        self.storage = RelGATStorage(
            out_dir=tc.out_dir,
            max_checkpoints=tc.max_checkpoints,
            save_every_n_steps=tc.save_every_n_steps,
        )
        self.log_adapter = LoggerAdapter(
            run_name=run_config.run_name,
            architecture_name=run_config.architecture_name,
            base_model_name=run_config.base_model_name,
            log_every_n_steps=tc.log_every_n_steps,
            log_to_wandb=log_to_wandb,
            log_to_console=log_to_console,
            run_config=self.run_config.to_dict(),
        )

        # Model + state, from the seeds that stand for the JAX root-key split.
        params = init_model(
            self.model_cfg, seed=self.seeder.init_seed, device=self.device
        )
        self.state: TrainState = create_train_state(
            params, self.optimizer, seed=self.seeder.train_seed
        )
        self.node_emb = torch.from_numpy(self.dataset.node_emb).to(self.device)
        self.graph = self.dataset.graph

        self.steps_per_call = max(1, int(tc.steps_per_call))
        self._train_step = make_train_step(
            self.model_cfg, tc, self.optimizer, self.lr_schedule
        )
        self._scan_step = None
        if self.steps_per_call > 1:
            self._scan_step = make_scan_train_step(
                self.model_cfg, tc, self.optimizer, self.lr_schedule,
                self.steps_per_call,
            )
        self._eval_repr, self._eval_step = make_eval_step(self.model_cfg, tc)

        # Loop bookkeeping. Two counters:
        # - dispatch_step: host-side count of dispatched train steps, exact
        #   without device syncs; drives the log/eval/save cadence (so it
        #   does not drift when steps skip on non-finite losses),
        # - global_step: the device's finite-step counter (reference
        #   semantics: skipped steps don't count, ``trainer:457,476``),
        #   reconciled from the device at log boundaries and used for
        #   reporting and checkpoint names.
        self.dispatch_step = 0
        self.global_step = 0
        self.training_should_stop = False
        self.eval_every_n_steps = (
            int(tc.eval_every_n_steps)
            if tc.eval_every_n_steps is not None and int(tc.eval_every_n_steps) > 0
            else None
        )
        self.early_stop_patience = (
            int(tc.early_stop_patience)
            if tc.early_stop_patience is not None
            else None
        )
        self.eval_ks_ranks = tuple(sorted(set(tc.eval_ks_ranks)))
        # Fixed metric directions (SURVEY §3 quirk 2): cosine_pos lower is
        # better; MRR fallback higher is better.
        self.best_metric_value: Optional[float] = None
        self._no_improve_steps = 0
        self.best_ckpt_dir: Optional[str] = None
        self._last_flush_time: Optional[float] = None
        self._last_eval_extra: Dict[str, Any] = {}

        self.log_adapter.init_wandb_if_needed()

    def _device_batch(self, batch: Batch):
        """``(src, rel, dst, weight)`` on the device: the int32 host ids as
        int64, in one copy from pinned memory that does not wait for the
        stream. Given a list of batches, each comes stacked ``[S, B]``."""
        group = batch if isinstance(batch, list) else None
        if group is None:
            ids = np.stack([batch.src, batch.rel, batch.dst])
            weight = np.asarray(batch.weight, np.float32)
        else:
            ids = np.stack([np.stack([b.src, b.rel, b.dst], axis=0)
                            for b in group], axis=1)
            weight = np.stack([b.weight for b in group]).astype(np.float32)
        ids = torch.from_numpy(ids.astype(np.int64))
        weight = torch.from_numpy(weight)
        if self.device.type == "cuda":
            ids, weight = ids.pin_memory(), weight.pin_memory()
        ids = ids.to(self.device, non_blocking=True)
        weight = weight.to(self.device, non_blocking=True)
        return ids[0], ids[1], ids[2], weight

    # ------------------------------------------------------------------
    # Resume
    # ------------------------------------------------------------------
    def maybe_resume(self, ckpt_dir: Optional[str] = None) -> bool:
        """Restore the full train state and the loop state from ``ckpt_dir``
        (or the newest resumable checkpoint under ``out_dir``). Returns True
        if resumed."""
        target = ckpt_dir or self.storage.latest_resumable()
        if target is None:
            return False
        self.state = self.storage.load_checkpoint(target, self.state)
        self.global_step = int(self.state.step)
        self.dispatch_step = self.global_step
        # Restore the LOOP state too (best metric, early-stop counter,
        # best-checkpoint pointer, exact dispatch counter): without it a
        # resumed run forgets its early-stop history and re-saves a "best"
        # checkpoint on its first eval regardless of quality.
        loop = self.storage.load_loop_state(target)
        if loop is not None:
            if loop.get("best_metric_value") is not None:
                self.best_metric_value = float(loop["best_metric_value"])
            self._no_improve_steps = int(loop.get("no_improve_steps", 0))
            self.best_ckpt_dir = loop.get("best_ckpt_dir")
            if loop.get("dispatch_step") is not None:
                self.dispatch_step = int(loop["dispatch_step"])
        print(f"Resumed from {target} at step {self.global_step}")
        return True

    # ------------------------------------------------------------------
    # Evaluation (reference ``trainer:275-376``)
    # ------------------------------------------------------------------
    def evaluate(self, ks: Optional[Tuple[int, ...]] = None):
        ks = tuple(ks) if ks else self.eval_ks_ranks
        sums: Dict[str, float] = {}
        n_total = 0.0
        nonfinite_total = 0
        eval_rng = RngStreams.from_seed(
            self.seeder.eval_seed(self.global_step), self.device
        )
        # Params are frozen for the whole evaluation, so the full-graph GAT
        # stack is computed ONCE and every batch scores against it (the
        # reference recomputes the stack per eval batch,
        # ``trainer/relgat_projector.py:286-300``).
        x_repr = self._eval_repr(self.state.params, self.node_emb, self.graph)
        for batch in self.dataset.eval_batches(self.train_cfg.eval_batch_size):
            out = _to_host(self._eval_step(
                self.state.params, x_repr, self.graph,
                *self._device_batch(batch), rng=eval_rng,
            ))
            n_b = out["n_examples"]
            n_total += n_b
            for k, v in out.items():
                if k.endswith("_sum"):
                    sums[k] = sums.get(k, 0.0) + v

            # Per-batch eval metric logging, reference ``trainer:323-351``.
            batch_metrics = {
                "eval/pos_score_mean": out["pos_score_mean"],
                "eval/neg_score_mean": out["neg_score_mean"],
            }
            denom_b = max(1.0, n_b)
            if "cosine_pos_sum" in out:
                batch_metrics["eval/cosine_mean_batch_pos"] = (
                    out["cosine_pos_sum"] / denom_b
                )
            if "cosine_neg_sum" in out:
                batch_metrics["eval/cosine_mean_batch_neg"] = (
                    out["cosine_neg_sum"] / denom_b
                )
            if "mse_sum" in out:
                batch_metrics["eval/mse_mean_batch"] = out["mse_sum"] / denom_b
            nf = int(out["nonfinite_scores"])
            if nf:
                # Reference logs the counter only when nonzero
                # (``trainer:578-585``).
                batch_metrics["eval/nonfinite_scores"] = nf
                nonfinite_total += nf
            self.log_adapter.log_metrics(
                metrics=batch_metrics, step=self.global_step
            )

        n = max(1.0, n_total)
        avg_mrr = sums.get("mrr_sum", 0.0) / n
        avg_hits = {k: sums.get(f"hits@{k}_sum", 0.0) / n for k in ks}
        avg_loss = sums.get("loss_sum", 0.0) / n
        avg_cos_pos = (
            sums["cosine_pos_sum"] / n if "cosine_pos_sum" in sums else None
        )
        avg_cos_neg = (
            sums["cosine_neg_sum"] / n if "cosine_neg_sum" in sums else None
        )
        avg_mse = sums["mse_sum"] / n if "mse_sum" in sums else None
        # Aggregates beyond the reference's return tuple, consumed by
        # _run_eval_and_maybe_early_stop for the eval/* namespace.
        self._last_eval_extra = {
            "eval/pos_score_mean": sums.get("pos_score_mean_sum", 0.0) / n,
            "eval/neg_score_mean": sums.get("neg_score_mean_sum", 0.0) / n,
        }
        if nonfinite_total:
            self._last_eval_extra["eval/nonfinite_scores"] = nonfinite_total
        return avg_mrr, avg_hits, avg_loss, avg_cos_pos, avg_cos_neg, avg_mse

    # ------------------------------------------------------------------
    # Training loop (reference ``trainer:378-496``)
    # ------------------------------------------------------------------
    def train(self, epochs: Optional[int] = None):
        epochs = int(epochs) if epochs is not None else self.train_cfg.epochs
        self._log_begin_information()

        for epoch in range(1, epochs + 1):
            self._single_epoch(epoch, epochs)
            if self.training_should_stop:
                break
            if self.eval_every_n_steps is None:
                if self._run_eval_and_maybe_early_stop(epoch=epoch):
                    break

        out_model_dir = self._save_checkpoint(subdir=None)
        self.storage.wait_for_writes()
        print(f"\nTraining finished - model saved to: {out_model_dir}")
        self.log_adapter.finish_wandb_if_needed()
        return out_model_dir

    def _single_epoch(self, epoch: int, epochs: int):
        if self._scan_step is not None:
            return self._single_epoch_scanned(epoch, epochs)
        bs = self.train_cfg.train_batch_size
        # Deferred metrics: device scalars fetched only at log time.
        pending: List[Tuple[int, Any, float, float]] = []
        running_loss = 0.0
        running_examples = 0

        for step_in_epoch, batch in enumerate(
            self.dataset.train_batches(bs), start=1
        ):
            step_start = time.time()
            self.state, metrics = self._train_step(
                self.state,
                self.node_emb,
                self.graph,
                *self._device_batch(batch),
            )
            self.dispatch_step += 1
            self.global_step += 1
            n_valid = float(batch.weight.sum())
            pending.append((step_in_epoch, metrics, n_valid, step_start))

            if self.dispatch_step % self.log_adapter.log_every_n_steps == 0:
                running_loss, running_examples = self._flush_logs(
                    epoch, pending, running_loss, running_examples
                )
                pending = []

            if (
                self.eval_every_n_steps is not None
                and self.dispatch_step % self.eval_every_n_steps == 0
            ):
                if self._run_eval_and_maybe_early_stop(epoch=epoch):
                    self.training_should_stop = True
                    return

        # Unflushed tail steps simply roll off unlogged (same as the
        # reference, which only logs at the cadence boundary).

    def _single_epoch_scanned(self, epoch: int, epochs: int):
        """The epoch in calls of ``steps_per_call`` steps (JAX
        ``_single_epoch_scanned``); metrics arrive stacked ``[S]`` and are
        fetched only at a log window."""
        bs = self.train_cfg.train_batch_size
        s = self.steps_per_call
        batches = list(self.dataset.train_batches(bs))
        real = len(batches)
        # Pad the tail with zero-weight batches, full no-ops of the step, so
        # a scanned epoch ends where a per-step epoch does.
        while len(batches) % s != 0:
            last = batches[-1]
            batches.append(Batch(src=last.src, rel=last.rel, dst=last.dst,
                                 weight=np.zeros_like(last.weight)))

        last_log_time = time.time()
        last_log_step = self.dispatch_step
        for lo in range(0, len(batches), s):
            self.state, metrics = self._scan_step(
                self.state, self.node_emb, self.graph,
                *self._device_batch(batches[lo:lo + s]),
                pad=max(0, lo + s - real),
            )
            self.dispatch_step += s

            if self.dispatch_step % self.log_adapter.log_every_n_steps < s:
                keys = list(metrics)
                m = dict(zip(keys, torch.stack(
                    [metrics[k].to(torch.float64) for k in keys]
                ).cpu().numpy()))
                now = time.time()
                window = now - last_log_time
                steps_in_window = max(1, self.dispatch_step - last_log_step)
                last_log_time = now
                last_log_step = self.dispatch_step
                finite = m["finite"] > 0

                def wmean(key):
                    # The mean over the call's finite steps: a skipped or
                    # zero-weight step carries no meaningful point values.
                    return float(m[key][finite].mean()) if finite.any() else 0.0

                log = {
                    "epoch": epoch,
                    "train/loss_step": wmean("loss"),
                    "train/grad_norm": wmean("grad_norm"),
                    "train/lr": float(m["lr"][-1]),
                    "train/step_time": window / steps_in_window,
                    "train/edges_per_sec": (
                        self.graph.num_real_edges
                        * self.model_cfg.gat_num_layers
                        * steps_in_window / window
                        if window > 0 else 0.0
                    ),
                    "train/mrr": wmean("mrr"),
                    "train/pos_score_mean": wmean("pos_score_mean"),
                    "train/neg_score_mean": wmean("neg_score_mean"),
                }
                if "cosine_pos" in m:
                    log["train/cosine_pos"] = wmean("cosine_pos")
                    log["train/cosine_neg"] = wmean("cosine_neg")
                    log["train/mse"] = wmean("mse")
                for k in self.eval_ks_ranks:
                    if f"hits@{k}" in m:
                        log[f"train/hits@{k}"] = wmean(f"hits@{k}")
                nfs = int(m["nonfinite_scores"].sum())
                if nfs:
                    log["train/nonfinite_scores"] = nfs
                nonfinite = int((~finite).sum())
                if nonfinite:
                    log["train/nonfinite_loss_steps"] = nonfinite
                # Reconcile the finite-step counter (display only; the
                # cadence stays on dispatch_step, so skips cannot drift it).
                self.global_step = int(self.state.step)
                print(
                    f"\nGlobal step {self.global_step} "
                    f"loss_step: {log['train/loss_step']:.8f} "
                    f"lr: {log['train/lr']:.8f}"
                )
                self.log_adapter.log_metrics(metrics=log, step=self.global_step)

            if (
                self.eval_every_n_steps is not None
                and self.dispatch_step % self.eval_every_n_steps < s
            ):
                # Reconcile first so eval logs and checkpoints carry it.
                self.global_step = int(self.state.step)
                if self._run_eval_and_maybe_early_stop(epoch=epoch):
                    self.training_should_stop = True
                    return

    def _flush_logs(
        self,
        epoch: int,
        pending: List[Tuple[int, Any, float, float]],
        running_loss: float,
        running_examples: int,
    ) -> Tuple[float, int]:
        # One copy for the window: every step's finite flag and loss, and
        # the last step's metrics.
        step_in_epoch, last, _, step_start = pending[-1]
        window = torch.stack([
            torch.stack([m["finite"].to(torch.float64),
                         m["loss"].to(torch.float64)])
            for _, m, _, _ in pending
        ]).tolist()
        metrics = _to_host(last)
        step_time = time.time() - step_start
        nonfinite_new = 0
        for (finite, loss), (_, _, n_valid, _) in zip(window, pending):
            if finite:
                running_loss += loss * n_valid
                running_examples += int(n_valid)
            else:
                nonfinite_new += 1

        # Throughput over the flushed window (edge-messages/s; SURVEY §5.1).
        now = time.time()
        since = now - (self._last_flush_time or now)
        self._last_flush_time = now
        edges_per_sec = (
            self.graph.num_real_edges
            * self.model_cfg.gat_num_layers
            * len(pending)
            / since
            if since > 0
            else 0.0
        )

        avg_running_loss = running_loss / max(1, running_examples)
        log = {
            "epoch": epoch,
            "train/loss_step": avg_running_loss,
            "train/step_in_epoch": step_in_epoch,
            "train/grad_norm": metrics["grad_norm"],
            "train/lr": metrics["lr"],
            "train/step_time": step_time,
            "train/edges_per_sec": edges_per_sec,
            "train/mrr": metrics["mrr"],
            "train/pos_score_mean": metrics["pos_score_mean"],
            "train/neg_score_mean": metrics["neg_score_mean"],
        }
        if "cosine_pos" in metrics:
            log["train/cosine_pos"] = metrics["cosine_pos"]
            log["train/cosine_neg"] = metrics["cosine_neg"]
            log["train/mse"] = metrics["mse"]
        for k in self.eval_ks_ranks:
            log[f"train/hits@{k}"] = metrics.get(f"hits@{k}", 0.0)
        if nonfinite_new:
            log["train/nonfinite_loss_steps"] = nonfinite_new
        nfs = int(metrics.get("nonfinite_scores", 0))
        if nfs:
            log["train/nonfinite_scores"] = nfs

        print(
            f"\nGlobal step {self.global_step} "
            f"grad_norm {log['train/grad_norm']:.8f} "
            f"loss_step: {avg_running_loss:.8f} "
            f"lr: {log['train/lr']:.8f} "
            f"step_time {step_time}"
        )
        self.log_adapter.log_metrics(metrics=log, step=self.global_step)
        # Reconcile with the device's finite-step counter.
        self.global_step = int(self.state.step)
        # Fresh window (the reference reset its example counter to 1 —
        # trainer:853 — skewing every window average by one; fixed here).
        return 0.0, 0

    # ------------------------------------------------------------------
    # Eval plumbing + early stop (reference ``trainer:678-769``)
    # ------------------------------------------------------------------
    def _run_eval_and_maybe_early_stop(self, *, epoch: int) -> bool:
        mrr, hits, eval_loss, cos_pos, cos_neg, mse = self.evaluate(
            self.eval_ks_ranks
        )
        metrics = {"epoch": epoch, "eval/loss": eval_loss, "eval/mrr": mrr}
        metrics.update(self._last_eval_extra)
        if cos_pos is not None:
            metrics["eval/cosine_pos"] = cos_pos
        if cos_neg is not None:
            metrics["eval/cosine_neg"] = cos_neg
        if mse is not None:
            metrics["eval/mse"] = mse
        for k, v in hits.items():
            metrics[f"eval/hits@{k}"] = v
        self.log_adapter.log_metrics(metrics=metrics, step=self.global_step)
        return self._on_eval_end(mrr, cos_pos)

    def _on_eval_end(self, mrr: float, cosine: Optional[float]) -> bool:
        if cosine is not None:
            metric_value, upper_is_better = cosine, False
        else:
            metric_value, upper_is_better = mrr, True

        if self.best_metric_value is None:
            improved = True
        elif upper_is_better:
            improved = metric_value > self.best_metric_value
        else:
            improved = metric_value < self.best_metric_value

        if improved:
            self.best_metric_value = metric_value
            # Reset the patience counter BEFORE saving so the loop-state
            # sidecar written with the checkpoint carries the post-eval
            # truth.
            self._no_improve_steps = 0
            # Save gating on the DISPATCH counter (deterministic under
            # non-finite skips); checkpoint names carry the finite
            # global_step (reference naming, ``trainer:728-729``). The gate
            # is a window of steps_per_call, the eval cadence's window, so
            # a scanned epoch, whose dispatch_step moves in strides, still
            # saves every improved eval; at one step a call it is exact
            # divisibility.
            if (
                self.storage.save_every_n_steps is not None
                and self.dispatch_step % self.storage.save_every_n_steps
                < self.steps_per_call
            ):
                self.best_ckpt_dir = f"best_checkpoint_{self.global_step}"
                self._save_checkpoint(subdir=self.best_ckpt_dir)
                self.storage.prune_checkpoints()
                self.log_adapter.log_metrics(
                    metrics={"checkpoint/step": self.global_step},
                    step=self.global_step,
                )
        else:
            self._no_improve_steps += 1

        if (
            self.early_stop_patience is not None
            and self._no_improve_steps >= self.early_stop_patience
        ):
            print(
                "\n  Early-stopping triggered - no improvement for "
                f"{self.early_stop_patience} evaluation steps."
            )
            self.training_should_stop = True
            return True
        return False

    def _log_begin_information(self):
        self.log_adapter.log_metrics(
            metrics={
                "scheduler/total_steps": self.total_steps,
                "scheduler/warmup_steps": self.warmup_steps,
                "scheduler/type": self.train_cfg.lr_scheduler,
                "config/use_self_adv_neg": float(self.train_cfg.use_self_adv_neg),
                "config/self_adv_alpha": float(self.train_cfg.self_adv_alpha),
                "train/base_lr": self.train_cfg.lr,
            },
            step=self.global_step,
        )

    def _save_checkpoint(self, subdir: Optional[str]) -> str:
        prunable = subdir is not None
        if subdir is None:
            subdir = (
                f"relgat_"
                f"scorer-{self.model_cfg.scorer_type}_"
                f"lrscheduler-{self.train_cfg.lr_scheduler}"
            )
        return self.storage.save_checkpoint(
            subdir=subdir,
            state=self.state,
            model_cfg=self.model_cfg,
            # Periodic (best) checkpoints write the train state off-thread;
            # the final save is synchronous.
            async_write=prunable,
            files=[
                (
                    Defaults.TRAINING_CONFIG_FILE_NAME,
                    self.run_config.to_dict(),
                ),
                (
                    Defaults.TRAINING_CONFIG_REL_TO_IDX,
                    self.dataset.rel2idx,
                ),
                (
                    RelGATStorage.LOOP_STATE_FILE,
                    {
                        "best_metric_value": self.best_metric_value,
                        "no_improve_steps": self._no_improve_steps,
                        "best_ckpt_dir": self.best_ckpt_dir,
                        "dispatch_step": self.dispatch_step,
                    },
                ),
            ],
            prunable=prunable,
        )
