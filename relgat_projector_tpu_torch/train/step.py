"""Train and eval steps (port of ``train/step.py``).

One train step: the full-graph forward (every layer over every edge), the
scoring of a triplet batch against negatives, the multi-objective loss, the
backward and the Adam update. A non-finite loss (or a batch with no valid
example) keeps the old parameters and optimizer state and does not advance
``step``: the skip is a select on the device, so the step never waits for
the host. ``neg_dst`` may be injected; otherwise it is sampled on the
device from the state's generator (the JAX stream cannot be reproduced).

On a grid (``grid``, a ``parallel.Grid``) every rank gets the global batch
and draws the global negatives from generators in the same state; it
fetches the rows of its data slice's endpoints from their owners, the
slices are joined, and every rank computes the global loss with the
single-device code (``parallel/sharded.py``). The gradients of
``loss / ranks`` summed over the world are the single-device gradients, so
every rank takes the same Adam step, clipping and the non-finite skip
included.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from relgat_projector_tpu_torch import losses as L
from relgat_projector_tpu_torch import metrics as M
from relgat_projector_tpu_torch.config import ModelConfig, TrainConfig
from relgat_projector_tpu_torch.data.graph import GraphData
from relgat_projector_tpu_torch.models import scorer as sc
from relgat_projector_tpu_torch.models.model import single_gat_step
from relgat_projector_tpu_torch.ops.sampling import sample_negative_dst
from relgat_projector_tpu_torch.parallel.sharded import (
    all_reduce_grads,
    batch_vectors,
)
from relgat_projector_tpu_torch.train.state import (
    Optimizer,
    TrainState,
    global_norm,
)
from relgat_projector_tpu_torch.utils.profiling import span
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map


def score_batch(
    params: Any,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    x: torch.Tensor,        # [N_pad, D_sc] node representations
    num_real_nodes: int,
    src: torch.Tensor,      # [B]
    rel: torch.Tensor,      # [B]
    dst: torch.Tensor,      # [B]
    weight: torch.Tensor,   # [B] 0/1 validity mask
    *,
    rng: Optional[RngStreams] = None,
    neg_dst: Optional[torch.Tensor] = None,  # [B, K] injected negatives
    grid=None,
    halo=None,
    split_data: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one triplet batch given the representations
    (on a ``grid``, this rank's rows of them: all, or its shard's with
    ``halo``; ``split_data`` fetches only its data slice's rows)."""
    if neg_dst is None and rng is None:
        raise ValueError("score_batch needs rng or injected neg_dst")
    with span("relgat/score"):
        if neg_dst is None:
            neg_dst = sample_negative_dst(
                rng.device, dst, num_nodes=num_real_nodes,
                num_neg=train_cfg.num_neg,
            )
        src_vec, dst_vec, neg_dst_vec = batch_vectors(
            x, src, dst, neg_dst, grid, halo, split_data=split_data
        )
        return score_vectors(params, model_cfg, train_cfg, src_vec, rel,
                             dst_vec, neg_dst_vec, weight)


def score_vectors(
    params: Any,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    src_vec: torch.Tensor,      # [B, D_sc]
    rel: torch.Tensor,          # [B]
    dst_vec: torch.Tensor,      # [B, D_sc]
    neg_dst_vec: torch.Tensor,  # [B, K, D_sc]
    weight: torch.Tensor,       # [B]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of a batch given its endpoints' representations."""
    num_neg = neg_dst_vec.shape[1]
    pos_score = sc.score_triplets(
        params["scorer"], model_cfg.scorer_type, src_vec, rel, dst_vec
    )
    neg_score = sc.score_triplets(
        params["scorer"], model_cfg.scorer_type, src_vec[:, None, :],
        rel[:, None], neg_dst_vec,
    )
    nonfinite = (~torch.isfinite(pos_score)).sum(dtype=torch.int32) + (
        ~torch.isfinite(neg_score)
    ).sum(dtype=torch.int32)
    pos_score = L.sanitize_scores(pos_score)
    neg_score = L.sanitize_scores(neg_score)
    metrics: Dict[str, torch.Tensor] = {"nonfinite_scores": nonfinite}

    if model_cfg.project_to_input_size:
        transformed = sc.transform(
            params["scorer"], model_cfg.scorer_type, src_vec, rel
        )
        parts = L.multi_objective_loss(
            pos_score=pos_score,
            neg_score=neg_score,
            transformed_src=transformed,
            dst_vec=dst_vec,
            neg_dst_vec=neg_dst_vec,
            relgat_weight=train_cfg.relgat_weight,
            pos_cosine_weight=train_cfg.pos_cosine_weight,
            neg_cosine_weight=train_cfg.neg_cosine_weight,
            mse_weight=train_cfg.mse_weight,
            use_self_adv_neg=train_cfg.use_self_adv_neg,
            margin=train_cfg.margin,
            self_adv_alpha=train_cfg.self_adv_alpha,
            weights=weight,
        )
        loss = parts.total
        metrics.update(
            cosine_pos=parts.cosine_pos.detach(),
            cosine_neg=parts.cosine_neg.detach(),
            mse=parts.mse.detach(),
        )
    else:
        loss = L.ranking_loss(
            pos_score, neg_score,
            use_self_adv_neg=train_cfg.use_self_adv_neg,
            margin=train_cfg.margin,
            self_adv_alpha=train_cfg.self_adv_alpha,
            weights=weight,
        )
    n_valid = weight.sum().clamp_min(1.0)
    metrics.update(
        pos_score=pos_score.detach(),
        neg_score=neg_score.detach(),
        pos_score_mean=(pos_score * weight).sum().detach() / n_valid,
        neg_score_mean=(neg_score * weight[:, None]).sum().detach()
        / (weight.sum() * num_neg).clamp_min(1.0),
    )
    return loss, metrics


def batch_forward(
    params, model_cfg, train_cfg, node_emb, graph: GraphData, src, rel, dst,
    weight, *, rng: Optional[RngStreams], train: bool,
    neg_dst: Optional[torch.Tensor] = None, grid=None,
):
    """Full-graph forward, scoring and loss for one triplet batch."""
    x = single_gat_step(params, model_cfg, node_emb, graph, train=train, rng=rng)
    return score_batch(
        params, model_cfg, train_cfg, x, graph.num_real_nodes,
        src, rel, dst, weight, rng=rng, neg_dst=neg_dst, grid=grid,
        halo=graph.halo,
    )


def loss_and_grads(
    params, model_cfg, train_cfg, node_emb, graph, src, rel, dst, weight, *,
    rng: Optional[RngStreams], neg_dst: Optional[torch.Tensor] = None,
    grid=None,
):
    """``(loss, metrics, grads)`` of the training forward; grads share the
    parameters' tree layout. On a ``grid`` the loss is the global batch's
    and the gradients are summed over the world."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(req)
    params_req = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        with span("relgat/forward"):
            loss, metrics = batch_forward(
                params_req, model_cfg, train_cfg, node_emb, graph, src, rel,
                dst, weight, rng=rng, train=True, neg_dst=neg_dst, grid=grid,
            )
        scaled = loss if grid is None else loss / grid.size
        with span("relgat/backward"):
            grads = torch.autograd.grad(scaled, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(req, grads)]
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    if grid is not None:
        grads = all_reduce_grads(grads, grid)
    return loss.detach(), metrics, grads


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer: Optimizer,
    lr_schedule: Callable,
    grid=None,
) -> Callable:
    """``train_step(state, node_emb, graph, src, rel, dst, weight,
    neg_dst=None) -> (state, metrics)``; metrics stay on the device. On a
    ``grid`` the batch (and ``neg_dst``) is the global one."""
    ks = tuple(train_cfg.eval_ks_ranks)

    def train_step(
        state: TrainState, node_emb, graph: GraphData, src, rel, dst, weight,
        neg_dst: Optional[torch.Tensor] = None,
    ):
        with span("relgat/step"):
            loss, fwd_metrics, grads = loss_and_grads(
                state.params, model_cfg, train_cfg, node_emb, graph, src, rel,
                dst, weight, rng=state.rng, neg_dst=neg_dst, grid=grid,
            )
            with span("relgat/optimizer"):
                active = weight.sum() > 0
                finite = torch.isfinite(loss) & active
                new_params, new_opt = optimizer.update(
                    grads, state.opt_state, state.params
                )

                def select(new, old):
                    return tree_map(lambda a, b: torch.where(finite, a, b),
                                    new, old)

                opt_state = type(state.opt_state)(
                    mu=select(new_opt.mu, state.opt_state.mu),
                    nu=select(new_opt.nu, state.opt_state.nu),
                    count=torch.where(finite, new_opt.count,
                                      state.opt_state.count),
                )
                next_state = TrainState(
                    params=select(new_params, state.params),
                    opt_state=opt_state,
                    step=state.step + finite.to(torch.int32),
                    rng=state.rng,
                    nonfinite_steps=state.nonfinite_steps
                    + (~torch.isfinite(loss) & active).to(torch.int32),
                )
                grad_norm = global_norm(grads)
                lr = lr_schedule(state.step)
            with span("relgat/score"):
                mrr, hits = M.compute_mrr_hits(
                    fwd_metrics["pos_score"], fwd_metrics["neg_score"], ks,
                    weights=weight,
                )
            metrics = {
                "loss": loss,
                "finite": finite,
                "grad_norm": grad_norm,
                "lr": lr,
                "mrr": mrr,
                **{f"hits@{k}": v for k, v in hits.items()},
                **{
                    k: v for k, v in fwd_metrics.items()
                    if k not in ("pos_score", "neg_score")
                },
            }
            return next_state, metrics

    return train_step


def make_scan_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    optimizer: Optimizer,
    lr_schedule: Callable,
    unroll_steps: int,
    grid=None,
) -> Callable:
    """Counterpart of ``make_scan_train_step``: ``scan_step(state, node_emb,
    graph, src_s, rel_s, dst_s, weight_s, neg_dst_s=None, pad=0) -> (state,
    metrics)`` runs ``unroll_steps`` train steps back to back on stacked
    ``[S, B]`` batches (and ``[S, B, K]`` injected negatives) and returns
    each metric stacked ``[S]``, on the device. Nothing in it waits for the
    host, so the steps queue on the card as one call's would.

    A zero-weight batch changes no parameter, moment or count. The last
    ``pad`` steps are such batches (an epoch's tail padding, which the host
    knows), and they also leave the generators where they found them: in
    JAX a step's random keys derive from its step count, so a step that
    does not count draws nothing the next step would not draw again."""
    step = make_train_step(model_cfg, train_cfg, optimizer, lr_schedule,
                           grid=grid)

    def scan_step(
        state: TrainState, node_emb, graph: GraphData, src_s, rel_s, dst_s,
        weight_s, neg_dst_s: Optional[torch.Tensor] = None, pad: int = 0,
    ):
        if src_s.shape[0] != unroll_steps:
            raise ValueError(
                f"scan_step runs {unroll_steps} steps a call, got "
                f"{src_s.shape[0]} batches"
            )
        per_step = []
        for i in range(unroll_steps):
            drawn = state.rng.get_state() if i >= unroll_steps - pad else None
            state, metrics = step(
                state, node_emb, graph, src_s[i], rel_s[i], dst_s[i],
                weight_s[i],
                neg_dst=None if neg_dst_s is None else neg_dst_s[i],
            )
            if drawn is not None:
                state.rng.set_state(drawn)
            per_step.append(metrics)
        return state, {
            k: torch.stack([m[k] for m in per_step]) for k in per_step[0]
        }

    return scan_step


def make_eval_step(
    model_cfg: ModelConfig, train_cfg: TrainConfig, grid=None,
) -> Tuple[Callable, Callable]:
    """``(eval_repr, eval_step)``: ``eval_repr(params, node_emb, graph)``
    runs the full-graph stack once; ``eval_step`` scores one batch against
    it and returns example-weighted sums for the host to aggregate. On a
    ``grid`` every rank scores the whole batch, fetching its rows from
    their owners, and returns the same sums."""
    ks = tuple(train_cfg.eval_ks_ranks)

    @torch.no_grad()
    def eval_repr(params, node_emb, graph: GraphData) -> torch.Tensor:
        return single_gat_step(params, model_cfg, node_emb, graph, train=False)

    @torch.no_grad()
    def eval_step(
        params, x, graph: GraphData, src, rel, dst, weight, *,
        rng: Optional[RngStreams] = None,
        neg_dst: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        loss, fwd = score_batch(
            params, model_cfg, train_cfg, x, graph.num_real_nodes,
            src, rel, dst, weight, rng=rng, neg_dst=neg_dst, grid=grid,
            halo=graph.halo, split_data=False,
        )
        with span("relgat/score"):
            mrr, hits = M.compute_mrr_hits(
                fwd["pos_score"], fwd["neg_score"], ks, weights=weight
            )
        n = weight.sum()
        out = {
            "n_examples": n,
            "loss_sum": loss * n,
            "mrr_sum": mrr * n,
            "pos_score_mean": fwd["pos_score_mean"],
            "neg_score_mean": fwd["neg_score_mean"],
            "pos_score_mean_sum": fwd["pos_score_mean"] * n,
            "neg_score_mean_sum": fwd["neg_score_mean"] * n,
            "nonfinite_scores": fwd["nonfinite_scores"],
            **{f"hits@{k}_sum": v * n for k, v in hits.items()},
        }
        for key in ("cosine_pos", "cosine_neg", "mse"):
            if key in fwd:
                out[f"{key}_sum"] = fwd[key] * n
        return out

    return eval_repr, eval_step
