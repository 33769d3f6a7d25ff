"""Command-line trainer of the PyTorch/CUDA port.

Every flag of ``relgat_projector_tpu/cli.py`` with the same name, default
and two-pass ``--config`` layer (explicit flags > config file > defaults),
so the same command line trains the same run in either package; plus
``--device`` (default ``cuda``: without a card the CLI raises instead of
running on the CPU). ``--use-pallas`` selects the hand-written Hopper
kernels; ``--kernel-precision default`` their bf16 row streams and
``--compute-dtype bfloat16`` bf16 projections; ``--remat``, ``--scan-segments``
and ``--steps-per-call`` run as in the JAX package (``config.py``).
``--mesh-data``, ``--mesh-graph`` and ``--mesh-model`` train on a grid of
that many processes, one a device, the graph axis on the route
``--mesh-propagate`` names: ``halo`` (``--no-halo-overlap``,
``--partition-nodes``; the only route with ``--mesh-model`` above 1),
``replicated`` (with ``--use-pallas``) or ``gspmd`` (without): start one
process per device with ``--distributed --num-processes N --process-id I
--coordinator-address HOST:PORT``; the process group's backend follows
``--device`` (NCCL on CUDA, gloo on the CPU). A mesh and route the JAX
trainer refuses raise its ``ValueError``. ``--compute-dtype`` takes float32
and bfloat16, as JAX's flag does; a ``--config`` file may name any dtype
the JAX package takes (float16 too), and one that JAX rejects raises its
error naming the field. As in the JAX package, the CLI sets no
``param_dtype`` (a ``--config`` file's is checked and then dropped): bf16
or fp16 parameters are a ``ModelConfig`` field of the Python API. Console
entry point: ``relgat-projector-train-torch``; also ``python -m
relgat_projector_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
from typing import Optional

from relgat_projector_tpu_torch.config import (
    Defaults,
    MeshConfig,
    ModelConfig,
    RunConfig,
    TrainConfig,
    apply_architecture_preset,
)
from relgat_projector_tpu_torch.device import resolve_device

APP_DESCRIPTION = """RelGAT trainer (PyTorch/CUDA).

Consumes the reference dataset format: a pickle of node embeddings
({node_id: vector}), a JSON relation mapping ({rel_name: idx}) and a JSON
triplet list ([src_id, dst_id, rel_name]); or --synthetic for a generated KG.
"""


def _config_file_defaults(run_cfg: RunConfig) -> dict:
    """Map a serialized RunConfig (the ``training-config.json`` written to
    every checkpoint) onto parser dests, implementing the SURVEY §5.6
    precedence CLI > config file > defaults: these become the parser's
    DEFAULTS, so flags the user actually passes still win."""
    m, t, me = run_cfg.model, run_cfg.train, run_cfg.mesh
    return dict(
        architecture=run_cfg.architecture_name,
        run_name=run_cfg.run_name,
        # model
        gat_out_dim=m.gat_out_dim,
        heads=m.gat_heads,
        gat_num_layers=m.gat_num_layers,
        dropout=m.dropout,
        dropout_rel_attention=m.rel_attn_dropout,
        scorer=m.scorer_type,
        project_to_input_size=m.project_to_input_size,
        projection_layers=m.projection_layers,
        projection_dropout=m.projection_dropout,
        projection_hidden_dim=m.projection_hidden_dim,
        compute_dtype=m.compute_dtype,
        use_pallas=m.use_pallas,
        kernel_precision=m.kernel_precision,
        block_nodes=m.block_nodes,
        chunk_edges=m.chunk_edges,
        remat=m.remat,
        scan_segments=m.scan_segments,
        mesh_propagate=m.mesh_propagate,
        halo_overlap=m.halo_overlap,
        partition_nodes=m.partition_nodes,
        # train
        epochs=t.epochs,
        batch_size=t.train_batch_size,
        num_neg=t.num_neg,
        train_ratio=t.train_ratio,
        seed=t.seed,
        lr=t.lr,
        lr_scheduler=t.lr_scheduler,
        lr_decay=t.lr_decay,
        warmup_steps=t.warmup_steps,
        weight_decay=t.weight_decay,
        grad_clip_norm=t.grad_clip_norm,
        optimizer=t.optimizer,
        margin=t.margin,
        use_self_adv_neg=t.use_self_adv_neg,
        self_adv_alpha=t.self_adv_alpha,
        relgat_weight=t.relgat_weight,
        pos_cosine_weight=t.pos_cosine_weight,
        neg_cosine_weight=t.neg_cosine_weight,
        mse_weight=t.mse_weight,
        eval_every_n_steps=t.eval_every_n_steps,
        save_every_n_steps=t.save_every_n_steps,
        early_stop_patience=t.early_stop_patience,
        log_every_n_steps=t.log_every_n_steps,
        max_checkpoints=t.max_checkpoints,
        save_dir=t.out_dir,
        steps_per_call=t.steps_per_call,
        # mesh
        mesh_data=me.data_axis,
        mesh_graph=me.graph_axis,
        mesh_model=me.model_axis,
    )


def get_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=APP_DESCRIPTION)

    p.add_argument("--config", type=str, default=None,
                   help="JSON run config to use as the base layer "
                        "(the training-config.json serialized into every "
                        "checkpoint feeds back in directly); explicit "
                        "flags override it, it overrides library defaults")
    p.add_argument("--architecture-name", dest="architecture", type=str,
                   default=None,
                   help="Preset name [small, medium, large] (optional)")

    # Dataset
    p.add_argument("--nodes-embeddings-path", type=str, default=None)
    p.add_argument("--relations-mapping", type=str, default=None)
    p.add_argument("--relations-triplets", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="Train on a generated synthetic KG (no files needed)")
    p.add_argument("--synthetic-nodes", type=int, default=10_000)
    p.add_argument("--synthetic-edges", type=int, default=100_000)
    p.add_argument("--synthetic-rels", type=int, default=8)
    p.add_argument("--synthetic-dim", type=int, default=200)
    p.add_argument("--synthetic-nn-pool", dest="synthetic_nn_pool",
                   type=int, default=0,
                   help="candidate-pool size for the structured dst "
                        "mapping (0 = auto ~n/4; small values bound the "
                        "host-side generation cost at production dims)")
    p.add_argument("--synthetic-self-loops", dest="synthetic_self_loops",
                   action="store_true",
                   help="append one self-loop edge per node (extra "
                        "relation): in-neighbor-only aggregation makes the "
                        "structured task's own-embedding signal invisible "
                        "without them (PARITY.md round-2 caveat) — required"
                        " for eval MRR to climb above random")

    # Training process
    p.add_argument("--train-ratio", type=float,
                   default=Defaults.TRAIN_EVAL_RATIO)
    p.add_argument("--epochs", type=int, default=Defaults.EPOCHS)
    p.add_argument("--batch-size", type=int, default=Defaults.TRAIN_BATCH_SIZE)
    p.add_argument("--log-every-n-steps", dest="log_every_n_steps", type=int,
                   default=Defaults.LOG_EVERY_N_STEPS)
    p.add_argument("--scorer", type=str, choices=["distmult", "transe"],
                   default=Defaults.GAT_SCORER)
    # None sentinels: a preset fills these only when the flag was truly
    # absent (comparing against library defaults would misread an explicit
    # "--heads 12" as unset).
    p.add_argument("--gat-out-dim", dest="gat_out_dim", type=int,
                   default=None)
    p.add_argument("--gat-num-layers", dest="gat_num_layers", type=int,
                   default=None)
    p.add_argument("--num-neg", dest="num_neg", type=int,
                   default=Defaults.NUM_NEG)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--project-to-input-size", dest="project_to_input_size",
                   action="store_true")
    p.add_argument("--projection-layers", dest="projection_layers", type=int,
                   default=1)
    p.add_argument("--projection-dropout", dest="projection_dropout",
                   type=float, default=Defaults.PROJECTION_DROPOUT)
    p.add_argument("--projection-hidden-dim", dest="projection_hidden_dim",
                   type=int, default=0)
    p.add_argument("--dropout", type=float, default=Defaults.GAT_DROPOUT)
    p.add_argument("--dropout-relation-attention",
                   dest="dropout_rel_attention", type=float,
                   default=Defaults.GAT_ATT_DROPOUT)
    p.add_argument("--lr", type=float, default=Defaults.LR)
    p.add_argument("--lr-scheduler", dest="lr_scheduler", type=str,
                   choices=["linear", "cosine", "constant"],
                   default=Defaults.LR_SCHEDULER)
    p.add_argument("--lr-decay", dest="lr_decay", type=float, default=1.0)
    p.add_argument("--warmup-steps", dest="warmup_steps", default=None)
    p.add_argument("--weight-decay", dest="weight_decay", type=float,
                   default=0.0)
    p.add_argument("--grad-clip-norm", dest="grad_clip_norm", type=float,
                   default=None)
    p.add_argument("--use-self-adv-neg", dest="use_self_adv_neg",
                   action="store_true")
    p.add_argument("--self-adv-alpha", dest="self_adv_alpha", type=float,
                   default=1.0)
    p.add_argument("--eval-every-n-steps", dest="eval_every_n_steps",
                   default=None)
    p.add_argument("--early-stop-patience", dest="early_stop_patience",
                   type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-dir", dest="save_dir", type=str,
                   default=Defaults.DEFAULT_TRAINER_OUT_DIR)
    p.add_argument("--save-every-n-steps", dest="save_every_n_steps",
                   type=int, default=None)
    p.add_argument("--max-checkpoints", dest="max_checkpoints", type=int,
                   default=5)
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--wandb", action="store_true", help="Log to W&B")
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--relgat-weight", dest="relgat_weight", type=float,
                   default=1.0)
    p.add_argument("--pos-cosine-weight", dest="pos_cosine_weight",
                   type=float, default=1.0)
    p.add_argument("--neg-cosine-weight", dest="neg_cosine_weight",
                   type=float, default=1.0)
    p.add_argument("--mse-weight", dest="mse_weight", type=float, default=0.0)

    # Beyond the reference
    p.add_argument("--use-pallas", dest="use_pallas", action="store_true",
                   help="Use the hand-written Hopper propagate kernels")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the newest checkpoint under --save-dir")
    p.add_argument("--optimizer", type=str, choices=["adam", "adamw"],
                   default="adam")
    p.add_argument("--compute-dtype", dest="compute_dtype", type=str,
                   choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--kernel-precision", dest="kernel_precision", type=str,
                   choices=["highest", "default"], default="highest",
                   help="precision inside the propagate kernels: 'highest' "
                        "= fp32; 'default' = h and g read as bf16 rows, "
                        "fp32 arithmetic")
    p.add_argument("--block-nodes", dest="block_nodes", type=int, default=0,
                   help="the TPU's blocked layout (TD); ignored here, the "
                        "kernels read CSR")
    p.add_argument("--chunk-edges", dest="chunk_edges", type=int, default=0,
                   help="the TPU's blocked layout (TE); ignored here")
    p.add_argument("--remat", action="store_true",
                   help="recompute each GAT layer in the backward "
                        "instead of keeping its activations")
    p.add_argument("--scan-segments", dest="scan_segments", type=int,
                   default=0,
                   help=">1 with --use-pallas: the JAX package's scanned "
                        "propagate; the kernels here keep no per-edge "
                        "tensor and run unsegmented")
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int,
                   default=1,
                   help="train steps per call; logs and evals fire in "
                        "windows of this many steps")

    # Multi-device / multi-process (no reference counterpart)
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1,
                   help="devices on the 'data' (DP) mesh axis")
    p.add_argument("--mesh-graph", dest="mesh_graph", type=int, default=1,
                   help="devices on the 'graph' (edge-partition) mesh axis")
    p.add_argument("--mesh-model", dest="mesh_model", type=int, default=1,
                   help="devices on the 'model' (head-TP) mesh axis "
                        "(halo route)")
    p.add_argument("--mesh-propagate", dest="mesh_propagate",
                   choices=["halo", "replicated", "gspmd"], default="halo",
                   help="graph-axis strategy: boundary-only halo exchange "
                        "(default), replicated features + per-device "
                        "kernels, or GSPMD psums")
    p.add_argument("--no-halo-overlap", dest="halo_overlap",
                   action="store_false", default=True,
                   help="disable the halo mode's local/remote edge split "
                        "(which overlaps the boundary all_to_all with "
                        "local aggregation)")
    p.add_argument("--partition-nodes", dest="partition_nodes",
                   action="store_true", default=False,
                   help="relabel nodes with the min-cut partitioner "
                        "(BFS-grow + label propagation) before the halo "
                        "build so clustered KGs with shuffled ids get "
                        "clustered-case boundary traffic")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group before "
                        "training (one process per device; needs "
                        "--coordinator-address, --num-processes and "
                        "--process-id)")
    p.add_argument("--coordinator-address", dest="coordinator_address",
                   type=str, default=None)
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=None)
    p.add_argument("--process-id", dest="process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device to train on: 'cuda' (default) or 'cpu'; "
                        "the CPU runs the kernels' plain PyTorch versions")

    # Two-pass parse for the config-file layer: find --config first, lift
    # its values into the parser defaults, then parse for real so explicit
    # flags override the file.
    pre, _ = p.parse_known_args(argv)
    if pre.config:
        import json

        with open(pre.config, encoding="utf-8") as f:
            run_cfg = RunConfig.from_dict(json.load(f))
        p.set_defaults(**_config_file_defaults(run_cfg))

    return p.parse_args(argv)


def build_run_config(args: argparse.Namespace) -> RunConfig:
    # Flag fixups (parity with reference apps ``:347-372``).
    if args.save_every_n_steps is not None and args.save_every_n_steps <= 0:
        args.save_every_n_steps = None
    warmup: Optional[int] = (
        int(args.warmup_steps)
        if args.warmup_steps is not None and str(args.warmup_steps).strip()
        else None
    )
    eval_every: Optional[int] = (
        int(args.eval_every_n_steps)
        if args.eval_every_n_steps is not None
        and str(args.eval_every_n_steps).strip()
        else None
    )

    # Presets fill in architecture dims the user did NOT pass at all
    # (explicit flags win; the reference's presets were unwired TODOs).
    explicit = {}
    if args.gat_out_dim is not None:
        explicit["gat_out_dim"] = args.gat_out_dim
    if args.heads is not None:
        explicit["gat_heads"] = args.heads
    if args.gat_num_layers is not None:
        explicit["gat_num_layers"] = args.gat_num_layers
    arch = apply_architecture_preset(args.architecture, explicit)
    model = ModelConfig(
        in_dim=1,   # derived from data by the trainer
        num_rel=1,  # derived from data by the trainer
        gat_out_dim=arch.get("gat_out_dim", Defaults.GAT_OUT_DIM),
        gat_heads=arch.get("gat_heads", Defaults.GAT_HEADS),
        gat_num_layers=arch.get("gat_num_layers", Defaults.GAT_NUM_LAYERS),
        dropout=args.dropout,
        rel_attn_dropout=args.dropout_rel_attention,
        scorer_type=args.scorer,
        project_to_input_size=args.project_to_input_size,
        projection_layers=max(1, args.projection_layers)
        if args.project_to_input_size
        else args.projection_layers,
        projection_dropout=args.projection_dropout,
        projection_hidden_dim=args.projection_hidden_dim,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        kernel_precision=args.kernel_precision,
        block_nodes=args.block_nodes,
        chunk_edges=args.chunk_edges,
        remat=args.remat,
        scan_segments=args.scan_segments,
        mesh_propagate=args.mesh_propagate,
        halo_overlap=args.halo_overlap,
        partition_nodes=args.partition_nodes,
    )
    train = TrainConfig(
        epochs=args.epochs,
        train_batch_size=args.batch_size,
        eval_batch_size=args.batch_size,
        num_neg=args.num_neg,
        train_ratio=args.train_ratio,
        seed=args.seed,
        lr=args.lr,
        lr_scheduler=args.lr_scheduler,
        lr_decay=args.lr_decay,
        warmup_steps=warmup,
        weight_decay=args.weight_decay,
        grad_clip_norm=args.grad_clip_norm,
        optimizer=args.optimizer,
        margin=args.margin,
        use_self_adv_neg=args.use_self_adv_neg,
        self_adv_alpha=args.self_adv_alpha,
        relgat_weight=args.relgat_weight,
        pos_cosine_weight=args.pos_cosine_weight,
        neg_cosine_weight=args.neg_cosine_weight,
        mse_weight=args.mse_weight,
        eval_every_n_steps=eval_every,
        save_every_n_steps=args.save_every_n_steps,
        early_stop_patience=args.early_stop_patience,
        eval_ks_ranks=tuple(range(1, args.num_neg + 1)),
        log_every_n_steps=args.log_every_n_steps,
        max_checkpoints=args.max_checkpoints,
        out_dir=args.save_dir,
        steps_per_call=args.steps_per_call,
    )
    return RunConfig(
        model=model,
        train=train,
        mesh=MeshConfig(
            data_axis=args.mesh_data,
            graph_axis=args.mesh_graph,
            model_axis=args.mesh_model,
        ),
        architecture_name=args.architecture,
        run_name=args.run_name,
    )


def load_kg(args: argparse.Namespace):
    """``(node2emb, rel2idx, triplets)``: the synthetic KG of the flags, or
    the reference's three files."""
    if args.synthetic:
        from relgat_projector_tpu_torch.data.synthetic import (
            generate_synthetic_kg,
        )

        return generate_synthetic_kg(
            num_nodes=args.synthetic_nodes,
            num_edges=args.synthetic_edges,
            num_rel=args.synthetic_rels,
            emb_dim=args.synthetic_dim,
            seed=args.seed,
            nn_pool=args.synthetic_nn_pool,
            self_loops=args.synthetic_self_loops,
        )
    if not (
        args.nodes_embeddings_path
        and args.relations_mapping
        and args.relations_triplets
    ):
        raise SystemExit(
            "Provide --nodes-embeddings-path/--relations-mapping/"
            "--relations-triplets, or use --synthetic."
        )
    from relgat_projector_tpu_torch.data.io import load_embeddings_and_edges

    return load_embeddings_and_edges(
        path_to_nodes=args.nodes_embeddings_path,
        path_to_rels=args.relations_mapping,
        path_to_edges=args.relations_triplets,
    )


def main(argv=None) -> None:
    args = get_args(argv)
    device = resolve_device(args.device)
    run_config = build_run_config(args)

    # The process group before the trainer is built (parallel/distributed.py).
    mesh = run_config.mesh
    if args.num_processes not in (None, mesh.num_devices):
        raise ValueError(
            f"--num-processes {args.num_processes} for a mesh of "
            f"data_axis={mesh.data_axis}, graph_axis={mesh.graph_axis}, "
            f"model_axis={mesh.model_axis}: one process a device"
        )
    if args.distributed or args.num_processes is not None:
        from relgat_projector_tpu_torch.parallel import initialize_distributed

        rank = initialize_distributed(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=device,
        )
        print(f"torch.distributed initialized (process {rank})")

    node2emb, rel2idx, edge_index_raw = load_kg(args)

    from relgat_projector_tpu_torch.train.trainer import RelGATTrainer

    trainer = RelGATTrainer(
        run_config,
        node2emb,
        rel2idx,
        edge_index_raw,
        log_to_wandb=args.wandb,
        device=device,
    )
    if args.resume:
        trainer.maybe_resume()
    trainer.train(epochs=args.epochs)


if __name__ == "__main__":
    main()
