"""Typed configuration, field for field the JAX package's ``config.py``.

The field names and defaults match ``relgat_projector_tpu/config.py`` so one
``config.json`` loads in either package; ``from_dict`` drops unknown keys.
In this package:

- ``use_pallas`` selects the hand-written Hopper kernels over the CSR layout
  (``data/csr.py``); without it the plain PyTorch path runs on the COO;
- ``block_nodes`` and ``chunk_edges`` describe the TPU's block-padded layout
  and are accepted and ignored: the CUDA path reads CSR;
- ``kernel_precision="default"`` runs the kernels' bf16 row streams and
  ``compute_dtype="bfloat16"`` the projections on bf16 operands, both with
  fp32 arithmetic and results, as in the JAX package;
- ``param_dtype`` is the storage type of every parameter and of the Adam
  moments, and ``compute_dtype`` the operand type of the projections
  (``device.compute_matmul``); both take any name the JAX package's
  ``jnp.dtype`` takes, with what JAX gives for it (``torch_dtype``);
- ``remat`` recomputes each GAT layer in the backward
  (``torch.utils.checkpoint``);
- ``scan_segments > 1`` is accepted with ``use_pallas`` and runs the
  unsegmented kernels: the JAX package scans segments to bound the E-sized
  gather streams a TPU keeps live, and the kernels here gather inside the
  kernel and keep no E-sized float tensor (``ops/propagate.py``); without
  ``use_pallas`` it is ignored, as in the JAX package;
- ``steps_per_call > 1`` runs that many steps a call
  (``train/step.py:make_scan_train_step``);
- a mesh of ``data_axis`` x ``graph_axis`` x ``model_axis`` devices runs
  as that many processes of a ``torch.distributed`` group (``parallel/``),
  the graph axis on the route ``mesh_propagate`` names: ``"halo"`` (with
  ``halo_overlap`` and ``partition_nodes``, and head tensor parallelism
  over ``model_axis``), ``"replicated"`` (the kernels on each rank's
  destination range, features replicated) or ``"gspmd"`` (the plain
  propagate on each rank's piece of the edge list);
- a mesh and route the JAX trainer refuses raise the ``ValueError`` it
  raises, here when the ``RunConfig`` is made (``check_mesh_route``);
- a dtype name the JAX package rejects raises its error, naming the
  field, when the config is made: where JAX raises at the first forward
  (float8 parameters), the port raises when the config is loaded.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class Defaults:
    """Library defaults (parity: reference ``base/constants.py:2-31``)."""

    EPOCHS = 12
    TRAIN_EVAL_RATIO = 0.9
    TRAIN_BATCH_SIZE = 256
    LOG_EVERY_N_STEPS = 100

    NUM_NEG = 6
    GAT_HEADS = 12
    GAT_NUM_LAYERS = 1
    GAT_DROPOUT = 0.25
    PROJECTION_DROPOUT = 0.25
    GAT_ATT_DROPOUT = 0.0
    GAT_OUT_DIM = 300

    LR = 2e-4
    LR_SCHEDULER = "linear"  # {"linear", "cosine", "constant"}
    WARMUP_STEPS = None
    DEFAULT_WARMUP_RATIO = 0.1

    GAT_SCORER = "distmult"  # {"distmult", "transe"}

    # This package's weights file; the JAX package writes
    # ``relgat-model.msgpack`` beside the same JSON sidecars.
    OUT_MODEL_NAME = "relgat-model.pt"
    DEFAULT_TRAINER_OUT_DIR = "relgat-out"
    TRAINING_CONFIG_FILE_NAME = "training-config.json"
    TRAINING_CONFIG_REL_TO_IDX = "relations-map.json"
    TRAIN_STATE_DIR_NAME = "train-state"
    MODEL_CONFIG_FILE_NAME = "config.json"


# Types that numpy learns from ``ml_dtypes`` and the JAX package knows by
# name (``torch_dtype`` finds the ones torch also has).
_ML_DTYPES = (
    "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
    "float8_e5m2fnuz", "float8_e8m0fnu", "float8_e4m3b11fnuz",
    "float8_e3m4", "float8_e4m3", "float4_e2m1fn", "float6_e2m3fn",
    "float6_e3m2fn", "int2", "int4", "uint2", "uint4",
)
# JAX without x64 stores a 64-bit type in its 32-bit twin.
_X64_OFF = {"float64": "float32", "int64": "int32", "uint64": "uint32",
            "complex128": "complex64"}


def dtype_name(name: str) -> str:
    """The canonical name of the type the JAX package (x64 off) stores for
    ``name``: ``"half"`` is ``"float16"``, ``"float64"`` and ``"double"``
    are ``"float32"``. Raises JAX's ``TypeError`` for a name it does not
    understand or a type it cannot hold (``float128``)."""
    name = str(name)
    if name in _ML_DTYPES:
        return name
    import numpy as np

    try:
        dt = np.dtype(name)
    except TypeError:
        raise TypeError(f"data type {name!r} not understood") from None
    if dt.kind not in "biufc" or dt.name in ("float128", "complex256"):
        raise TypeError(
            "JAX only supports number, bool, and string dtypes, got dtype "
            f"{dt.name}")
    return _X64_OFF.get(dt.name, dt.name)


def torch_dtype(name: str):
    """The torch type that holds what the JAX package stores for
    ``name``."""
    import torch

    canon = dtype_name(name)
    dtype = getattr(torch, canon, None)
    if not isinstance(dtype, torch.dtype):
        raise NotImplementedError(
            f"{canon} has no torch type: the port cannot hold it")
    return dtype


def check_dtypes(param_dtype: str, compute_dtype: str) -> None:
    """Raise what the JAX package raises for these names: a name
    ``jnp.dtype`` does not take, parameters of a type ``jax.random.uniform``
    cannot draw, and float8 parameters, which its forward cannot promote
    against fp32. Every other name runs, as in JAX."""
    for field_name, value in (("param_dtype", param_dtype),
                              ("compute_dtype", compute_dtype)):
        try:
            torch_dtype(value)
        except (TypeError, NotImplementedError) as exc:
            raise type(exc)(f"{field_name}={value!r}: {exc}") from None
    canon = dtype_name(param_dtype)
    if canon.startswith("float8"):
        raise ValueError(
            f"param_dtype={param_dtype!r}: Input dtypes ('float32', "
            f"'{canon}') have no available implicit dtype promotion path")
    if canon not in ("float16", "float32", "bfloat16"):
        raise ValueError(
            f"param_dtype={param_dtype!r}: dtype argument to `uniform` must "
            f"be a float dtype, got {canon}")


# Architecture presets, the JAX package's (the reference left them as
# unwired stubs, ``core/architecture/_todo_available.py:5-11``).
ARCHITECTURE_PRESETS: Dict[str, Dict[str, int]] = {
    "small": {"gat_out_dim": 128, "gat_num_layers": 2, "gat_heads": 8},
    "medium": {"gat_out_dim": 128, "gat_num_layers": 3, "gat_heads": 10},
    "large": {"gat_out_dim": 256, "gat_num_layers": 4, "gat_heads": 12},
}


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture spec (reference ``core/model/model.py:13-97``)."""

    in_dim: int
    num_rel: int
    gat_out_dim: int = Defaults.GAT_OUT_DIM
    gat_heads: int = Defaults.GAT_HEADS
    gat_num_layers: int = Defaults.GAT_NUM_LAYERS
    dropout: float = Defaults.GAT_DROPOUT
    rel_attn_dropout: float = Defaults.GAT_ATT_DROPOUT
    use_rel_bias: bool = True
    scorer_type: str = Defaults.GAT_SCORER
    project_to_input_size: bool = True
    projection_layers: int = 1
    projection_dropout: float = 0.0
    projection_hidden_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    use_pallas: bool = False       # the Hopper kernels over the CSR layout
    remat: bool = False
    block_nodes: int = 0           # TPU layout knob; ignored here
    chunk_edges: int = 0           # TPU layout knob; ignored here
    kernel_precision: str = "highest"  # "highest" (fp32; "high" an alias)
    # or "default" (bf16 h and g rows in the kernels, fp32 arithmetic)
    scan_segments: int = 0
    mesh_propagate: str = "halo"
    halo_overlap: bool = True
    partition_nodes: bool = False

    def __post_init__(self) -> None:
        if self.scorer_type.lower() not in ("distmult", "transe"):
            raise ValueError(f"Unknown scorer_type: {self.scorer_type}")
        if self.mesh_propagate not in ("halo", "replicated", "gspmd"):
            raise ValueError(f"Unknown mesh_propagate: {self.mesh_propagate}")
        if self.project_to_input_size and self.projection_layers < 1:
            raise ValueError(
                "projection_layers must be >= 1 when project_to_input_size=True"
            )
        if self.gat_num_layers < 1:
            raise ValueError("gat_num_layers must be >= 1")
        if self.kernel_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"Unknown kernel_precision: {self.kernel_precision}"
            )
        check_dtypes(self.param_dtype, self.compute_dtype)

    @property
    def gat_concat_dim(self) -> int:
        return self.gat_out_dim * self.gat_heads

    @property
    def scorer_dim(self) -> int:
        """Dimension the scorer operates in (reference ``model.py:76-85``)."""
        return self.in_dim if self.project_to_input_size else self.gat_concat_dim

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop spec (reference ``trainer/relgat_projector.py:32-92``)."""

    epochs: int = Defaults.EPOCHS
    train_batch_size: int = Defaults.TRAIN_BATCH_SIZE
    eval_batch_size: int = Defaults.TRAIN_BATCH_SIZE
    num_neg: int = Defaults.NUM_NEG
    train_ratio: float = Defaults.TRAIN_EVAL_RATIO
    seed: int = 42

    lr: float = Defaults.LR
    lr_scheduler: str = Defaults.LR_SCHEDULER
    lr_decay: float = 1.0
    warmup_steps: Optional[int] = None
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    optimizer: str = "adam"  # "adam" (torch-Adam semantics) | "adamw"

    margin: float = 1.0
    use_self_adv_neg: bool = False
    self_adv_alpha: float = 1.0
    relgat_weight: float = 1.0
    pos_cosine_weight: float = 1.0
    neg_cosine_weight: float = 1.0
    mse_weight: float = 0.0

    eval_every_n_steps: Optional[int] = None
    save_every_n_steps: Optional[int] = None
    early_stop_patience: Optional[int] = None
    eval_ks_ranks: Tuple[int, ...] = (1, 2, 3)
    log_every_n_steps: int = Defaults.LOG_EVERY_N_STEPS

    max_checkpoints: int = 5
    out_dir: str = Defaults.DEFAULT_TRAINER_OUT_DIR
    steps_per_call: int = 1

    def __post_init__(self) -> None:
        if self.lr_scheduler.lower() not in ("linear", "cosine", "constant"):
            raise ValueError(f"Unknown lr_scheduler type: {self.lr_scheduler}")
        if (
            self.save_every_n_steps is not None
            and self.eval_every_n_steps is not None
        ):
            if self.save_every_n_steps < self.eval_every_n_steps:
                raise ValueError(
                    "save_every_n_steps must be >= eval_every_n_steps"
                )
            if self.save_every_n_steps % self.eval_every_n_steps != 0:
                raise ValueError(
                    "save_every_n_steps must be divisible by eval_every_n_steps"
                )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["eval_ks_ranks"] = list(self.eval_ks_ranks)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(TrainConfig)}
        d = {k: v for k, v in d.items() if k in known}
        if "eval_ks_ranks" in d and d["eval_ks_ranks"] is not None:
            d["eval_ks_ranks"] = tuple(sorted(set(d["eval_ks_ranks"])))
        return TrainConfig(**d)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: one process a device (``parallel/mesh.py``)."""

    data_axis: int = 1   # DP over the triplet batch
    graph_axis: int = 1  # destination-row or edge shards of the graph
    model_axis: int = 1  # TP over attention heads (halo route)

    def __post_init__(self) -> None:
        for name in ("data_axis", "graph_axis", "model_axis"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def num_devices(self) -> int:
        return self.data_axis * self.graph_axis * self.model_axis


def check_mesh_route(model: ModelConfig, mesh: MeshConfig) -> None:
    """Raise the ``ValueError`` the JAX trainer raises for this mesh and
    route (``train/trainer.py:84-94``, ``:117-122``, ``:242-257``), and
    nothing where it trains."""
    if mesh.num_devices == 1:
        return
    route, graph = model.mesh_propagate, mesh.graph_axis
    if graph > 1 and route == "replicated" and not model.use_pallas:
        raise ValueError(
            f"mesh_propagate='replicated' with graph_axis={graph} is the "
            "per-device kernel route and requires use_pallas=True; use "
            "'halo' (default) or 'gspmd' for the plain route"
        )
    if (graph > 1 and route == "replicated" and model.use_pallas
            and model.scan_segments > 1):
        raise ValueError(
            f"scan_segments={model.scan_segments} with graph_axis={graph} "
            "requires mesh_propagate='halo' (the replicated route has no "
            "scanned per-device layouts)"
        )
    if model.use_pallas and route == "gspmd":
        raise ValueError(
            "mesh_propagate='gspmd' has no kernel partitioning; use 'halo' "
            "(default) or 'replicated' with use_pallas"
        )
    if mesh.model_axis > 1:
        if route != "halo":
            raise ValueError(
                f"model_axis={mesh.model_axis} (head TP) requires "
                f"mesh_propagate='halo', not {route!r}"
            )
        if model.gat_heads % mesh.model_axis != 0:
            raise ValueError(
                f"gat_heads={model.gat_heads} not divisible by "
                f"model_axis={mesh.model_axis}"
            )


@dataclass
class RunConfig:
    """Bundles everything for one training run; fully JSON-serializable."""

    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    architecture_name: Optional[str] = None
    base_model_name: Optional[str] = "relgat"
    run_name: Optional[str] = None

    def __post_init__(self) -> None:
        check_mesh_route(self.model, self.mesh)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.to_dict(),
            "train": self.train.to_dict(),
            "mesh": dataclasses.asdict(self.mesh),
            "architecture_name": self.architecture_name,
            "base_model_name": self.base_model_name,
            "run_name": self.run_name,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, ensure_ascii=False)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RunConfig":
        return RunConfig(
            model=ModelConfig.from_dict(d["model"]),
            train=TrainConfig.from_dict(d.get("train", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
            architecture_name=d.get("architecture_name"),
            base_model_name=d.get("base_model_name", "relgat"),
            run_name=d.get("run_name"),
        )

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        return RunConfig.from_dict(json.loads(s))


def apply_architecture_preset(
    name: Optional[str], overrides: Dict[str, Any]
) -> Dict[str, Any]:
    """Merge a named preset under explicit overrides (overrides win).
    Unknown names pass through, as in the reference."""
    merged = dict(overrides)
    preset = ARCHITECTURE_PRESETS.get((name or "").lower())
    if preset:
        for k, v in preset.items():
            merged.setdefault(k, v)
    return merged
