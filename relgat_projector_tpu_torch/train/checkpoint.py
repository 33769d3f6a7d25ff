"""Checkpoint storage with full train-state resume.

Port of ``relgat_projector_tpu/train/checkpoint.py``. Each checkpoint
directory holds the model (``save_pretrained``: ``config.json`` and
``relgat-model.pt``), the JSON sidecars the trainer passes
(``training-config.json``, ``relations-map.json``, ``loop-state.json``)
and the full train state in ``train-state.pt``:

- params, Adam ``mu``/``nu``/``count``, ``step`` and ``nonfinite_steps``,
  as CPU tensors of their own types (bf16 and fp16 parameters and moments
  come back in their type, bit for bit);
- both generators of the state's ``RngStreams`` and the device type they
  came from (``utils/rng.py``), so a resumed run draws the same dropout
  masks and negatives as the uninterrupted one.

The state is copied to the host before ``save_train_state`` returns; with
``async_write`` a thread then serialises and writes it, into ``.tmp`` first
and then ``os.replace``, so a killed write never leaves a half file under
the real name. Pruning joins that thread before it deletes a directory.

A directory of the JAX package holds ``train-state.msgpack`` instead, which
``load_train_state`` reads without flax (``utils/msgpack.py``), so a run
trained with the JAX package resumes here. Its parameters, Adam's ``mu``,
``nu`` and ``count``, ``step`` and ``nonfinite_steps`` come across as they
are, with two changes: a moment stored in another type than its parameter
(JAX's fp32 moments of a bf16 or fp16 ``rel_bias`` on its Pallas route)
is cast to the parameter's type, as this package stores moments; and
JAX's key, which no torch generator can continue, seeds the streams (see
``_jax_rng``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from relgat_projector_tpu_torch.config import Defaults, ModelConfig
from relgat_projector_tpu_torch.models import model as model_lib
from relgat_projector_tpu_torch.train.state import AdamState, TrainState
from relgat_projector_tpu_torch.utils import msgpack
from relgat_projector_tpu_torch.utils.rng import RngStreams
from relgat_projector_tpu_torch.utils.tree import tree_leaves, tree_map

_STATE_FILE = "train-state.pt"
_JAX_STATE_FILE = "train-state.msgpack"


def _state_to_host(state: TrainState) -> Dict[str, Any]:
    """A copy of the whole state in host memory, complete on return."""

    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    return {
        "params": tree_map(host, state.params),
        "opt_state": {
            "mu": tree_map(host, state.opt_state.mu),
            "nu": tree_map(host, state.opt_state.nu),
            "count": host(state.opt_state.count),
        },
        "step": host(state.step),
        "nonfinite_steps": host(state.nonfinite_steps),
        "rng": state.rng.get_state(),
    }


class _Writer(threading.Thread):
    """Serialise ``host`` to ``path`` through ``path.tmp``; ``join_checked``
    re-raises what the write raised."""

    def __init__(self, path: str, host: Dict[str, Any]):
        super().__init__(daemon=True)
        self.path, self.host, self.error = path, host, None

    def run(self) -> None:
        try:
            tmp = self.path + ".tmp"
            torch.save(self.host, tmp)
            os.replace(tmp, self.path)
        except BaseException as exc:  # handed to the joining thread
            self.error = exc

    def join_checked(self) -> None:
        self.join()
        if self.error is not None:
            raise RuntimeError(f"writing {self.path} failed") from self.error


def _write_state(
    path: str, host: Dict[str, Any], async_write: bool
) -> Optional[_Writer]:
    writer = _Writer(path, host)
    if async_write:
        writer.start()
        return writer
    writer.run()
    if writer.error is not None:
        raise writer.error
    return None


def save_train_state(
    path: str, state: TrainState, *, async_write: bool = False
) -> Optional[threading.Thread]:
    """Persist the full train state. With ``async_write`` the device->host
    copy happens here, and serialisation and disk IO run on the returned
    thread so training goes on at once."""
    return _write_state(path, _state_to_host(state), async_write)


def _jax_rng(key: torch.Tensor, device: torch.device) -> RngStreams:
    """Streams seeded from a JAX key's two uint32 words, ``(k0 << 32 | k1)``
    reduced below 2^63 - 1. The same key always gives the same streams, but
    not JAX's numbers: a resumed run draws other negatives and dropout
    masks than the JAX run would have."""
    k0, k1 = (int(w) for w in key.reshape(-1).tolist())
    return RngStreams.from_seed(((k0 << 32) | k1) % (2**63 - 2), device)


def _load_jax_state(path: str, template: TrainState) -> TrainState:
    """A JAX package's ``train-state.msgpack`` onto ``template``'s device.
    optax's chain state is a dict keyed ``"0"``, ``"1"``, ... whose Adam
    entry moves with clipping and decay, so it is found by its keys."""
    with open(path, "rb") as f:
        raw = msgpack.msgpack_restore(f.read())
    dev = template.step.device
    adam = [s for s in raw["opt_state"].values()
            if isinstance(s, dict) and set(s) == {"count", "mu", "nu"}]
    if len(adam) != 1:
        raise ValueError(f"{path}: {len(adam)} Adam states in the optimizer "
                         "chain, expected 1")
    trees = {name: msgpack.restore_like(template.params, tree) for name, tree
             in (("params", raw["params"]), ("mu", adam[0]["mu"]),
                 ("nu", adam[0]["nu"]))}
    want = [tuple(t.shape) for t in tree_leaves(template.params)]
    for name, tree in trees.items():
        got = [tuple(t.shape) for t in tree_leaves(tree)]
        if got != want:
            raise ValueError(f"{path} holds {name} of shapes {got}, "
                             f"expected {want}")

    def like_params(tree):
        return tree_map(lambda t, p: t.to(dev, p.dtype), tree, template.params)

    def counter(t):
        return t.to(dev, torch.int32).reshape(())

    return TrainState(
        params=like_params(trees["params"]),
        opt_state=AdamState(mu=like_params(trees["mu"]),
                            nu=like_params(trees["nu"]),
                            count=counter(adam[0]["count"])),
        step=counter(raw["step"]),
        rng=_jax_rng(raw["rng"], dev),
        nonfinite_steps=counter(raw["nonfinite_steps"]),
    )


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Read a state written by :func:`save_train_state` onto the device of
    ``template``, whose parameter tree it must match; a ``.msgpack`` path,
    or the JAX package's ``train-state.msgpack`` beside a ``path`` that is
    not there, is read as the JAX package's state."""
    if not os.path.isfile(path):
        jax_state = os.path.join(os.path.dirname(path), _JAX_STATE_FILE)
        if not os.path.isfile(jax_state):
            raise FileNotFoundError(f"train state not found: {path}")
        path = jax_state
    if path.endswith(".msgpack"):
        return _load_jax_state(path, template)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    dev = template.step.device
    want = [tuple(t.shape) for t in tree_leaves(template.params)]
    got = [tuple(t.shape) for t in tree_leaves(saved["params"])]
    if got != want:
        raise ValueError(
            f"{path} holds parameters of shapes {got}, expected {want}"
        )

    def to_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev)

    opt = saved["opt_state"]
    return TrainState(
        params=tree_map(to_dev, saved["params"]),
        opt_state=AdamState(
            mu=tree_map(to_dev, opt["mu"]),
            nu=tree_map(to_dev, opt["nu"]),
            count=to_dev(opt["count"]),
        ),
        step=to_dev(saved["step"]),
        rng=RngStreams.from_state(saved["rng"], dev),
        nonfinite_steps=to_dev(saved["nonfinite_steps"]),
    )


class RelGATStorage:
    """Checkpoint directory manager (reference ``handlers/storage.py``)."""

    # Trainer-loop sidecar (best metric / early-stop counter / dispatch
    # counter) written next to every train state so resume restores the
    # loop, not just the optimizer.
    LOOP_STATE_FILE = "loop-state.json"

    def __init__(
        self,
        out_dir: Optional[str],
        max_checkpoints: Optional[int] = 5,
        save_every_n_steps: Optional[int] = None,
    ):
        self.max_checkpoints = (
            int(max_checkpoints) if max_checkpoints is not None else None
        )
        self.save_every_n_steps = (
            int(save_every_n_steps)
            if save_every_n_steps is not None and int(save_every_n_steps) > 0
            else None
        )
        self.saved_checkpoints: deque = deque()
        self._pending_write: Optional[_Writer] = None
        self.save_dir = Path(
            out_dir if out_dir is not None else Defaults.DEFAULT_TRAINER_OUT_DIR
        )
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def save_checkpoint(
        self,
        subdir: str,
        state: TrainState,
        model_cfg: ModelConfig,
        files: List[Tuple[str, Dict[Any, Any]]],
        *,
        prunable: bool = True,
        async_write: bool = False,
    ) -> str:
        """Write the model, the sidecars and the full train state into
        ``save_dir/subdir``; returns the directory. With ``async_write`` the
        train state is written off-thread."""
        # Never let two background writes overlap: join the previous one.
        self.wait_for_writes()
        out_dir = self.save_dir / subdir
        out_dir.mkdir(parents=True, exist_ok=True)
        host = _state_to_host(state)
        model_lib.save_pretrained(
            str(out_dir), host["params"], model_cfg, add_files=list(files)
        )
        self._pending_write = _write_state(
            str(out_dir / _STATE_FILE), host, async_write
        )
        if prunable:
            self.saved_checkpoints.append(out_dir)
        return str(out_dir)

    def wait_for_writes(self) -> None:
        writer, self._pending_write = self._pending_write, None
        if writer is not None:
            writer.join_checked()

    def latest_resumable(self) -> Optional[str]:
        """Newest checkpoint directory (by mtime) holding a train state, or
        None. A directory left with only a ``.tmp`` by a killed write does
        not count; one with the JAX package's state does."""
        if not self.save_dir.exists():
            return None
        candidates = [
            d
            for d in self.save_dir.iterdir()
            if d.is_dir()
            and ((d / _STATE_FILE).is_file() or (d / _JAX_STATE_FILE).is_file())
        ]
        if not candidates:
            return None
        return str(max(candidates, key=lambda d: d.stat().st_mtime))

    def load_checkpoint(self, ckpt_dir: str, template: TrainState) -> TrainState:
        return load_train_state(os.path.join(ckpt_dir, _STATE_FILE), template)

    def load_loop_state(self, ckpt_dir: str) -> Optional[Dict[str, Any]]:
        """Read the trainer-loop sidecar, or None for pre-sidecar dirs."""
        path = os.path.join(ckpt_dir, self.LOOP_STATE_FILE)
        if not os.path.isfile(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    def prune_checkpoints(self) -> None:
        """Keep the ``max_checkpoints`` most recent prunable checkpoints."""
        if self.max_checkpoints is None or self.max_checkpoints < 1:
            return
        # Don't rmtree a directory whose background write is in flight.
        self.wait_for_writes()
        while len(self.saved_checkpoints) > self.max_checkpoints:
            oldest = self.saved_checkpoints.popleft()
            try:
                shutil.rmtree(oldest)
                print(f"Removed old checkpoint: {oldest}")
            except OSError as exc:
                print(f"Could not delete {oldest}: {exc}")
