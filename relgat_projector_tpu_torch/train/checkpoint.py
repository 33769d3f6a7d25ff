"""Checkpoint storage with full train-state resume.

Port of ``relgat_projector_tpu/train/checkpoint.py``. Each checkpoint
directory holds the model (``save_pretrained``: ``config.json`` and
``relgat-model.pt``), the JSON sidecars the trainer passes
(``training-config.json``, ``relations-map.json``, ``loop-state.json``)
and the full train state in ``train-state.pt``:

- params, Adam ``mu``/``nu``/``count``, ``step`` and ``nonfinite_steps``,
  as CPU tensors of their own types (bf16 parameters and moments come back
  bf16, bit for bit);
- both generators of the state's ``RngStreams`` and the device type they
  came from (``utils/rng.py``), so a resumed run draws the same dropout
  masks and negatives as the uninterrupted one.

The state is copied to the host before ``save_train_state`` returns; with
``async_write`` a thread then serialises and writes it, into ``.tmp`` first
and then ``os.replace``, so a killed write never leaves a half file under
the real name. Pruning joins that thread before it deletes a directory.
The JAX package's ``train-state.msgpack`` cannot be read here.
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


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Read a state written by :func:`save_train_state` onto the device of
    ``template``, whose parameter tree it must match."""
    if not os.path.isfile(path):
        jax_state = os.path.join(os.path.dirname(path), _JAX_STATE_FILE)
        if os.path.isfile(jax_state):
            raise NotImplementedError(
                f"{jax_state} is the JAX package's train state; reading it "
                "is not ported yet (ROADMAP.md Queue 1 item 2)"
            )
        raise FileNotFoundError(f"train state not found: {path}")
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
        not count; one with the JAX package's state does, and loading it
        then says that it cannot be read."""
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
