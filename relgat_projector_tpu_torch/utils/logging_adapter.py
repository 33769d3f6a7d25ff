"""Console + optional Weights & Biases metric logging.

Parity with reference ``utils/logging_adapter.py:9-83``: fan-out to console
and W&B, auto run-name ``{prefix}-{YYYYMMDD_HHMMSS}``, ``log_every_n_steps``
held here. W&B is optional and gated behind an import guard: without the
``wandb`` package (or offline) the adapter logs to the console only."""

from __future__ import annotations

import json
from datetime import datetime
from typing import Any, Dict, Optional


class LoggerAdapter:
    def __init__(
        self,
        run_name: Optional[str] = None,
        architecture_name: Optional[str] = None,
        base_model_name: Optional[str] = "relgat",
        log_every_n_steps: int = 100,
        log_to_wandb: bool = False,
        log_to_console: bool = True,
        wandb_project: str = "relgat-tpu",
        wandb_tags: tuple = ("relgat", "link-prediction", "cuda"),
        run_config: Optional[Dict[str, Any]] = None,
    ):
        self.log_to_wandb = log_to_wandb
        self.log_to_console = log_to_console
        self.wandb_project = wandb_project
        self.wandb_tags = list(wandb_tags)
        self.run_config = run_config or {}
        self._wandb = None

        if log_every_n_steps is None or int(log_every_n_steps) < 0:
            self.log_every_n_steps = 1
        else:
            self.log_every_n_steps = int(log_every_n_steps)

        # Auto run-name (reference ``logging_adapter.py:42-60``).
        if run_name and run_name.strip():
            prefix = run_name.strip()
        else:
            prefix = ""
            if base_model_name:
                prefix = base_model_name.strip() + "-"
            prefix += architecture_name if architecture_name else "run"
        self.run_name = f"{prefix}-{datetime.now().strftime('%Y%m%d_%H%M%S')}"

    def init_wandb_if_needed(self) -> None:
        if not self.log_to_wandb:
            return
        try:
            import wandb

            self._wandb = wandb
            wandb.init(
                project=self.wandb_project,
                name=self.run_name,
                tags=self.wandb_tags,
                config=self.run_config,
            )
        except Exception as exc:  # offline / missing package: degrade quietly
            print(f"[logger] W&B unavailable ({exc}); console only.")
            self.log_to_wandb = False
            self._wandb = None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self.log_to_wandb and self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.log_to_console:
            payload = json.dumps(metrics, indent=2, ensure_ascii=False, default=float)
            print(f"[{self.run_name}] Step {step}:\n{payload}")

    def finish_wandb_if_needed(self) -> None:
        if self.log_to_wandb and self._wandb is not None:
            self._wandb.finish()
