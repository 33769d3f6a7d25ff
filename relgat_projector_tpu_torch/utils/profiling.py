"""Profiling hooks (port of ``relgat_projector_tpu/utils/profiling.py``).

``trace(log_dir)`` records ``torch.profiler`` (host, and the card's kernels
where a card is present) for the body of a ``with`` block and writes a
Chrome trace into ``log_dir`` when the block ends (TensorBoard's profiler
plugin reads that directory); with ``log_dir=None`` it does nothing.
``StepTimer`` gives wall-clock step times and edge-messages/s without
waiting for the card: the caller decides where results are forced.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(
    log_dir: Optional[str], *, worker_name: Optional[str] = None
) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` context writing ``log_dir/<worker_name>.*.pt.
    trace.json``; yields the profiler (for ``key_averages()``), or None and
    records nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            str(log_dir), worker_name=worker_name
        ),
    ) as prof:
        yield prof


class StepTimer:
    """Wall-clock step timing and the edge-messages/s it implies."""

    def __init__(self, edges_per_step: int):
        self.edges_per_step = int(edges_per_step)
        self._t0 = time.perf_counter()

    def lap(self) -> tuple:
        """``(step_time_s, edges_per_sec)`` since the last lap."""
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt, (self.edges_per_step / dt if dt > 0 else 0.0)
