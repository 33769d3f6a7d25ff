"""The port's profiling hooks against the JAX package's ``utils/profiling.py``.

``trace(None)`` records nothing and yields None; ``trace(dir)`` records
``torch.profiler`` over the block and writes a Chrome trace into ``dir``
(here on the CPU). ``StepTimer.lap`` returns ``(seconds since the last lap,
edges_per_step / seconds)``, checked on a fixed clock against the JAX
package's timer on the same clock.
"""

import json
import time

import pytest
import torch

from relgat_projector_tpu.utils import profiling as jax_profiling
from relgat_projector_tpu_torch.utils import profiling


def test_trace_none_is_a_no_op():
    with profiling.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), worker_name="w") as prof:
        (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    assert any("mm" in evt.key for evt in prof.key_averages())
    (path,) = list(tmp_path.glob("w.*.pt.trace.json"))
    assert json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("ticks", [(10.0, 10.5, 12.5), (3.0, 3.0, 7.0)])
def test_step_timer_arithmetic_matches_jax(monkeypatch, ticks):
    laps = {}
    for name, mod in (("port", profiling), ("jax", jax_profiling)):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(edges_per_step=1000)
        laps[name] = [timer.lap(), timer.lap()]
    assert laps["port"] == laps["jax"]
    first, second = laps["port"]
    assert first == (ticks[1] - ticks[0],
                     1000 / (ticks[1] - ticks[0]) if ticks[1] > ticks[0]
                     else 0.0)
    assert second == (ticks[2] - ticks[1], 1000 / (ticks[2] - ticks[1]))
