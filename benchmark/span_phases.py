"""Device time of a traced record by span and phase, for the readers that
split a span into its forward and its backward.

It reads the frozen attribution of ``benchmark/spans.py``: each device
operation's innermost span and its phase (``forward``, ``backward``,
``optimizer`` or ``other``; an operation on autograd's thread is
``backward`` and belongs to its forward operation's span). The split is
made once a traced record, by its first reader, and kept in the record
(``by_span_phase``) for the others.
"""

from __future__ import annotations

from typing import Optional

from benchmark import spans


def ms_a_step(run, span: str, phase: str) -> Optional[float]:
    """Device milliseconds a traced step under ``span`` in ``phase``: None
    without a traced profile, or where that span and phase hold no device
    time."""
    if run.trace is None or run.trace.get("profile") is None:
        return None
    if "by_span_phase" not in run.trace:
        split = {}
        for op in spans.device_ops(run.trace["profile"]):
            key = (op.span, op.phase)
            split[key] = split.get(key, 0.0) + op.seconds
        run.trace["by_span_phase"] = split
    seconds = run.trace["by_span_phase"].get((span, phase), 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.trace["steps"]
