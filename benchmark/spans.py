"""Device time of a ``torch.profiler`` trace by the program's spans.

A frozen copy of ``relgat_projector_tpu_torch/utils/profiling.py``'s
``device_ops`` and ``device_time_by_span``, so that a later change to the
program cannot move the yardstick; only the span names (``relgat/...``)
come from the program. It differs in one point: an operation whose launch
the trace places after the operation's own start still finds its launch
(``_Timeline.launch_point``). A device operation belongs to the innermost
``relgat/`` span enclosing its launch (the runtime call that shares the
operation's correlation id) on the launching thread. The backward runs on
autograd's own thread, outside every span of the forward: there an
operation belongs to the span of the forward operation that made its
autograd node (the ``sequence_nr`` and forward thread the profiler records
on the node and on that operation). An operation no span claims is counted
under ``UNATTRIBUTED``, never dropped.

The step's spans: ``relgat/step`` around ``relgat/forward`` (each
``relgat/gat_layer`` with its ``relgat/project`` and ``relgat/propagate``,
then ``relgat/head`` and ``relgat/score``), ``relgat/backward``,
``relgat/optimizer`` and ``relgat/score``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

PREFIX = "relgat/"
PHASES = {PREFIX + "forward": "forward", PREFIX + "backward": "backward",
          PREFIX + "optimizer": "optimizer"}
UNATTRIBUTED = "unattributed"
_EVALUATE = "autograd::engine::evaluate_function: "
_BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION


class SpanOp(NamedTuple):
    """One device operation: its name, the span that claims it (or
    ``UNATTRIBUTED``), its phase (``forward``, ``backward``, ``optimizer``,
    or ``other``), its start (ns on the profiler's clock) and its
    seconds."""

    name: str
    span: str
    phase: str
    start_ns: int
    seconds: float


class _Event(NamedTuple):
    name: str
    device: bool
    start: int
    end: int
    thread: int
    corr: int
    link: int
    seq: int
    fwd_thread: int
    scope: int


def _events(prof) -> List[_Event]:
    results = getattr(getattr(prof, "profiler", prof), "kineto_results", None)
    if results is None:
        raise ValueError("no finished torch.profiler results to read")
    out = []
    for e in results.events():
        if e.is_user_annotation() and e.device_type().name != "CPU":
            continue  # a USER-scope range's copy on the device timeline
        if e.start_thread_id() != e.end_thread_id() or e.is_async():
            continue
        out.append(_Event(e.name(), e.device_type().name != "CPU",
                          e.start_ns(), e.end_ns(), e.start_thread_id(),
                          e.correlation_id(), e.linked_correlation_id(),
                          e.sequence_nr(), e.fwd_thread_id(), e.scope()))
    return out


def _is_node(e: _Event) -> bool:
    """An autograd node's run (or the engine's frame around it), which
    carries its node's sequence number and forward thread."""
    return e.scope == _BACKWARD_SCOPE or e.name.startswith(_EVALUATE)


class _Timeline:
    """The spans and autograd nodes of every host thread, nested, and the
    forward operations by ``(sequence_nr, thread)``."""

    def __init__(self, events: List[_Event]):
        host = [e for e in events if not e.device]
        self.marks: Dict[int, List[_Event]] = {}
        for e in host:
            if e.name.startswith(PREFIX) or _is_node(e):
                self.marks.setdefault(e.thread, []).append(e)
        self.starts: Dict[int, List[int]] = {}
        self.parent: Dict[int, List[int]] = {}  # index of the parent, or -1
        for thread, ms in self.marks.items():
            ms.sort(key=lambda e: (e.start, -e.end))
            parent, stack = [], []
            for i, e in enumerate(ms):
                while stack and ms[stack[-1]].end < e.end:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.starts[thread] = [e.start for e in ms]
            self.parent[thread] = parent
        self.fwd: Dict[Tuple[int, int], List[_Event]] = {}
        for e in sorted(host, key=lambda e: e.start):
            if e.seq >= 0 and not _is_node(e):
                self.fwd.setdefault((e.seq, e.thread), []).append(e)
        self.ops_by_id: Dict[int, List[_Event]] = {}
        self.launch: Dict[Tuple[int, int], List[_Event]] = {}
        for e in host:
            if e.link == 0:
                self.ops_by_id.setdefault(e.corr, []).append(e)
            self.launch.setdefault((e.corr, e.link), []).append(e)

    def chain(self, thread: int, t: int) -> List[_Event]:
        """The spans and nodes enclosing time ``t`` on ``thread``,
        innermost first."""
        marks = self.marks.get(thread, [])
        parent = self.parent.get(thread, [])
        i = bisect.bisect_right(self.starts.get(thread, []), t) - 1
        while i >= 0 and marks[i].end < t:
            i = parent[i]
        out = []
        while i >= 0:
            out.append(marks[i])
            i = parent[i]
        return out

    def forward_span(self, node: _Event) -> Optional[str]:
        """The innermost span around the forward operation that made
        ``node``: the last operation on the forward thread to record the
        node's sequence number before the node ran."""
        ops = [o for o in self.fwd.get((node.seq, node.fwd_thread), [])
               if o.start < node.start]
        if not ops:
            return None
        for m in self.chain(ops[-1].thread, ops[-1].start):
            if m.name.startswith(PREFIX):
                return m.name
        return None

    def claim(self, thread: int, t: int) -> Tuple[str, str]:
        """``(span, phase)`` of an operation launched at ``t`` on ``thread``:
        the innermost span around it, or, where an autograd node encloses
        it first, the span of the node's forward operation."""
        chain = self.chain(thread, t)
        name = None
        for m in chain:
            if _is_node(m):
                name = self.forward_span(m) if m.seq >= 0 else None
                break
            if m.name.startswith(PREFIX):
                name = m.name
                break
        if any(_is_node(m) for m in chain):
            phase = "backward"
        else:
            phase = next((PHASES[m.name] for m in chain if m.name in PHASES),
                         "other")
        return name or UNATTRIBUTED, phase

    def launch_point(self, op: _Event) -> Optional[Tuple[int, int]]:
        """Thread and time of a device operation's launch: its runtime
        call (same correlation id and linked operation), else the host
        operation it is linked to; the latest that starts by the
        operation's start, else the earliest after it. (The device's
        clock, mapped onto the host's, can place an operation before its
        own launch: by ~15 us on autograd's thread and by up to ~1 ms at
        a trace's start on an H100, which ``utils/profiling.py`` leaves
        unattributed.)"""
        calls = self.launch.get((op.corr, op.link), [])
        if not calls and op.link > 0:
            calls = self.ops_by_id.get(op.link, [])
        if not calls:
            return None
        before = [c for c in calls if c.start <= op.start]
        call = (max(before, key=lambda c: c.start) if before
                else min(calls, key=lambda c: c.start))
        return call.thread, call.start


def device_ops(prof) -> List[SpanOp]:
    """Every device operation (kernel, copy, set) of a finished profile,
    with the span and phase that claim it, in start order."""
    events = _events(prof)
    timeline = _Timeline(events)
    out = []
    for op in sorted((e for e in events if e.device), key=lambda e: e.start):
        where = timeline.launch_point(op)
        if where is None:
            name, phase = UNATTRIBUTED, "other"
        else:
            name, phase = timeline.claim(*where)
        out.append(SpanOp(op.name, name, phase, op.start,
                          (op.end - op.start) / 1e9))
    return out


def device_time_by_span(prof) -> Dict[str, float]:
    """Device seconds of a finished profile by the innermost span that
    claims them (``UNATTRIBUTED`` for the rest), longest first; they sum
    to the profile's device time."""
    out: Dict[str, float] = {}
    for op in device_ops(prof):
        out[op.span] = out.get(op.span, 0.0) + op.seconds
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def ms_a_step(run, names: Iterable[str]) -> Optional[float]:
    """Device milliseconds a traced step under the spans ``names`` (each
    operation under its innermost span), for a metric's reader: None
    without a traced profile, or where none of them holds device time.
    The split by span is made once a traced record, by its first reader,
    and kept in the record (``by_span``) for the others."""
    if run.trace is None or run.trace.get("profile") is None:
        return None
    if "by_span" not in run.trace:
        run.trace["by_span"] = device_time_by_span(run.trace["profile"])
    by_span = run.trace["by_span"]
    seconds = sum(by_span.get(name, 0.0) for name in names)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.trace["steps"]
