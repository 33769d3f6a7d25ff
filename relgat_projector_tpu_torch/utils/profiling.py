"""Profiling hooks (port of ``relgat_projector_tpu/utils/profiling.py``).

``trace(log_dir)`` records ``torch.profiler`` (host, and the card's kernels
where a card is present) for the body of a ``with`` block and writes a
Chrome trace into ``log_dir`` when the block ends (TensorBoard's profiler
plugin reads that directory); with ``log_dir=None`` it does nothing.

``span(name)`` marks a layer of the train step as a range of whatever
``torch.profiler`` session is open (``trace``'s, a benchmark's, an
operator's own), on the profiler's clock; with no profiler open it enters
nothing. The step's spans, each named ``relgat/<layer>``:

    relgat/step                 train/step.py: the whole train step
      relgat/forward            the training forward and loss
        relgat/gat_layer        models/model.py: one GAT layer (its random
                                draws, output dropout and the ELU after it)
          relgat/project        models/layer.py: the layer's projection
          relgat/propagate      models/layer.py: the propagate call
        relgat/head             models/projection.py: the projection head
        relgat/score            train/step.py: gathers, negatives, scorer, loss
      relgat/backward           the autograd.grad call
      relgat/optimizer          Adam, the non-finite select, grad norm, lr
      relgat/score              the step's MRR and hits

A span is a FUNCTION-scope range (``_RecordFunctionFast``), not
``record_function``'s USER scope: the profiler copies every USER-scope
range onto the device's timeline as a device event of the same name, which
would read as device time in anything that sums a trace's device events.

``device_time_by_span(prof)`` and ``idle_by_span(prof)`` read a finished
profile by those spans (``device_ops`` and ``host_ops`` give the single
operations): a device operation belongs to the innermost ``relgat/`` span
enclosing its launch (the runtime call that shares the operation's
correlation id) on the launching thread. The backward runs on autograd's
own thread, outside every span of the forward: there an operation belongs
to the span of the forward operation that made its autograd node (the
``sequence_nr`` and forward thread the profiler records on the node and on
that operation). An operation no span claims is counted under
``UNATTRIBUTED``, never dropped.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "relgat/"
STEP = PREFIX + "step"
PHASES = {PREFIX + "forward": "forward", PREFIX + "backward": "backward",
          PREFIX + "optimizer": "optimizer"}
UNATTRIBUTED = "unattributed"
OUTSIDE_STEP = "outside the step"
_EVALUATE = "autograd::engine::evaluate_function: "
_BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(
    log_dir: Optional[str], *, worker_name: Optional[str] = None
) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` context writing ``log_dir/<worker_name>.*.pt.
    trace.json``; yields the profiler (for ``key_averages()`` and the
    readers below), or None and records nothing when ``log_dir`` is None."""
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


def span(name: str):
    """A range named ``name`` in the open profiler session; the shared
    no-op context when no profiler is open (one C call, no range)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


# ---------------------------------------------------------------------------
# Reading a profile by span
# ---------------------------------------------------------------------------

class SpanOp(NamedTuple):
    """One operation of a profile: its name, the span that claims it (or
    ``UNATTRIBUTED``), its phase (``forward``, ``backward``, ``optimizer``,
    or ``other`` for the rest of the step and anything outside it), its
    start (ns on the profiler's clock) and its seconds."""

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
        operation it is linked to."""
        calls = [c for c in self.launch.get((op.corr, op.link), [])
                 if c.start <= op.start]
        if not calls and op.link > 0:
            calls = [o for o in self.ops_by_id.get(op.link, [])
                     if o.start <= op.start]
        if not calls:
            return None
        call = max(calls, key=lambda c: c.start)
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


def host_ops(prof) -> List[SpanOp]:
    """Every host operation but the spans (aten operations, autograd
    nodes, runtime calls), with the span and phase that claim it and its
    seconds on the host: what a CPU profile has, in start order."""
    events = _events(prof)
    timeline = _Timeline(events)
    return [SpanOp(e.name, *timeline.claim(e.thread, e.start), e.start,
                   (e.end - e.start) / 1e9)
            for e in sorted(events, key=lambda e: e.start)
            if not e.device and not e.name.startswith(PREFIX)]


def _summed(rows) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key, seconds in rows:
        out[key] = out.get(key, 0.0) + seconds
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def device_time_by_span(prof) -> Dict[str, float]:
    """Device seconds of a finished profile by the innermost span that
    claims them (``UNATTRIBUTED`` for the rest), longest first; they sum
    to the profile's device time."""
    return _summed((op.span, op.seconds) for op in device_ops(prof))


def idle_by_span(prof) -> Dict[str, float]:
    """Seconds the device sat idle between its operations, by the
    innermost span the stepping thread (the one that ran ``relgat/step``)
    was in at each gap's middle (``OUTSIDE_STEP`` when it was outside
    every step), longest first."""
    events = _events(prof)
    timeline = _Timeline(events)
    threads = [e.thread for e in events if not e.device and e.name == STEP]
    main = max(set(threads), key=threads.count, default=None)
    busy: List[List[int]] = []
    for a, b in sorted((e.start, e.end) for e in events if e.device):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    rows = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        chain = timeline.chain(main, (end + start) // 2)
        spans = [m.name for m in chain if m.name.startswith(PREFIX)]
        label = spans[0] if STEP in spans else OUTSIDE_STEP
        rows.append((label, (start - end) / 1e9))
    return _summed(rows)
