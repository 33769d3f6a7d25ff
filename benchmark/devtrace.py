"""Reading a ``torch.profiler`` trace of a few steps.

Device time is grouped by kernel name as ``chip_smoke.py:profile_steps``
groups it (a frozen copy): names holding ``relgat`` are the propagate
kernels, names holding ``gemm``, ``cutlass``, ``sm90_`` or ``nvjet`` the
matrix products, and everything else that ran on the device (elementwise
kernels, reductions, casts, copies) the rest. Busy time is the union of
the device's operation intervals; the idle gaps between them are
labelled by the innermost host operation running at each gap's middle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

GROUPS = ("propagate", "gemm", "other")
_GEMM_KEYS = ("gemm", "cutlass", "sm90_", "nvjet")
_WALK = 4096  # host operations looked back over for a gap's label


def group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    if "relgat" in low:
        return "propagate"
    if any(k in low for k in _GEMM_KEYS):
        return "gemm"
    return "other"


def _is_device(evt) -> bool:
    kind = getattr(evt, "device_type", None)
    return kind is not None and kind.name == "CUDA"


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_time_by_kernel(prof) -> List[Tuple[str, float]]:
    """``(kernel name, seconds)`` of every device operation in the trace,
    longest first."""
    rows = [(evt.key, _self_device_us(evt) / 1e6)
            for evt in prof.key_averages() if _is_device(evt)]
    return sorted(rows, key=lambda r: -r[1])


def grouped_seconds(kernels: List[Tuple[str, float]]) -> Dict[str, float]:
    out = dict.fromkeys(GROUPS, 0.0)
    for name, s in kernels:
        out[group_of(name)] += s
    return out


def _intervals(events) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` microsecond intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_and_gaps(prof) -> Tuple[float, List[Tuple[str, float]]]:
    """Seconds in which some device operation ran, and the idle time
    between the first and last of them summed by the host operation that
    ran at each gap's middle (``host (between ops)`` where none did),
    longest first."""
    events = list(prof.events())
    busy = _intervals([e for e in events if _is_device(e)])
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e))
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        label = "host (between ops)"
        # Host operations nest, so the innermost one running at ``mid`` is
        # the latest started that has not ended.
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - _WALK), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return busy_s, sorted(gaps.items(), key=lambda r: -r[1])
