"""Reading a ``torch.profiler`` trace of the card into plain records, and
the arithmetic on them: the union of device intervals, device time by
kernel name and under host ranges, and the idle gaps with what the host
was doing in each.

The trace is read from its raw events, as the profiler links them: a
device activity belongs to the host events whose correlation id is its
linked one (the op, or the runtime call, that launched it), and to a host
range where one of those starts inside the range on the same thread.
(``key_averages()`` counts an activity once for each host event of its id,
so a range read that way can hold more than the card did.)
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field

# the host range the benchmark puts around the traced steps or batches
WINDOW_RANGE = "gpubench.window"

# kernel names of cuBLAS's matrix products on the card
MATMUL_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_", "cublas")


@dataclass
class Activity:
    """A device activity (kernel, copy or set)."""
    name: str
    start: int                  # ns, the trace's clock
    end: int
    hosts: tuple = ()           # (thread, start ns) of the host events that launched it


@dataclass
class Trace:
    activities: list[Activity]
    # host ranges by name: sorted (thread, start ns, end ns)
    ranges: dict[str, list[tuple]] = field(default_factory=dict)
    # host ops on the launching thread: (start ns, end ns, name), sorted
    host_ops: list[tuple] = field(default_factory=list)

    def window(self) -> tuple[int, int] | None:
        """(start, end) ns of the benchmark's traced window, if recorded."""
        found = self.ranges.get(WINDOW_RANGE)
        if not found:
            return None
        return min(r[1] for r in found), max(r[2] for r in found)


def read(prof, range_names=()) -> Trace:
    """A finished ``torch.profiler.profile``'s events as a ``Trace``; host
    ranges named in ``range_names`` (and the window) are kept."""
    from torch.autograd import DeviceType

    names = {WINDOW_RANGE, *range_names}
    ranges: dict[str, list[tuple]] = {n: [] for n in names}
    launched_by: dict[int, list[tuple]] = {}
    host_ops: list[tuple] = []
    raw = []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CPU:
            if evt.name() in ranges:
                ranges[evt.name()].append((evt.start_thread_id(),
                                           evt.start_ns(), evt.end_ns()))
                continue
            if evt.linked_correlation_id() == 0:
                launched_by.setdefault(evt.correlation_id(), []).append(
                    (evt.start_thread_id(), evt.start_ns()))
            host_ops.append((evt.start_ns(), evt.end_ns(), evt.name()))
        elif evt.name() not in ranges and evt.duration_ns() > 0:
            raw.append(evt)
    acts = [Activity(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     tuple(launched_by.get(e.linked_correlation_id(), ())))
            for e in raw]
    for found in ranges.values():
        found.sort()
    host_ops.sort()
    return Trace(acts, ranges, host_ops)


def clip(acts: list[Activity], lo: int, hi: int) -> list[tuple[int, int]]:
    """Each activity's interval cut to [lo, hi]; empty ones dropped."""
    out = []
    for a in acts:
        s, e = max(a.start, lo), min(a.end, hi)
        if e > s:
            out.append((s, e))
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of intervals as disjoint sorted intervals: overlapping
    kernels (two streams, a copy beside a kernel) count once."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in union(intervals))


def in_window(tr: Trace) -> tuple[list[Activity], int, int] | None:
    """The activities that overlap the traced window, and its bounds."""
    w = tr.window()
    if w is None:
        return None
    lo, hi = w
    return [a for a in tr.activities if a.end > lo and a.start < hi], lo, hi


def _inside(found: list[tuple], host: tuple) -> bool:
    i = bisect.bisect_right(found, (host[0], host[1], math.inf)) - 1
    return i >= 0 and found[i][0] == host[0] and found[i][2] >= host[1]


def launched_in(tr: Trace, range_name: str, acts: list[Activity]
                ) -> list[Activity]:
    """The activities of ``acts`` launched from inside host range
    ``range_name`` (none where the trace has no such range)."""
    found = tr.ranges.get(range_name) or []
    if not found:
        return []
    return [a for a in acts if any(_inside(found, h) for h in a.hosts)]


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(mark in low for mark in MATMUL_MARKS)


def seconds_by_name(acts: list[Activity]) -> dict[str, float]:
    out: dict[str, float] = {}
    for a in acts:
        out[a.name] = out.get(a.name, 0.0) + (a.end - a.start) / 1e9
    return out


def idle_gaps(tr: Trace, acts: list[Activity], lo: int, hi: int,
              top: int = 10) -> list[list]:
    """The window's idle time on the card, summed by the innermost host op
    running where each gap starts ("host idle" where none is): the
    longest ``top`` as [name, seconds]."""
    busy = union(clip(acts, lo, hi))
    gaps = []
    at = lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    starts = [op[0] for op in tr.host_ops]
    by_op: dict[str, float] = {}
    for s, e in gaps:
        # the host ops that began before the gap and had not ended: the
        # innermost is the one that began last
        i = bisect.bisect_right(starts, s) - 1
        name = "host idle"
        for j in range(i, max(i - 4096, -1), -1):
            if tr.host_ops[j][1] > s:
                name = tr.host_ops[j][2]
                break
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    return [[n, v] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])
            [:top]]


def breakdown(tr: Trace, acts: list[Activity], lo: int, hi: int,
              top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each as [name, seconds]."""
    ops = sorted(seconds_by_name(acts).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n[:200], v] for n, v in
                          idle_gaps(tr, acts, lo, hi, top)]}
