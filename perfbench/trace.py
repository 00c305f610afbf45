"""Reduce a ``torch.profiler`` trace of a run's traced segment.

The device is busy where at least one operation (a kernel, a copy or a
memset) runs: the union of their intervals, not the sum of their times, so
overlapping operations count once.  The segment is the span of the
benchmark's ``perfbench.segment`` annotation.  Each idle gap is labelled
with what the host was doing at its middle: the innermost host operation
or benchmark annotation of the calling thread that covers it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SEGMENT = "perfbench.segment"
DEVICE_KINDS = frozenset({"kernel"})
HOST_KINDS = frozenset({"cpu_op", "user_annotation"})
TOP = 10


def _short(name: str) -> str:
    """A kernel's or operation's name without namespace, template
    arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:96]


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kind(e) -> str:
    """The event's kind, from its device and its annotation flag: on the
    card, a device event that is not an annotation is a kernel, a copy or
    a memset (all "kernel" here); the benchmark's annotations are named
    ``perfbench.*`` on both timelines."""
    ann = e.is_user_annotation() or e.name().startswith("perfbench.")
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if ann else "kernel"
    return "user_annotation" if ann else "cpu_op"


def span(e) -> tuple[int, int]:
    """(start, end) of an event in nanoseconds."""
    start = e.start_ns()
    return start, start + e.duration_ns()


def _host_tree(host: list[tuple[int, int, str]]):
    """Host events sorted by start (an enclosing event before the events it
    holds) with each one's parent index (-1 for none)."""
    host.sort(key=lambda h: (h[0], -h[1]))
    parent, stack = [], []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] < e:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return host, parent


def _label(t: int, host, starts, parent) -> str:
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and host[i][1] < t:
        i = parent[i]
    return _short(host[i][2]) if i >= 0 else "host (no operation)"


def reduce_events(events) -> dict | None:
    """``busy_s``, ``window_s`` and the top device operations and idle gaps
    of the segment, from the profiler's raw (kineto) events; None where
    the trace holds no segment or no device operation."""
    seg = [e for e in events if e.name() == SEGMENT
           and kind(e) == "user_annotation"]
    if not seg:
        return None
    s0, s1 = span(seg[0])
    tid = seg[0].start_thread_id()
    dev, host = [], []
    by_op: dict[str, int] = defaultdict(int)
    for e in events:
        k = kind(e)
        start, end = span(e)
        if k in DEVICE_KINDS:
            s, t = max(start, s0), min(end, s1)
            if t > s:
                dev.append((s, t))
                by_op[_short(e.name())] += t - s
        elif k in HOST_KINDS and e.start_thread_id() == tid \
                and e.name() != SEGMENT:
            host.append((start, end, e.name()))
    if not dev:
        return None
    busy = union(dev)
    host, parent = _host_tree(host)
    starts = [h[0] for h in host]
    gaps: dict[str, int] = defaultdict(int)
    t = s0
    for s, e in busy + [(s1, s1)]:
        if s > t:
            gaps[_label((t + s) // 2, host, starts, parent)] += s - t
        t = max(t, e)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (s1 - s0) / 1e9,
            "device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


def reduce_profile(prof) -> dict | None:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    return reduce_events(prof.profiler.kineto_results.events())
