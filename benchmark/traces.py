"""What the harness reads from a traced run: the device's operations from a
``torch.profiler`` trace of CUDA activity alone, the traced passes' bounds
from the marker kernels the harness launches at each traced pass's start
and after the last, and the program's host ranges (read on the host clock,
see ``HostSpans``) moved onto the trace's clock by the markers; nanoseconds.

The profiler records no CPU operation: recording each of the host loop's
tens of thousands of operations a pass about doubled a pass's time."""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys
import time

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # the kernel of ``torch.cuda._sleep``, which the program never launches
RANGES = ("owlpt.",)  # the program's profiler ranges


@dataclasses.dataclass
class Trace:
    device_ops: list  # (activity, name, start_ns, end_ns) of every kernel, copy and set on the device
    ranges: list  # (name, start_ns, end_ns) of the host's ranges, on the trace's clock
    passes: list  # (start_ns, end_ns) of each traced pass

    @property
    def window_ns(self) -> int:
        return self.passes[-1][1] - self.passes[0][0]

    def kernels(self, lo: int = None, hi: int = None) -> list:
        lo = self.passes[0][0] if lo is None else lo
        hi = self.passes[-1][1] if hi is None else hi
        return [op for op in self.device_ops if op[0] == "kernel" and lo <= op[2] < hi]

    def busy_intervals(self) -> list:
        """The union of the device's operations inside the window, merged."""
        lo, hi = self.passes[0][0], self.passes[-1][1]
        spans = sorted((max(s, lo), min(e, hi)) for _, _, s, e in self.device_ops if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())


class HostSpans:
    """The program's ``owlpt.*`` ranges on the host clock while open: a wrap
    of ``record_function``'s enter and exit (the class the program's
    ``torch.profiler.record_function`` is), restored on close.  No profiler
    needs to run: ``spans`` gets (name, start_ns, end_ns) of
    ``time.perf_counter_ns``."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        from torch.autograd import profiler

        cls = self.cls = profiler.record_function
        enter, exit_ = self.saved = cls.__enter__, cls.__exit__
        spans, clock = self.spans, time.perf_counter_ns

        def timed_enter(rf):
            rf.bench_t0 = clock()
            return enter(rf)

        def timed_exit(rf, *exc):
            out = exit_(rf, *exc)
            if rf.name.startswith(RANGES):
                spans.append((rf.name, rf.bench_t0, clock()))
            return out

        cls.__enter__, cls.__exit__ = timed_enter, timed_exit
        return self

    def __exit__(self, *exc):
        self.cls.__enter__, self.cls.__exit__ = self.saved


def mark():
    """A marker kernel on the device -> the host time it was launched."""
    import torch

    t = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return t


def from_profiler(prof, host_marks: list, host_spans: list) -> Trace | None:
    """The trace of a finished ``torch.profiler.profile``: ``host_marks``
    are the host times of the markers (one at each traced pass's start and
    one after the last), ``host_spans`` the host ranges; None where fewer
    than two markers are found."""
    ops, markers = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind not in DEVICE_KINDS:
            continue
        op = (kind, ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        (markers if MARKER in op[1] else ops).append(op)
    device = sorted(m[2] for m in markers)
    if len(device) == len(host_marks) >= 2:
        got = device
    else:
        # the profiler starts just before the first pass: its earliest event lies by the first mark
        got = match(device, host_marks, min(o[2] for o in ops + markers) if ops or markers else None)
        found = sum(g is not None for g in got) if got else 0
        print(f"benchmark: {found} of the {len(host_marks)} pass markers launched found among the trace's "
              f"{len(markers)}" + ("" if got else ": no trace read") + f"; markers at "
              f"{[d - device[0] for d in device]} ns, launched at {[h - host_marks[0] for h in host_marks]} ns",
              file=sys.stderr)
        if got is None:
            return None
    to_trace = clock_line([(h, g) for h, g in zip(host_marks, got) if g is not None])
    starts = [g if g is not None else to_trace(h) for g, h in zip(got, host_marks)]
    ranges = [(name, to_trace(s), to_trace(e)) for name, s, e in host_spans]
    return Trace(device_ops=sorted(ops, key=lambda o: o[2]), ranges=ranges, passes=list(zip(starts, starts[1:])))


def clock_line(pairs: list):
    """The map from host to trace times: the least-squares line through the
    (host, trace) pairs of the markers.  The trace's clock may run a percent
    or so off the host's, and the first marker starts some milliseconds
    late, while the profiler warms up: it is left out where three or more
    markers are found."""
    if len(pairs) >= 3:
        pairs = pairs[1:]
    n = len(pairs)
    hm = sum(h for h, _ in pairs) / n
    gm = sum(g for _, g in pairs) / n
    slope = sum((h - hm) * (g - gm) for h, g in pairs) / sum((h - hm) ** 2 for h, _ in pairs)
    h_ref, g_ref = pairs[0]
    off = gm - g_ref - slope * (hm - h_ref)
    return lambda t: g_ref + round(slope * (t - h_ref) + off)


def match(device: list, host: list, earliest: int | None, tol: int = 10_000_000, rate: float = 0.03):
    """Where markers are lost: the device start of each host mark, or None
    where its marker is lost; None where fewer than two match.  Host marks
    lie a pass apart.  The pairing is the one under which most markers lie
    within ``tol`` plus ``rate`` of their distance from the pairing's own
    mark, the nearest first, and of those the one that puts the first mark
    nearest the ``earliest`` device event (a shift by whole passes can
    match as many)."""
    best = None
    for d0 in device[:3]:
        for h0 in host[:3]:
            got = [_nearest(device, h + d0 - h0, tol + rate * abs(h - h0)) for h in host]
            n = sum(g is not None for g in got)
            if n < 2:
                continue
            key = (n, -abs(earliest - host[0] - d0 + h0) if earliest is not None else 0)
            if best is None or key > best[0]:
                best = (key, got)
    return best[1] if best else None


def _nearest(sorted_times: list, t: float, tol: int):
    i = bisect.bisect_left(sorted_times, t)
    near = [x for x in sorted_times[max(i - 1, 0):i + 1] if abs(x - t) <= tol]
    return min(near, key=lambda x: abs(x - t)) if near else None


def _kind(ev) -> str:
    """The event's kineto activity: the event says so where this torch's
    events have ``activity_type``; else it is read from the device and the
    name (a device event named as a range is the range's device copy)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if str(ev.device_type()).endswith("CUDA"):
        if name.startswith(RANGES):
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "user_annotation" if name.startswith(RANGES) else "cpu_op"


def union_ns(spans: list) -> int:
    """Length of the union of (start, end) spans (nested ranges count once)."""
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps of the device by the innermost host range open at their start."""
    by_name = collections.Counter()
    for _, name, s, e in trace.device_ops:
        by_name[name] += (e - s) / 1e9
    busy = trace.busy_intervals()
    edges = [(trace.passes[0][0], trace.passes[0][0])] + [tuple(b) for b in busy] + [(trace.passes[-1][1],) * 2]
    gaps = [(end, start - end) for (_, end), (start, _) in zip(edges, edges[1:]) if start > end]
    by_range = collections.Counter()
    for (t, length), name in zip(gaps, innermost(trace.ranges, [t for t, _ in gaps])):
        by_range[name] += length / 1e9
    return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_range.most_common(top)]}


def innermost(ranges: list, times: list) -> list:
    """For each of the ascending ``times``, the innermost host range open
    then (ranges nest), or "(no range)"."""
    events = sorted([(s, 1, -e, name) for name, s, e in ranges] + [(e, 0, 0, name) for name, s, e in ranges])
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            at, opens, _, name = events[i]
            if opens:
                stack.append((name, at))
            elif name in (n for n, _ in stack):
                j = max(k for k, (n, _) in enumerate(stack) if n == name)
                del stack[j]
            i += 1
        out.append(stack[-1][0] if stack else "(no range)")
    return out
