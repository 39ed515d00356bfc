"""Share of a pass, in %, with no kernel, copy or set on the card: the
card's busy time per profiled pass (from the trace; the card's work does
not change under the profiler) over the mean host time of the passes before
the profiler started (a profiled pass pays the profiler's cost on every
launch, and runs far longer)."""


def read(r):
    t, h = r.trace, r.host
    if t is None or not t.passes or not t.device_ops or h is None or h.read[1] <= h.read[0]:
        return None
    lo, hi = h.read
    busy_s = t.busy_ns() / 1e9 / len(t.passes)
    return 100.0 * (1.0 - busy_s / (sum(r.pass_s[lo:hi]) / (hi - lo)))
