"""Host time inside the program's host-loop ranges per pass, in ms: the
union of ``owlpt.frame`` (a frame's set-up), ``owlpt.bank`` and
``owlpt.regen`` (the wavefront's banking and regeneration) and
``owlpt.film`` (the scan's accumulation), their operations and syncs
included, on the host clock over the passes before any device profiler
ran.  None where the passes open no ``owlpt.step`` range: the program does
not mark its host loop."""
from benchmark.traces import union_ns

NAMES = ("owlpt.frame", "owlpt.bank", "owlpt.regen", "owlpt.film")


def read(r):
    h = r.host
    if h is None or h.read[1] <= h.read[0]:
        return None
    lo, hi = h.passes[h.read[0]][0], h.passes[h.read[1] - 1][1]
    spans = [(name, s, e) for name, s, e in h.spans if lo <= s < hi]
    if not any(name == "owlpt.step" for name, _, _ in spans):
        return None
    return union_ns([(s, e) for name, s, e in spans if name in NAMES]) / 1e6 / (h.read[1] - h.read[0])
