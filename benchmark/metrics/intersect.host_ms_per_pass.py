"""Host time inside the program's ``owlpt.intersect`` ranges per pass, in
ms (each closest-hit query whole: padding, packing, the sort, the
traversal's launch, the unsort, the sync on the resolved column and the
exact fallback), on the host clock over the passes before any device
profiler ran."""
from benchmark.traces import union_ns


def read(r):
    h = r.host
    if h is None or h.read[1] <= h.read[0]:
        return None
    lo, hi = h.passes[h.read[0]][0], h.passes[h.read[1] - 1][1]
    spans = [(s, e) for name, s, e in h.spans if name == "owlpt.intersect" and lo <= s < hi]
    if not spans:
        return None
    return union_ns(spans) / 1e6 / (h.read[1] - h.read[0])
