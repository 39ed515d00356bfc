"""Host time inside the program's ``owlpt.nee`` ranges per pass, in ms (NEE
shading's area-light sample, the BSDF's value and mixture pdf towards it,
the MIS weight, the contribution and the pending shadow ray), on the host
clock over the passes before any device profiler ran.  None where the passes
open no such range."""
from benchmark.traces import union_ns


def read(r):
    h = r.host
    if h is None or h.read[1] <= h.read[0]:
        return None
    lo, hi = h.passes[h.read[0]][0], h.passes[h.read[1] - 1][1]
    spans = [(s, e) for name, s, e in h.spans if name == "owlpt.nee" and lo <= s < hi]
    if not spans:
        return None
    return union_ns(spans) / 1e6 / (h.read[1] - h.read[0])
