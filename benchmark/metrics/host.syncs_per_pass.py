"""Reads that block the host on the card per pass: the program's
``owlpt.sync.<site>`` ranges (one around each such read) over the passes
before any device profiler ran.  None where the passes open no
``owlpt.step`` range: the program does not mark its host loop."""


def read(r):
    h = r.host
    if h is None or h.read[1] <= h.read[0]:
        return None
    lo, hi = h.passes[h.read[0]][0], h.passes[h.read[1] - 1][1]
    names = [name for name, s, _ in h.spans if lo <= s < hi]
    if "owlpt.step" not in names:
        return None
    return sum(name.startswith("owlpt.sync.") for name in names) / (h.read[1] - h.read[0])
