"""Share of the lanes that trace a live ray, in %: the live rays of the
passes before any device profiler ran over their ``owlpt.step`` ranges
(one bounce of one wave each) times the wave's width (the traffic's
``lanes``, else its ``pixel_chunk``).  None where the passes open no
``owlpt.step`` range or the traffic gives no width."""


def read(r):
    h, width = r.host, r.traffic.get("lanes") or r.traffic.get("pixel_chunk")
    if h is None or h.read[1] <= h.read[0] or not width:
        return None
    lo, hi = h.passes[h.read[0]][0], h.passes[h.read[1] - 1][1]
    steps = sum(1 for name, s, _ in h.spans if name == "owlpt.step" and lo <= s < hi)
    if not steps:
        return None
    return 100.0 * sum(r.pass_rays[h.read[0]:h.read[1]]) / (steps * width)
