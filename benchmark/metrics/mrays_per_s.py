"""Live path rays of every pass in the window over the window's wall time
(from the first pass's start to the last image on the host), in millions."""


def read(r):
    return sum(r.pass_rays) / r.window_s / 1e6
