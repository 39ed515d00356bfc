"""Kernels the card ran per traced pass (the profiler's kernel records)."""


def read(r):
    if r.trace is None or not r.trace.passes or not r.trace.device_ops:
        return None
    return len(r.trace.kernels()) / len(r.trace.passes)
