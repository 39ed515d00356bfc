"""fused2 (K1b) mixed sweep's share of its roofline in the checked pass, in
%: the bound of the work that pass's bounce rays and shadow segments need
(``benchmark/bound.py``, from the reference's closest hits and segment
queries: ``mixed_needed``) over the device time of the library's traversal
kernels that ran in that pass.  Each launch reads a wave of 2 x lanes rays
(bounce rays, then the pending shadow rays).  None where the reference
counts no segments (a configuration without NEE)."""
import re

from benchmark.bound import share

PATTERN = re.compile(r"fused2_kernel|frontier_kernel|slot_kernel|order_blocks|tf32_sums_kernel")
WAVE = re.compile(r"fused2_kernel")  # one launch per wave of rays
OUT_FLOATS = 4 + 16  # t, u, v, triangle and the attribute payload


def read(r):
    lanes = r.traffic.get("lanes")
    return share(r, PATTERN, WAVE, OUT_FLOATS, 2 * lanes if lanes else None, needed="mixed_needed")
