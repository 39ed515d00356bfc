"""fused (K5) traversal's share of its roofline in the checked pass, in %:
the bound of the work that pass's rays need (``benchmark/bound.py``, from
the reference's rays and closest hits) over the device time of the
library's traversal kernels that ran in that pass."""
import re

from benchmark.bound import share

PATTERN = re.compile(r"fused_kernel|weight_kernel|slot_kernel|order_blocks")
WAVE = re.compile(r"slot_kernel|fused_kernel")  # one launch per wave of rays
OUT_FLOATS = 4  # t, u, v, triangle


def read(r):
    return share(r, PATTERN, WAVE, OUT_FLOATS, r.traffic.get("pixel_chunk"))
