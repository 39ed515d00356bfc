"""The table of peaks and the work a traversal launch needs (frozen from
``chip_smoke.py``'s bound), one count for every form that implements it.

Operations: per cluster a ray needs (a box it enters before its closest
hit), the slab test of the box (``SLAB_OPS``) and, per slot of the cluster,
the winner chain every traversal form runs (``CHAIN_OPS``: sign 2, |det| and
three sign flips 4, window 14, safe divisor 2, divide and select 2, min 1,
lowest-slot pick 3), at the fp32 peak.  Bytes: per launch, its rays read
once (origin, direction, t_max), the cluster boxes and the triangles read
once, its outputs written once, at the HBM rate.  The larger bound wins.
Published peaks of one H100 SXM at 700 W.
"""
from __future__ import annotations

import sys

SLAB_OPS = 28
CHAIN_OPS = 28
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def roofline(needed: int, cluster_size: int, launches: int, rays_per_launch: int, clusters: int, tris: int,
             out_floats: int) -> tuple:
    """-> (bound seconds, "operations" or "bytes")."""
    ops = (SLAB_OPS + CHAIN_OPS * cluster_size) * float(needed)
    nbytes = 4.0 * launches * (rays_per_launch * (7 + out_floats) + clusters * 6 + tris * 9)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(readings, pattern, wave, out_floats: int, rays_per_launch: int, needed: str = "needed"):
    """A traversal kernel's share of its roofline in the checked pass, in %:
    the bound of the work the pass's rays need (the clusters counted under
    the key ``needed`` of ``readings.work``, the path rays' by default) over
    the device time of the kernels whose names match ``pattern`` and that
    ran inside that pass (one wave's rays are read once per kernel matching
    ``wave``); None where the run traced no such kernel or its reference
    counted no such work."""
    r = readings
    if r.trace is None or r.work is None or needed not in r.work or not rays_per_launch:
        return None
    lo, hi = r.trace.passes[r.work["pass_index"]]
    ks = [(name, s, e) for _, name, s, e in r.trace.kernels(lo, hi) if pattern.search(name)]
    launches = sum(1 for name, _, _ in ks if wave.search(name))
    if not launches:
        return None
    bound_s, by = roofline(r.work[needed], r.work["cluster_size"], launches, rays_per_launch,
                           r.work["clusters"], r.work["tris"], out_floats)
    device_s = sum(e - s for _, s, e in ks) / 1e9
    print(f"benchmark: roofline of {launches} waves: bound {bound_s:.6f} s by {by}, device {device_s:.6f} s",
          file=sys.stderr)
    return 100.0 * bound_s / device_s
