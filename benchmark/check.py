"""The comparison that decides ``correct``: one pass of the program against
the plain reference's rendering of the same pass.

A path that meets a triangle the other side misses by a rounding, at an
edge or a silhouette, takes another way from there on, so some pixels of
two sound renderings differ by much; the numbers compared are therefore
shares and gaps over the whole pass, each held to its limit in the cell's
limits file (``limits/<cell>.json``):

* ``mismatch_pct``: the share of pixels, in %, with a channel that differs
  from the reference's by more than ``ATOL + RTOL * |reference|``, or that
  is not finite;
* ``rays_gap_pct``: the live rays' gap to the reference's count, in %;
* ``mean_gap_pct``: the image mean's gap to the reference's, in %.
"""
from __future__ import annotations

import numpy as np

# a pixel whose path met the same surfaces on both sides agrees far inside
# these (its float32 roundings add up to some 1e-6 relative)
RTOL = 1e-3
ATOL = 1e-4
NUMBERS = ("mismatch_pct", "rays_gap_pct", "mean_gap_pct")


def compare(img, ref, rays: int, ref_rays: int) -> dict:
    """Numbers compared for a pass: img, ref float arrays [H,W,3]."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    bad = ~np.isfinite(img).all(-1) | (np.abs(img - ref) > ATOL + RTOL * np.abs(ref)).any(-1)
    mean_ref = float(ref.mean())
    mean_img = float(img.mean()) if np.isfinite(img).all() else float("inf")
    return {
        "mismatch_pct": 100.0 * float(bad.mean()),
        "rays_gap_pct": 100.0 * abs(rays - ref_rays) / max(ref_rays, 1),
        "mean_gap_pct": 100.0 * abs(mean_img - mean_ref) / max(abs(mean_ref), 1e-30),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}); a number without a limit,
    or a limit without a number, is not correct."""
    out = {n: {"value": numbers.get(n, float("inf")), "limit": limits.get(n, float("-inf"))}
           for n in sorted(set(numbers) | set(limits))}
    return all(v["value"] <= v["limit"] for v in out.values()), out
