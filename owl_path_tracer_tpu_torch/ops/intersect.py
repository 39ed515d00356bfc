"""Ray-triangle intersection (counterpart of ``owl_path_tracer_tpu/ops/intersect.py``).

``mt_components`` is THE canonical Moller-Trumbore op order: every
intersector here (brute, cluster, the CUDA kernel in csrc/) evaluates it
operation for operation -- ``1.0/det`` and then a multiply, sums left to
right, no fused multiply-adds -- so their t/u/v agree bit for bit.
Closest-hit semantics: smallest t in (t_min, t_max), barycentrics (u, v) with
P = (1-u-v) p0 + u p1 + v p2, no backface culling.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.tensors import TensorBundle
from . import math as m

_EPS_DET = 1e-12


@dataclasses.dataclass
class HitRecord(TensorBundle):
    t: torch.Tensor  # [N] f32, t_max if miss
    tri: torch.Tensor  # [N] int64, -1 if miss
    uv: torch.Tensor  # [N,2] barycentrics

    @property
    def hit(self):
        return self.tri >= 0


def mt_components(o_c, d_c, p0_c, e1_c, e2_c, t_min, t_max):
    """Moller-Trumbore on broadcastable component tensors -> (t, u, v, valid)."""
    ox, oy, oz = o_c
    dx, dy, dz = d_c
    p0x, p0y, p0z = p0_c
    e1x, e1y, e1z = e1_c
    e2x, e2y, e2z = e2_c
    # h = d x e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    inv = 1.0 / torch.where(torch.abs(det) < _EPS_DET, 1.0, det)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (torch.abs(det) >= _EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, u, v, valid


def closest_hit_brute(ray_o, ray_d, vertices, tri_idx, t_min=m.T_MIN, t_max=m.T_MAX,
                      tri_chunk: int = 512) -> HitRecord:
    """Closest hit of each ray against every triangle (test oracle), in
    chunks of ``tri_chunk`` triangles carrying the running best."""
    n = ray_o.shape[0]
    dev = ray_o.device
    best_t = torch.full((n,), float(t_max), dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    rc = lambda a, ax: a[:, ax, None]  # noqa: E731  [N,1]
    for lo in range(0, tri_idx.shape[0], tri_chunk):
        idx = tri_idx[lo : lo + tri_chunk].long()
        p0 = vertices[idx[:, 0]]
        e1 = vertices[idx[:, 1]] - p0
        e2 = vertices[idx[:, 2]] - p0
        comp = lambda a, ax: a[None, :, ax]  # noqa: E731  [1,C]
        t, u, v, ok = mt_components(
            (rc(ray_o, 0), rc(ray_o, 1), rc(ray_o, 2)),
            (rc(ray_d, 0), rc(ray_d, 1), rc(ray_d, 2)),
            (comp(p0, 0), comp(p0, 1), comp(p0, 2)),
            (comp(e1, 0), comp(e1, 1), comp(e1, 2)),
            (comp(e2, 0), comp(e2, 1), comp(e2, 2)),
            t_min, t_max,
        )
        t = torch.where(ok, t, torch.inf)
        tj, j = torch.min(t, dim=-1)  # first index of the minimum
        better = tj < best_t
        rows = torch.arange(n, device=dev)
        best_tri = torch.where(better, lo + j, best_tri)
        best_uv = torch.where(better[:, None], torch.stack([u[rows, j], v[rows, j]], -1), best_uv)
        best_t = torch.where(better, tj, best_t)
    return HitRecord(t=best_t, tri=best_tri, uv=best_uv)
