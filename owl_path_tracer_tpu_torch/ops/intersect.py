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


def _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, t_max):
    """All-pairs MT test: rays [N,3] x chunk [C,3] -> t, u, v, valid [N,C].
    ``t_max`` is a scalar or a per-ray [N] tensor."""
    e1 = p1 - p0  # [C,3]
    e2 = p2 - p0
    comp = lambda a, ax: a[None, :, ax]  # noqa: E731  [1,C]
    rcomp = lambda a, ax: a[:, ax, None]  # noqa: E731  [N,1]
    if torch.is_tensor(t_max) and t_max.dim() == 1:
        t_max = t_max[:, None]
    return mt_components(
        (rcomp(ray_o, 0), rcomp(ray_o, 1), rcomp(ray_o, 2)),
        (rcomp(ray_d, 0), rcomp(ray_d, 1), rcomp(ray_d, 2)),
        (comp(p0, 0), comp(p0, 1), comp(p0, 2)),
        (comp(e1, 0), comp(e1, 1), comp(e1, 2)),
        (comp(e2, 0), comp(e2, 1), comp(e2, 2)),
        t_min, t_max,
    )


def _chunks(vertices, tri_idx, tri_chunk: int):
    """(first tri id, p0, p1, p2) per chunk of ``tri_chunk`` triangles; the
    last chunk is shorter where the JAX package pads it with masked ids."""
    for lo in range(0, tri_idx.shape[0], tri_chunk):
        idx = tri_idx[lo : lo + tri_chunk].long()
        yield lo, vertices[idx[:, 0]], vertices[idx[:, 1]], vertices[idx[:, 2]]


def closest_hit_brute(ray_o, ray_d, vertices, tri_idx, t_min=m.T_MIN, t_max=m.T_MAX,
                      tri_chunk: int = 512) -> HitRecord:
    """Closest hit of each ray against every triangle, ``tri_chunk``
    triangles at a time carrying the running best; the lowest id wins a tie.
    ``t_max`` is a scalar or a per-ray [N] tensor.

    The sweep picks each ray's winner without recording autograd; t, u and v
    are then the winner's Moller-Trumbore values evaluated once more, with
    the same operations on the same operands (so the same bits), on the live
    rays and vertices.  Gradients are the JAX package's (which flow through
    the winner's entry of its one-hot pick) without keeping [N, tri_chunk]
    temporaries for the backward pass."""
    n = ray_o.shape[0]
    dev = ray_o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    best_t = t_max.detach().clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for lo, p0, p1, p2 in _chunks(vertices, tri_idx, tri_chunk):
            t, _, _, ok = _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, t_max)
            tj, j = torch.min(torch.where(ok, t, torch.inf), dim=-1)  # first index of the minimum
            better = tj < best_t
            best_tri = torch.where(better, lo + j, best_tri)
            best_t = torch.where(better, tj, best_t)
    hit = best_tri >= 0
    idx = tri_idx[best_tri.clamp(min=0)].long()
    p0 = vertices[idx[:, 0]]
    e1 = vertices[idx[:, 1]] - p0
    e2 = vertices[idx[:, 2]] - p0
    comp = lambda a: (a[:, 0], a[:, 1], a[:, 2])  # noqa: E731
    t, u, v, _ = mt_components(comp(ray_o), comp(ray_d), comp(p0), comp(e1), comp(e2), t_min, t_max)
    return HitRecord(t=torch.where(hit, t, t_max), tri=best_tri,
                     uv=torch.where(hit[:, None], torch.stack([u, v], -1), 0.0))


def any_hit_brute(ray_o, ray_d, vertices, tri_idx, t_min=m.T_MIN, t_max=m.T_MAX,
                  tri_chunk: int = 512):
    """Occlusion (shadow rays) -> [N] bool: is there any valid hit in
    (t_min, t_max)?  ``t_max`` is a scalar or a per-ray [N] tensor."""
    occluded = torch.zeros((ray_o.shape[0],), dtype=torch.bool, device=ray_o.device)
    with torch.no_grad():
        for _, p0, p1, p2 in _chunks(vertices, tri_idx, tri_chunk):
            occluded |= _tri_chunk_hits(ray_o, ray_d, p0, p1, p2, t_min, t_max)[3].any(dim=-1)
    return occluded
