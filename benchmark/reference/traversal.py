"""Exact closest hits over clusters of its own, and the work they need.

The triangles, in the Morton order of their centroids, are cut into
clusters of C (the cell's cluster size).  A ray slab-tests every cluster
box, sorts the boxes it enters near to far, and tests a cluster's C
triangles by Moller-Trumbore (``1/det`` then a multiply, sums left to
right, as the program's exact query) while the box's entry is nearer than
its best hit; equal distances keep the earlier winner.  Besides the hit,
each ray reports the clusters whose box it enters before its closest hit:
the work that an exact query of any form has to do on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .shading import T_MAX, T_MIN

EPS_DET = 1e-12


@dataclasses.dataclass
class Clusters:
    cmin: torch.Tensor  # [K,3]
    cmax: torch.Tensor  # [K,3]
    planes: torch.Tensor  # [K,9,C] p0, e1, e2 by component
    tri: torch.Tensor  # [K,C] triangle ids, -1 = pad


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable order of points by the 30-bit Morton code of their position
    quantized to 1024 steps per axis of their bounds."""
    lo, hi = centroids.min(0), centroids.max(0)
    q = np.clip(((centroids - lo) / np.maximum(hi - lo, 1e-20) * 1023.0).astype(np.int64), 0, 1023)
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + 2 - axis)
    return np.argsort(code, kind="stable")


def build_clusters(tri_p: np.ndarray, size: int, device, plane_dtype=torch.float32) -> Clusters:
    """Clusters of ``size`` triangles from tri_p [T,3,3]; ``plane_dtype``
    rounds the stored triangle data (the boxes stay float32)."""
    t = len(tri_p)
    order = morton_order(tri_p.mean(1, dtype=np.float64))
    k = -(-t // size)
    tri = np.full(k * size, -1, np.int64)
    tri[:t] = order
    tri = tri.reshape(k, size)
    p = tri_p[np.clip(tri, 0, None)]  # [K,C,3,3]
    pad = tri < 0
    big = np.float32(3e37)
    cmin = np.where(pad[..., None, None], big, p).min(axis=(1, 2))
    cmax = np.where(pad[..., None, None], -big, p).max(axis=(1, 2))
    p0, e1, e2 = p[:, :, 0], p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0]
    planes = np.concatenate([p0, e1, e2], axis=2).transpose(0, 2, 1)  # [K,9,C]
    planes = np.where(pad[:, None, :], 0.0, planes).astype(np.float32)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    pl = as_t(planes)
    if plane_dtype != torch.float32:
        pl = pl.to(plane_dtype).to(torch.float32)
    return Clusters(cmin=as_t(cmin), cmax=as_t(cmax), planes=pl, tri=as_t(tri))


def _entries(o, d, cl: Clusters):
    """[R,K] distance at which each ray enters each box (inf: not entered)."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    oi = o * inv_d
    tn = torch.full((o.shape[0], cl.cmin.shape[0]), -torch.inf, device=o.device)
    tf = torch.full_like(tn, torch.inf)
    for a in range(3):
        t0 = inv_d[:, a:a + 1] * cl.cmin[None, :, a] - oi[:, a:a + 1]
        t1 = inv_d[:, a:a + 1] * cl.cmax[None, :, a] - oi[:, a:a + 1]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    t_enter = torch.clamp(tn, min=T_MIN)
    return torch.where(t_enter <= torch.clamp(tf, max=T_MAX), t_enter, torch.inf)


def _moller_trumbore(o, d, pl, t_max):
    """Rays [A,3] against their clusters' planes [A,9,C] -> t, u, v, valid [A,C]."""
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (pl[:, i] for i in range(9))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    inv = 1.0 / torch.where(torch.abs(det) < EPS_DET, 1.0, det)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = ((torch.abs(det) >= EPS_DET) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
             & (t < t_max[:, None]))
    return t, u, v, valid


def closest_hit(o, d, cl: Clusters):
    """-> (t [N] (T_MAX on a miss), tri [N] (-1), u [N], v [N], needed [N])."""
    n = o.shape[0]
    dev = o.device
    # rays per slab test of every box: [chunk, K] entries stay near 2^24
    chunk = max(4096, min(65536, (1 << 24) // max(cl.cmin.shape[0], 1)))
    best_t = torch.full((n,), T_MAX, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    needed = torch.zeros((n,), dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ro, rd = o[lo:hi], d[lo:hi]
        ent = _entries(ro, rd, cl)
        ent_s, ids = torch.sort(ent, dim=1, stable=True)
        bt, btri = best_t[lo:hi], best_tri[lo:hi]
        bu, bv = best_u[lo:hi], best_v[lo:hi]
        for col in range(ent_s.shape[1]):
            rows = torch.nonzero(ent_s[:, col] < bt).squeeze(1)
            if rows.numel() == 0:
                break
            cid = ids[rows, col]
            t, u, v, ok = _moller_trumbore(ro[rows], rd[rows], cl.planes[cid], bt[rows])
            ok &= cl.tri[cid] >= 0
            tj, j = torch.min(torch.where(ok, t, torch.inf), dim=-1)
            better = torch.isfinite(tj)
            sel = rows[better]
            jb = j[better]
            ar = torch.arange(jb.shape[0], device=dev)
            bt[sel] = tj[better]
            btri[sel] = cl.tri[cid[better], jb]
            bu[sel] = u[better][ar, jb]
            bv[sel] = v[better][ar, jb]
        needed[lo:hi] = (ent < bt[:, None]).sum(1)
    return best_t, best_tri, best_u, best_v, needed
