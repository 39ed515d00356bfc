"""Cluster (ray-stream) intersector (counterpart of ``owl_path_tracer_tpu/ops/cluster.py``).

The SAH BVH's leaves, packed to at most C triangles, become fixed-size
triangle clusters stored as component planes [K,9,C].  ``cluster_closest_hit``
is the exact per-ray query: phase A slab-tests every ray against every
cluster box and sorts each ray's candidates near to far; phase B walks the
first ``MAX_CANDIDATES`` columns (a ray tests a candidate only while its
entry is nearer than its best hit), and the exact overflow walk continues,
``MAX_CANDIDATES`` at a time, for any ray that still has a nearer candidate.

It is the reference query the fused2 traversal kernel is held against, the
query its wrappers use for rays the kernel leaves unresolved, and the plain
version of the kernel on the CPU; ``cluster_occluded`` is its occlusion flag.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..native import native_build_bvh, native_extract_clusters
from ..utils.tensors import TensorBundle
from . import math as m
from .intersect import HitRecord, mt_components

MAX_CANDIDATES = 16


@dataclasses.dataclass
class ClusterBVH(TensorBundle):
    cmin: torch.Tensor  # [K,3] cluster AABB min (K padded to 128; pads never hit)
    cmax: torch.Tensor  # [K,3]
    tri_planes: torch.Tensor  # [K,9,C] component planes p0x,p0y,p0z,e1x..e2z
    tri_id: torch.Tensor  # [K,C] int32 original tri ids, -1 = padding

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tri_planes.shape[2]


def build_cluster_arrays(vertices: np.ndarray, tri_idx: np.ndarray, cluster_size: int = 128):
    """Host build -> numpy (cmin [K,3], cmax [K,3], planes [K,9,C], tid [K,C]).

    SAH build with leaves of ``max(C // 8, 8)`` triangles (native/bvh.cpp),
    then consecutive (DFS-ordered) leaves are packed greedily up to C
    triangles, and K is padded to a multiple of 128 with degenerate point
    boxes at +3e37 that no ray enters.
    """
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    c = cluster_size
    bvh = native_build_bvh(vertices, tri_idx, max_leaf=max(c // 8, 8))
    cmin, cmax, blob, tid = native_extract_clusters(vertices, tri_idx, bvh, c)
    k = len(cmin)

    counts = (tid >= 0).sum(1)
    if k > 1:
        groups, cur, cur_n = [], [], 0
        for j in range(k):
            cj = int(counts[j])
            if cur and cur_n + cj > c:
                groups.append(cur)
                cur, cur_n = [], 0
            cur.append(j)
            cur_n += cj
        groups.append(cur)
        if len(groups) < k:
            k2 = len(groups)
            cmin2 = np.empty((k2, 3), np.float32)
            cmax2 = np.empty((k2, 3), np.float32)
            blob2 = np.zeros((k2, c * 9), np.float32)
            tid2 = np.full((k2, c), -1, np.int32)
            for g, mem in enumerate(groups):
                cmin2[g] = cmin[mem].min(0)
                cmax2[g] = cmax[mem].max(0)
                rows = blob2[g].reshape(c, 9)
                pos = 0
                for j in mem:
                    cj = int(counts[j])
                    rows[pos : pos + cj] = blob[j].reshape(c, 9)[:cj]
                    tid2[g, pos : pos + cj] = tid[j, :cj]
                    pos += cj
            cmin, cmax, blob, tid, k = cmin2, cmax2, blob2, tid2, k2

    # pads are points at +3e37, NOT inverted boxes: the slab test's per-axis
    # min/max would turn an inverted box into one every ray enters at t_min
    k_pad = (-k) % 128
    if k_pad:
        far = np.float32(3e37)
        cmin = np.concatenate([cmin, np.full((k_pad, 3), far, np.float32)])
        cmax = np.concatenate([cmax, np.full((k_pad, 3), far, np.float32)])
        blob = np.concatenate([blob, np.zeros((k_pad, c * 9), np.float32)])
        tid = np.concatenate([tid, np.full((k_pad, c), -1, np.int32)])
    planes = np.ascontiguousarray(blob.reshape(-1, c, 9).transpose(0, 2, 1))
    return cmin, cmax, planes, tid


def build_clusters(vertices: np.ndarray, tri_idx: np.ndarray, cluster_size: int = 128,
                   *, device) -> ClusterBVH:
    cmin, cmax, planes, tid = build_cluster_arrays(vertices, tri_idx, cluster_size)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return ClusterBVH(cmin=as_t(cmin), cmax=as_t(cmax), tri_planes=as_t(planes), tri_id=as_t(tid))


def _inv_dir(ray_d):
    """1/d with |d| < 1e-12 components pushed to +-1e-12 (sign kept)."""
    tiny = torch.where(ray_d < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(ray_d) < 1e-12, tiny, ray_d)


def _cluster_entries(ray_o, ray_d, cb: ClusterBVH, t_min, t_max):
    """Dense [N,K] slab test -> entry distance (+inf where missed)."""
    inv_d = _inv_dir(ray_d)
    oi = ray_o * inv_d
    tn = torch.full((ray_o.shape[0], cb.num_clusters), -torch.inf, device=ray_o.device)
    tf = torch.full_like(tn, torch.inf)
    for a in range(3):
        t0 = inv_d[:, a : a + 1] * cb.cmin[None, :, a] - oi[:, a : a + 1]
        t1 = inv_d[:, a : a + 1] * cb.cmax[None, :, a] - oi[:, a : a + 1]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    t_enter = torch.clamp(tn, min=t_min)
    hit = t_enter <= torch.minimum(tf, t_max[:, None])
    return torch.where(hit, t_enter, torch.inf)


def _intersect_cluster(ray_o, ray_d, cb: ClusterBVH, cid, t_min, best_t):
    """[N,C] MT test of each ray against its cluster ``cid`` ->
    (t, tri, uv, slot, hit); the lowest slot wins a tie."""
    pl = cb.tri_planes[cid]  # [N,9,C]
    tid = cb.tri_id[cid]  # [N,C]
    rc = lambda a, ax: a[:, ax, None]  # noqa: E731
    t, u, v, ok = mt_components(
        (rc(ray_o, 0), rc(ray_o, 1), rc(ray_o, 2)),
        (rc(ray_d, 0), rc(ray_d, 1), rc(ray_d, 2)),
        (pl[:, 0], pl[:, 1], pl[:, 2]),
        (pl[:, 3], pl[:, 4], pl[:, 5]),
        (pl[:, 6], pl[:, 7], pl[:, 8]),
        t_min, best_t[:, None],
    )
    ok &= tid >= 0
    t = torch.where(ok, t, torch.inf)
    tj, j = torch.min(t, dim=-1)  # first index of the minimum
    hit = torch.isfinite(tj)
    rows = torch.arange(t.shape[0], device=t.device)
    tri = torch.where(hit, tid[rows, j].long(), -1)
    return tj, tri, torch.stack([u[rows, j], v[rows, j]], -1), j, hit


def _nearest_candidates(entries, kc: int):
    """Each ray's ``kc`` nearest clusters, ascending; ties keep the lower id."""
    ent, idx = torch.sort(entries, dim=1, stable=True)
    return ent[:, :kc], idx[:, :kc]


def _walk(ray_o, ray_d, cb, cand_t, cand_id, t_min, best, intersect):
    """Column walk: column i is tested by every ray whose i-th candidate
    entry is nearer than its best hit.  ``best`` = (t, tri, uv, cid, slot),
    updated in place."""
    best_t, best_tri, best_uv, best_cid, best_slot = best
    for i in range(cand_t.shape[1]):
        rows = torch.nonzero(cand_t[:, i] < best_t).squeeze(1)
        if rows.numel() == 0:
            continue
        cid = cand_id[rows, i]
        lt, ltri, luv, lslot, lhit = intersect(
            ray_o[rows], ray_d[rows], cb, cid, t_min, best_t[rows]
        )
        better = lhit & (lt < best_t[rows])
        rows = rows[better]
        best_t[rows] = lt[better]
        best_tri[rows] = ltri[better]
        best_uv[rows] = luv[better]
        best_cid[rows] = cid[better]
        best_slot[rows] = lslot[better]


def cluster_query(ray_o, ray_d, cb: ClusterBVH, t_min=m.T_MIN, t_max=m.T_MAX,
                  max_candidates: int = MAX_CANDIDATES, intersect=_intersect_cluster):
    """Exact closest hit -> (t, tri, uv, winner cluster, winner slot).

    Misses keep t = t_max, tri = -1, uv = 0 and cluster = slot = -1.
    ``t_max`` is a scalar or a per-ray [N] tensor.  ``intersect`` tests rays
    against one cluster each (the signature of ``_intersect_cluster``); the
    fused2 plain version passes its MXU-layout test.
    """
    n = ray_o.shape[0]
    dev = ray_o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).contiguous()
    kc = min(max_candidates, cb.num_clusters)
    entries = _cluster_entries(ray_o, ray_d, cb, t_min, t_max)
    cand_t, cand_id = _nearest_candidates(entries, kc)
    best = (
        t_max.clone(),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
        torch.zeros((n, 2), dtype=torch.float32, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
        torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    _walk(ray_o, ray_d, cb, cand_t, cand_id, t_min, best, intersect)

    # exact overflow walk: rays whose list ran out with a nearer candidate
    # left continue, kc candidates at a time, until none has one
    last_t = cand_t[:, kc - 1]
    if bool(torch.any(torch.isfinite(last_t) & (last_t < best[0]))):
        ent = entries.scatter(1, cand_id, torch.inf)
        while bool(torch.any(ent.min(dim=1).values < best[0])):
            ct, ci = _nearest_candidates(ent, kc)
            _walk(ray_o, ray_d, cb, ct, ci, t_min, best, intersect)
            ent = ent.scatter(1, ci, torch.inf)
    return best


def cluster_closest_hit(ray_o, ray_d, cb: ClusterBVH, t_min=m.T_MIN, t_max=m.T_MAX,
                        max_candidates: int = MAX_CANDIDATES) -> HitRecord:
    t, tri, uv, _, _ = cluster_query(ray_o, ray_d, cb, t_min, t_max, max_candidates)
    return HitRecord(t=t, tri=tri, uv=uv)


def cluster_occluded(ray_o, ray_d, cb: ClusterBVH, t_min=m.T_MIN, t_max=m.T_MAX):
    """Any valid hit in (t_min, t_max) -> [N] bool.

    Exactly the closest-hit query's ``tri >= 0`` for the same window: a valid
    hit exists iff a closest one does.  (The JAX package walks with an
    any-hit early stop; the flag is the same.)"""
    return cluster_query(ray_o, ray_d, cb, t_min, t_max)[1] >= 0
