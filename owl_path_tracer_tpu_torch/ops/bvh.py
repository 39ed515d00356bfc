"""BVH construction for the per-ray-stack traversal (counterpart of
``owl_path_tracer_tpu/ops/bvh.py``).

A host-side binned-SAH builder that produces flattened, depth-first node
arrays, traversed by ``ops/traverse.py``.  Layout (``FlatBVH``):

  node_min/max [NN,3] f32   AABB per node
  node_a       [NN]   i32   internal: left-child node id; leaf: first index
                            into tri_order
  node_b       [NN]   i32   internal: right-child node id; leaf: -count
  tri_order    [T]    i32   triangle permutation; leaves own contiguous runs

Builders: ``build_bvh`` (numpy, 16 bins, leaves of at most ``max_leaf``
triangles; the JAX package's builder operation for operation, so the two
give the same arrays) and the port's own native builder
(``native/bvh.cpp``), which ``build_bvh_cached`` prefers, as the JAX
package's does.  Builds are cached on disk by a hash of the geometry, in the
port's own directory (``owl_path_tracer_tpu_torch/build/bvh_cache/`` unless
``cache_dir`` names another).
"""
from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

from ..native import BUILD_DIR, BuildError, FlatBVH, native_build_bvh

N_BINS = 16
CACHE_DIR = BUILD_DIR / "bvh_cache"

__all__ = ["FlatBVH", "N_BINS", "CACHE_DIR", "build_bvh", "build_bvh_cached", "validate_bvh"]


def _sah_split(centroids, bounds_min, bounds_max, ids):
    """The binned-SAH best split as a left mask; None makes a leaf."""
    n = len(ids)
    cmin = centroids.min(axis=0)
    cmax = centroids.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        return None
    scale = N_BINS * (1.0 - 1e-6) / extent[axis]
    bins = ((centroids[:, axis] - cmin[axis]) * scale).astype(np.int32)
    bins = np.clip(bins, 0, N_BINS - 1)

    counts = np.bincount(bins, minlength=N_BINS)
    bmin = np.full((N_BINS, 3), np.inf, np.float32)
    bmax = np.full((N_BINS, 3), -np.inf, np.float32)
    for b in range(N_BINS):
        mask = bins == b
        if counts[b]:
            bmin[b] = bounds_min[mask].min(axis=0)
            bmax[b] = bounds_max[mask].max(axis=0)

    def running(mn, mx, cnt, reverse=False):
        order = range(N_BINS - 1, -1, -1) if reverse else range(N_BINS)
        rmn = np.full((N_BINS, 3), np.inf, np.float32)
        rmx = np.full((N_BINS, 3), -np.inf, np.float32)
        rcnt = np.zeros(N_BINS, np.int64)
        cur_mn = np.full(3, np.inf, np.float32)
        cur_mx = np.full(3, -np.inf, np.float32)
        cur_c = 0
        for k in order:
            cur_mn = np.minimum(cur_mn, mn[k])
            cur_mx = np.maximum(cur_mx, mx[k])
            cur_c += cnt[k]
            rmn[k], rmx[k], rcnt[k] = cur_mn, cur_mx, cur_c
        return rmn, rmx, rcnt

    lmn, lmx, lcnt = running(bmin, bmax, counts)
    rmn, rmx, rcnt = running(bmin, bmax, counts, reverse=True)

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    # split after bin k: left = bins 0..k, right = k+1..
    cost = area(lmn, lmx)[:-1] * lcnt[:-1] + area(rmn, rmx)[1:] * rcnt[1:]
    valid = (lcnt[:-1] > 0) & (rcnt[1:] > 0)
    if not valid.any():
        return None
    k = int(np.argmin(np.where(valid, cost, np.inf)))
    left_mask = bins <= k
    # SAH termination: a split no cheaper than the leaf makes a leaf
    parent_d = np.maximum(bounds_max.max(0) - bounds_min.min(0), 0.0)
    parent_area = parent_d[0] * parent_d[1] + parent_d[1] * parent_d[2] + parent_d[2] * parent_d[0]
    if parent_area > 0 and cost[k] / parent_area >= n:
        return None
    return left_mask


def build_bvh(vertices: np.ndarray, tri_idx: np.ndarray, max_leaf: int = 4) -> FlatBVH:
    """Binned-SAH top-down build (iterative, explicit stack)."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int64)
    t = len(tri_idx)
    p0, p1, p2 = (vertices[tri_idx[:, k]] for k in range(3))
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    cent = (tmin + tmax) * 0.5

    node_min, node_max, node_a, node_b = [], [], [], []
    order = np.empty(t, np.int32)
    order_pos = 0

    def alloc():
        node_min.append(None)
        node_max.append(None)
        node_a.append(0)
        node_b.append(0)
        return len(node_a) - 1

    root = alloc()
    stack = [(root, np.arange(t, dtype=np.int64))]
    while stack:
        node, ids = stack.pop()
        bmn = tmin[ids].min(axis=0)
        bmx = tmax[ids].max(axis=0)
        node_min[node] = bmn
        node_max[node] = bmx
        split = None
        if len(ids) > max_leaf:
            split = _sah_split(cent[ids], tmin[ids], tmax[ids], ids)
            if split is None:
                # degenerate SAH: median split on the widest axis
                axis = int(np.argmax(bmx - bmn))
                med = np.argsort(cent[ids][:, axis], kind="stable")
                split = np.zeros(len(ids), bool)
                split[med[: len(ids) // 2]] = True
        if split is None:
            node_a[node] = order_pos
            node_b[node] = -len(ids)
            order[order_pos : order_pos + len(ids)] = ids
            order_pos += len(ids)
            continue
        la = alloc()
        rb = alloc()
        node_a[node] = la
        node_b[node] = rb
        # right pushed first, so the left subtree is laid out next (depth first)
        stack.append((rb, ids[~split]))
        stack.append((la, ids[split]))

    return FlatBVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_a=np.asarray(node_a, np.int32),
        node_b=np.asarray(node_b, np.int32),
        tri_order=order,
    )


def _geometry_hash(vertices: np.ndarray, tri_idx: np.ndarray, max_leaf: int) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(vertices, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_idx, np.int32).tobytes())
    h.update(str(max_leaf).encode())
    return h.hexdigest()[:24]


def build_bvh_cached(vertices: np.ndarray, tri_idx: np.ndarray, max_leaf: int = 4, cache_dir=None) -> FlatBVH:
    """Disk-cached build (``<cache_dir>/<geometry hash>.npz``, default
    CACHE_DIR); the native builder, or ``build_bvh`` where it cannot be
    built (any SAH tree gives the traversal the same closest hits)."""
    cache_dir = pathlib.Path(CACHE_DIR if cache_dir is None else cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{_geometry_hash(vertices, tri_idx, max_leaf)}.npz"
    if path.exists():
        with np.load(path) as z:
            return FlatBVH(z["nmin"], z["nmax"], z["na"], z["nb"], z["order"])
    try:
        bvh = native_build_bvh(vertices, tri_idx, max_leaf)
    except (BuildError, OSError):
        bvh = build_bvh(vertices, tri_idx, max_leaf)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, nmin=bvh.node_min, nmax=bvh.node_max, na=bvh.node_a, nb=bvh.node_b, order=bvh.tri_order)
    tmp.replace(path)  # concurrent builders never read a half-written file
    return bvh


def _require(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def validate_bvh(bvh: FlatBVH, vertices: np.ndarray, tri_idx: np.ndarray) -> None:
    """Structural invariants, raising AssertionError as the JAX package's
    asserts do (also under ``python -O``): every triangle in exactly one
    leaf, child boxes inside their parents, leaf boxes around their
    triangles (to 1e-4)."""
    t = len(tri_idx)
    _require(sorted(bvh.tri_order.tolist()) == list(range(t)), "tri_order not a permutation")
    leaf = bvh.node_b < 0
    covered = np.zeros(t, bool)
    for n in np.nonzero(leaf)[0]:
        start, cnt = bvh.node_a[n], -bvh.node_b[n]
        ids = bvh.tri_order[start : start + cnt]
        _require(not covered[ids].any(), "triangle in two leaves")
        covered[ids] = True
        p = vertices[tri_idx[ids].reshape(-1)].reshape(-1, 3, 3)
        _require((p.min(axis=(0, 1)) >= bvh.node_min[n] - 1e-4).all()
                 and (p.max(axis=(0, 1)) <= bvh.node_max[n] + 1e-4).all(), f"leaf {n} does not bound its triangles")
    _require(covered.all(), "a triangle is in no leaf")
    for n in np.nonzero(~leaf)[0]:
        for c in (bvh.node_a[n], bvh.node_b[n]):
            _require((bvh.node_min[c] >= bvh.node_min[n] - 1e-4).all()
                     and (bvh.node_max[c] <= bvh.node_max[n] + 1e-4).all(), f"node {c} outside its parent {n}")
