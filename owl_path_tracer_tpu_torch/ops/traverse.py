"""Per-ray-stack BVH traversal in plain PyTorch (counterpart of
``owl_path_tracer_tpu/ops/traverse.py``).

A frozen ablation baseline, as in the JAX package: on no production path,
kept as an exact intersector the faster ones are held against.  The whole
wave steps in lockstep: each iteration pops one node per ray, tests both
children's boxes (pushing the far one, then the near one, so the near one is
popped next) or intersects the at most ``max_leaf`` triangles of a leaf, all
as masked [N]-shaped tensor operations, until every ray's 64-entry stack is
empty.  A push beyond depth 64 is dropped, as in the JAX package.

Same contract as ``ops/intersect.py``: closest hit in (t_min, t_max), the
canonical Moller-Trumbore (``mt_components``), no culling.  The JAX
package's operations are kept in their order (near-first pushes, a strict
``t < best_t`` between leaves, the 1e-12 guard of 1/d), so the winners,
t, u and v equal the brute sweep's and the cluster query's bit for bit.

Differences from the JAX package, exact in value: its ``while_loop`` tests
``any(sp > 0)`` every iteration, which in eager PyTorch is a host sync per
iteration; here the test runs every ``CHECK_EVERY`` iterations (an
iteration in which every stack is empty changes nothing).  The walk runs
without recording autograd and the winner's t/u/v are evaluated again on the
live rays (same bits), so camera gradients flow through it, which JAX's
``while_loop`` cannot differentiate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.tensors import TensorBundle
from . import math as m
from .intersect import HitRecord, mt_components

STACK_DEPTH = 64
# iterations between the host's reads of "is any stack non-empty"
CHECK_EVERY = 16


@dataclasses.dataclass
class DeviceBVH(TensorBundle):
    """A FlatBVH on the device, with the triangles in leaf order."""

    node_min: torch.Tensor  # [NN,3] f32
    node_max: torch.Tensor  # [NN,3] f32
    node_a: torch.Tensor  # [NN] int64 (internal: left child; leaf: first slot)
    node_b: torch.Tensor  # [NN] int64 (internal: right child; leaf: -count)
    tri_p0: torch.Tensor  # [T,3] first vertex, in tri_order
    tri_e1: torch.Tensor  # [T,3] p1 - p0
    tri_e2: torch.Tensor  # [T,3] p2 - p0
    tri_id: torch.Tensor  # [T] int64 original triangle id of each slot


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def device_bvh(bvh, vertices, tri_idx, *, device) -> DeviceBVH:
    """Triangles gathered into leaf order with their edges, once at build time."""
    order = np.asarray(bvh.tri_order)
    t = _np(tri_idx)[order]
    v = np.asarray(_np(vertices), np.float32)
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    f = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return DeviceBVH(
        node_min=f(bvh.node_min), node_max=f(bvh.node_max),
        node_a=f(bvh.node_a, torch.int64), node_b=f(bvh.node_b, torch.int64),
        tri_p0=f(p0), tri_e1=f(p1 - p0), tri_e2=f(p2 - p0), tri_id=f(order, torch.int64),
    )


def _slab_test(o, inv_d, bmin, bmax, t_min, t_far):
    """Ray-box slab test -> (hit, t_enter); boxes [N,3], t_far [N]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_enter = torch.clamp(torch.minimum(t0, t1).amax(-1), min=t_min)
    t_exit = torch.minimum(torch.maximum(t0, t1).amin(-1), t_far)
    return t_enter <= t_exit, t_enter


def _leaf_hits(ray_o, ray_d, bvh: DeviceBVH, start, count, t_min, best_t, max_leaf: int):
    """The best hit of each ray among the (up to ``max_leaf``) triangles of
    its leaf -> (t, leaf-order slot, hit)."""
    offs = torch.arange(max_leaf, device=ray_o.device)
    slot = (start[:, None] + offs).clamp(0, bvh.tri_p0.shape[0] - 1)  # [N,L]
    in_leaf = offs < count[:, None]
    p0, e1, e2 = bvh.tri_p0[slot], bvh.tri_e1[slot], bvh.tri_e2[slot]
    rc = lambda a, ax: a[:, ax, None]  # noqa: E731  [N,1]
    cc = lambda a, ax: a[..., ax]  # noqa: E731  [N,L]
    t, _, _, ok = mt_components(
        (rc(ray_o, 0), rc(ray_o, 1), rc(ray_o, 2)), (rc(ray_d, 0), rc(ray_d, 1), rc(ray_d, 2)),
        (cc(p0, 0), cc(p0, 1), cc(p0, 2)), (cc(e1, 0), cc(e1, 1), cc(e1, 2)), (cc(e2, 0), cc(e2, 1), cc(e2, 2)),
        t_min, best_t[:, None],
    )
    t = torch.where(ok & in_leaf, t, torch.inf)
    j = t.argmin(-1)  # the first of equal minima, as jnp.argmin
    tj = t.amin(-1)
    return tj, slot.gather(1, j[:, None])[:, 0], torch.isfinite(tj)


def bvh_closest_hit(ray_o, ray_d, bvh: DeviceBVH, t_min: float = m.T_MIN, t_max=m.T_MAX, max_leaf: int = 4,
                    any_hit: bool = False) -> HitRecord:
    """Closest hit by the per-ray stack walk; ``t_max`` a scalar or per-ray
    [N].  ``any_hit`` ends a ray at its first hit (shadow rays: only
    ``tri >= 0`` is then meaningful).

    The walk picks each ray's winner without recording autograd; t, u and v
    are then the winner's Moller-Trumbore values evaluated once more, with
    the same operations on the same operands (so the same bits), on the live
    rays, as ``closest_hit_brute`` does: gradients flow through the winner
    only, and the backward keeps none of the walk's temporaries."""
    n = ray_o.shape[0]
    dev = ray_o.device
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    best_t = t_max.detach().clone()
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def push(stack, sp, ok, node):
        """stack[sp] = node where ok and sp < STACK_DEPTH (beyond: dropped), sp += that."""
        ok = ok & (sp < STACK_DEPTH)
        pos = sp.clamp(max=STACK_DEPTH - 1)[:, None]
        stack.scatter_(1, pos, torch.where(ok[:, None], node.to(torch.int32)[:, None], stack.gather(1, pos)))
        return sp + ok.to(torch.int64)

    with torch.no_grad():
        o, d = ray_o.detach(), ray_d.detach()
        inv_d = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
        stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
        sp = torch.ones(n, dtype=torch.int64, device=dev)  # the root, node 0, pushed
        it = 0
        while it % CHECK_EVERY or bool((sp > 0).any()):
            it += 1
            active = sp > 0
            node = stack.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0].to(torch.int64)
            node = torch.where(active, node, 0)
            sp = torch.where(active, sp - 1, sp)
            a, b = bvh.node_a[node], bvh.node_b[node]
            is_leaf = b < 0

            # internal: test both children, push far then near (leaves carry
            # triangle offsets in a/b: masked to node 0, their results unused)
            ca = torch.where(is_leaf, 0, a)
            cb = torch.where(is_leaf, 0, b)
            hit_a, ta = _slab_test(o, inv_d, bvh.node_min[ca], bvh.node_max[ca], t_min, best_t)
            hit_b, tb = _slab_test(o, inv_d, bvh.node_min[cb], bvh.node_max[cb], t_min, best_t)
            internal = active & ~is_leaf
            hit_a = hit_a & internal
            hit_b = hit_b & internal
            a_near = ta <= tb
            sp = push(stack, sp, torch.where(a_near, hit_b, hit_a), torch.where(a_near, cb, ca))
            sp = push(stack, sp, torch.where(a_near, hit_a, hit_b), torch.where(a_near, ca, cb))

            # leaf: intersect its triangles
            at_leaf = active & is_leaf
            lt, lslot, lhit = _leaf_hits(o, d, bvh, torch.where(at_leaf, a, 0), torch.where(at_leaf, -b, 0),
                                         t_min, best_t, max_leaf)
            better = at_leaf & lhit & (lt < best_t)
            best_t = torch.where(better, lt, best_t)
            best_slot = torch.where(better, lslot, best_slot)
            if any_hit:
                sp = torch.where(best_slot >= 0, 0, sp)  # the first hit ends the ray
    hit = best_slot >= 0
    s = best_slot.clamp(min=0)
    comp = lambda a: (a[:, 0], a[:, 1], a[:, 2])  # noqa: E731
    t, u, v, _ = mt_components(comp(ray_o), comp(ray_d), comp(bvh.tri_p0[s]), comp(bvh.tri_e1[s]),
                               comp(bvh.tri_e2[s]), t_min, t_max)
    return HitRecord(t=torch.where(hit, t, t_max), tri=torch.where(hit, bvh.tri_id[s], -1),
                     uv=torch.where(hit[:, None], torch.stack([u, v], -1), 0.0))


def make_bvh_intersector(bvh: DeviceBVH, max_leaf: int = 4):
    def intersect(ray_o, ray_d):
        return bvh_closest_hit(ray_o, ray_d, bvh, max_leaf=max_leaf)

    return intersect


def bvh_occluded(ray_o, ray_d, bvh: DeviceBVH, t_min: float = m.T_MIN, t_max=m.T_MAX, max_leaf: int = 4):
    """Shadow-ray occlusion: any hit in (t_min, t_max) -> [N] bool."""
    rec = bvh_closest_hit(ray_o, ray_d, bvh, t_min=t_min, t_max=t_max, max_leaf=max_leaf, any_hit=True)
    return rec.tri >= 0
