"""Fused single-kernel traversal over small clusters (counterpart of
``owl_path_tracer_tpu/ops/fused.py``, the round-1 kernel behind
``make_accel("fused")``).

The clusters are ``cluster.py``'s (C = 128 by default), re-laid for the
kernel: boxes [8,K] (cmin xyz, cmax xyz, 0, 0) and planes [K,16,C] (p0, e1,
e2 components, the tri id as float32, six zero rows).  A block of ``block``
rays slab-tests every box, then retires one cluster per iteration: the
lowest cluster id among its active rays' nearest entries (a ray is active
while its nearest un-retired entry is nearer than its best hit).  Every ray
whose entry to that cluster is nearer than its best tests its C triangles;
the lowest slot wins a tie, and a hit replaces the best only when it is
strictly nearer.  A block that is still active after ``max_steps``
retirements leaves the rays that still have a nearer entry unresolved, and
:func:`fused_closest_hit` answers those with the exact cluster query.

:func:`fused_traverse` launches the CUDA kernel (``csrc/fused_traverse.cu``)
for CUDA tensors and raises if it cannot; for CPU tensors it takes
:func:`fused_traverse_plain`, the same block algorithm in PyTorch, all blocks
in lockstep, whose ``steps`` and ``resolved`` columns equal the kernel's.
Output [N,8]: t, u, v, tri, hit, resolved, steps, and 0 in column 7 (the
Pallas kernel leaves that column unwritten).
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from ..native import bind_resources, build_cuda_library
from ..native import kernel_resources as _kernel_resources
from ..utils.tensors import TensorBundle
from . import math as m
from .cluster import ClusterBVH, _cluster_entries, cluster_closest_hit
from .fused2 import _check_operand, pack_rays
from .intersect import HitRecord, mt_components

BLOCK_RAYS = 128
MAX_STEPS = 192
OUT_COLS = 8

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fused_traverse.cu"
ENTRY = "owlpt_fused_traverse"

# launches of the CUDA kernel (one per call that ran it)
LAUNCHES = {ENTRY: 0}
# rays answered by the exact cluster query because their block ran out of steps
UNRESOLVED_RAYS = 0

_cuda_lib = None


def reset_counts():
    """Set the launch count and the unresolved-ray count to 0."""
    global UNRESOLVED_RAYS
    LAUNCHES[ENTRY] = 0
    UNRESOLVED_RAYS = 0


@dataclasses.dataclass
class FusedBVH(TensorBundle):
    boxes: torch.Tensor  # [8,K] rows cmin xyz, cmax xyz, 0, 0
    planes: torch.Tensor  # [K,16,C] rows p0(3) e1(3) e2(3) tid(1) zero(6)
    cluster: ClusterBVH  # the exact query for unresolved rays

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[1]

    @property
    def cluster_size(self) -> int:
        return self.planes.shape[2]


def build_fused(cb: ClusterBVH) -> FusedBVH:
    """Re-layout a ClusterBVH for the kernel, on its device."""
    k, c = cb.num_clusters, cb.cluster_size
    if int(cb.tri_id.max()) >= (1 << 24):
        raise ValueError("triangle ids exceed the exact float32 range")
    dev = cb.cmin.device
    boxes = torch.zeros((8, k), dtype=torch.float32, device=dev)
    boxes[0:3] = cb.cmin.T
    boxes[3:6] = cb.cmax.T
    planes = torch.zeros((k, 16, c), dtype=torch.float32, device=dev)
    planes[:, 0:9] = cb.tri_planes
    planes[:, 9] = cb.tri_id.to(torch.float32)
    return FusedBVH(boxes=boxes, planes=planes, cluster=cb)


# ── traversal: plain version and kernel ───────────────────────────────────


def fused_traverse_plain(ray_o, ray_d, t_max, fb: FusedBVH, block: int = BLOCK_RAYS,
                         max_steps: int = MAX_STEPS):
    """Plain PyTorch version of the kernel: [N] rays -> [N,8].

    The block algorithm of the reference kernel with every block in
    lockstep: [G,B,K] entries; per iteration each live block picks the lowest
    cluster id among its active rays' nearest entries (lowest id on equal
    entries), tests it for every ray whose entry to it beats its best
    (``mt_components``), counts a step on every row and retires it.  A block
    stops for good once it has no active ray; after ``max_steps`` iterations
    a ray that still has an entry nearer than its best is unresolved."""
    n = ray_o.shape[0]
    if n % block:
        raise ValueError(f"N={n} is not a multiple of the block {block}")
    g, k = n // block, fb.num_clusters
    dev = ray_o.device
    rays = pack_rays(ray_o, ray_d, t_max)
    # the reference kernel's slab ops in its order (the cluster boxes are the
    # kernel's box rows)
    ent = _cluster_entries(rays[:, 0:3], rays[:, 3:6], fb.cluster, m.T_MIN, rays[:, 6]).view(g, block, k)
    rays = rays.view(g, block, OUT_COLS)
    o, d, tmax = rays[..., 0:3], rays[..., 3:6], rays[..., 6]
    best_t, best_u, best_v = tmax.clone(), torch.zeros_like(tmax), torch.zeros_like(tmax)
    best_tri, hit = torch.full_like(tmax, -1.0), torch.zeros_like(tmax)
    steps = torch.zeros_like(tmax)
    done = torch.zeros(g, dtype=torch.bool, device=dev)
    comp = lambda x: (x[..., 0:1], x[..., 1:2], x[..., 2:3])  # noqa: E731  [G,B,1] each
    rows = torch.arange(block, device=dev)[None, :]
    for _ in range(max_steps):
        mn, cid = torch.min(ent, dim=-1)  # first index of the minimum
        active = mn < best_t
        done = done | ~active.any(-1)
        live = torch.nonzero(~done).squeeze(1)
        if live.numel() == 0:
            break
        cstar = torch.where(active[live], cid[live], k).amin(-1)  # [L] block picks
        gi = live[:, None]
        e_c = ent[gi, rows, cstar[:, None]]  # [L,B]
        bt = best_t[live]
        pl = fb.planes[cstar][:, :, None, :]  # [L,16,1,C]
        t, u, v, ok = mt_components(comp(o[live]), comp(d[live]), (pl[:, 0], pl[:, 1], pl[:, 2]),
                                    (pl[:, 3], pl[:, 4], pl[:, 5]), (pl[:, 6], pl[:, 7], pl[:, 8]),
                                    m.T_MIN, bt[..., None])
        ok &= (e_c < bt)[..., None] & (pl[:, 9] >= 0.0)
        tc, wcol = torch.min(torch.where(ok, t, torch.inf), dim=-1)  # lowest slot on a tie
        better = tc < bt
        pick = lambda x: torch.gather(x, -1, wcol[..., None]).squeeze(-1)  # noqa: E731
        tid = pl[:, 9].expand(-1, block, -1)
        best_t[live] = torch.where(better, tc, bt)
        best_u[live] = torch.where(better, pick(u), best_u[live])
        best_v[live] = torch.where(better, pick(v), best_v[live])
        best_tri[live] = torch.where(better, pick(tid), best_tri[live])
        hit[live] = torch.where(better, 1.0, hit[live])
        steps[live] += 1.0
        ent[gi, rows, cstar[:, None]] = torch.inf  # retire for the whole block
    resolved = torch.where(ent.amin(-1) < best_t, 0.0, 1.0)
    out = torch.stack([best_t, best_u, best_v, best_tri, hit, resolved, steps, torch.zeros_like(tmax)], -1)
    return out.view(n, OUT_COLS)


def build_kernels() -> tuple:
    """Build (if needed) and load the kernel library -> (path, seconds, log)."""
    global _cuda_lib
    path, seconds, log = build_cuda_library("owlpt_fused", [CSRC])
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        bind_resources(lib, ENTRY)
        _cuda_lib = lib
    return path, seconds, log


def kernel_resources(fb: FusedBVH, block: int = BLOCK_RAYS) -> dict:
    """Registers, shared bytes and blocks per SM (``native.kernel_resources``)
    of the kernel at ``fb``'s K and C, on the current CUDA device."""
    if _cuda_lib is None:
        build_kernels()
    return _kernel_resources(_cuda_lib, ENTRY, fb.num_clusters, fb.cluster_size, block)


def _fused_traverse_cuda(rays, fb: FusedBVH, block: int, max_steps: int):
    """Launch the kernel on the current stream -> [N,8] (no sync)."""
    if rays.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the fused kernel needs CUDA tensors on a CUDA device; got {rays.device}")
    n = rays.shape[0]
    k, c = fb.num_clusters, fb.cluster_size
    if block % 32 or not 32 <= block <= 1024 or n % block:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024] dividing N={n}")
    _check_operand("rays", rays, (n, OUT_COLS), rays.device)
    _check_operand("boxes", fb.boxes, (8, k), rays.device)
    _check_operand("planes", fb.planes, (k, 16, c), rays.device)
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=rays.device)
    if n == 0:
        return out
    if _cuda_lib is None:
        build_kernels()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_cuda_lib, ENTRY)(rays.data_ptr(), fb.boxes.data_ptr(), fb.planes.data_ptr(),
                                         out.data_ptr(), n, k, c, block, max_steps, stream)
    if err != 0:
        raise RuntimeError(f"fused kernel {ENTRY} launch failed: CUDA error {err}")
    LAUNCHES[ENTRY] += 1
    return out


def fused_traverse(ray_o, ray_d, t_max, fb: FusedBVH, block: int = BLOCK_RAYS,
                   max_steps: int = MAX_STEPS):
    """Raw sweep: [N] rays (``t_max`` scalar or [N]) -> [N,8] (t, u, v, tri,
    hit, resolved, steps, 0): the kernel for CUDA tensors, the plain version
    for CPU tensors.  N must be a multiple of ``block``."""
    if ray_o.device.type == "cpu":
        return fused_traverse_plain(ray_o, ray_d, t_max, fb, block, max_steps)
    return _fused_traverse_cuda(pack_rays(ray_o, ray_d, t_max), fb, block, max_steps)


def fused_closest_hit(ray_o, ray_d, fb: FusedBVH, t_min: float = m.T_MIN, t_max=m.T_MAX,
                      block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS) -> HitRecord:
    """Exact closest hit: the sweep, then the exact cluster query for the
    rows it left unresolved.

    Pads to whole blocks with rays from the origin along +z: with a per-ray
    ``t_max`` a padding ray gets t_max = T_MIN (it never becomes active);
    with a scalar ``t_max`` it keeps the scalar and takes part in its block's
    picks, as in the reference."""
    global UNRESOLVED_RAYS
    n = ray_o.shape[0]
    dev = ray_o.device
    scalar = torch.as_tensor(t_max).dim() == 0
    pad = (-n) % block
    ray_o_p, ray_d_p, t_max_p = ray_o, ray_d, t_max
    if pad:
        ray_o_p = torch.cat([ray_o, torch.zeros((pad, 3), dtype=torch.float32, device=dev)])
        ray_d_p = torch.cat([ray_d, torch.tensor([0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
        if not scalar:
            t_max_p = torch.cat([t_max, torch.full((pad,), m.T_MIN, dtype=torch.float32, device=dev)])
    out = fused_traverse(ray_o_p, ray_d_p, t_max_p, fb, block, max_steps)[:n]
    t = out[:, 0].clone()
    tri = torch.where(out[:, 4] > 0.0, out[:, 3].to(torch.int64), -1)
    uv = out[:, 1:3].clone()
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    rows = torch.nonzero(out[:, 5] <= 0.0).squeeze(1)
    if rows.numel():
        UNRESOLVED_RAYS += rows.numel()
        rec = cluster_closest_hit(ray_o[rows], ray_d[rows], fb.cluster, t_min=t_min, t_max=t_max[rows])
        t[rows] = rec.t
        tri[rows] = rec.tri
        uv[rows] = rec.uv
    t = torch.where(tri >= 0, t, t_max)
    return HitRecord(t=t, tri=tri, uv=uv)


def make_fused_intersector(fb: FusedBVH, **kw):
    """Intersector returning a HitRecord (no attribute blob)."""

    def intersect(ray_o, ray_d):
        return fused_closest_hit(ray_o, ray_d, fb, **kw)

    return intersect


def fused_occluded(ray_o, ray_d, fb: FusedBVH, t_min: float = m.T_MIN, t_max=m.T_MAX):
    """Occlusion through the kernel: closest hit, then ``tri >= 0``."""
    return fused_closest_hit(ray_o, ray_d, fb, t_min=t_min, t_max=t_max).tri >= 0
