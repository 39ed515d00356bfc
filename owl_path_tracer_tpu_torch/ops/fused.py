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

In the kernel each thread keeps its ray's KCAND nearest un-retired entries
and scans the boxes again when they are used up.  Its scan skips every
member of a group of GROUP_SIZE consecutive clusters whose group box
(:func:`group_boxes`, the exact bounds of its members) the ray enters no
nearer than its list's last entry, and a rescan is shared by the whole warp;
the lists are those of a scan of every box (:func:`nearest_lists` is the
plain version of both).

The kernel (entry ENTRY) starts the blocks heaviest first, by a pre-pass
that weighs each block by the group boxes its rays enter
(:func:`block_weights` and :func:`block_order` are its plain versions),
stages each picked cluster by one bulk copy, splits the tests of the rays
that enter it over the lanes of a warp, one lane per slot, and shares each
rescan over the warp, one member box per lane.

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
import types

import torch

from ..native import build_cuda_library
from ..render.metrics import span
from ..utils.tensors import TensorBundle
from . import math as m
from .cluster import ClusterBVH, _cluster_entries, cluster_closest_hit
from .fused2 import _check_operand, _t_max_rows, pack_rays
from .intersect import HitRecord, mt_components

BLOCK_RAYS = 128
MAX_STEPS = 192
OUT_COLS = 8
# entries a kernel thread lists per scan, and clusters per group box
KCAND = 8
GROUP_SIZE = 32
# profile columns per block (fused_traverse_profile), rows by block of rays:
# clock64 cycles of the set-up scan, pick and staging, the slot tests, the
# list updates and rescans, the whole block, its retirement steps, its
# launch rank and its weight (the pre-pass's, block_weights)
PROFILE_COLS = ("setup", "pick_stage", "slot_loop", "rescans", "total", "steps", "rank", "weight")
# count columns per ray (fused_traverse_profile): its rescans, the boxes it
# slab-tested, and the clusters whose slots it tested (it entered the
# block's pick nearer than its best hit)
COUNT_COLS = ("rescans", "boxes", "clusters")

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fused_traverse.cu"
ENTRY = "owlpt_fused_traverse"
PROFILE_ENTRY = "owlpt_fused_traverse_profile"

# launches of the CUDA kernel by entry (one per call that ran it)
LAUNCHES = {ENTRY: 0}
# rays answered by the exact cluster query because their block ran out of steps
UNRESOLVED_RAYS = 0

_cuda_lib = None


def reset_counts():
    """Set the launch counts and the unresolved-ray count to 0."""
    global UNRESOLVED_RAYS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    UNRESOLVED_RAYS = 0


@dataclasses.dataclass
class FusedBVH(TensorBundle):
    boxes: torch.Tensor  # [8,K] rows cmin xyz, cmax xyz, 0, 0
    planes: torch.Tensor  # [K,16,C] rows p0(3) e1(3) e2(3) tid(1) zero(6)
    cluster: ClusterBVH  # the exact query for unresolved rays
    # [8,ceil(K/GROUP_SIZE)] group boxes in the boxes' layout (group_boxes);
    # made from boxes when not given
    groups: torch.Tensor | None = None

    def __post_init__(self):
        if self.groups is None:
            self.groups = group_boxes(self.boxes)

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[1]

    @property
    def cluster_size(self) -> int:
        return self.planes.shape[2]


def group_boxes(boxes, size: int = GROUP_SIZE):
    """[8,K] boxes -> [8,ceil(K/size)]: per run of ``size`` consecutive
    clusters the minimum of their cmin and the maximum of their cmax (the
    last group takes the clusters that are left), so each group box contains
    its members' boxes."""
    k = boxes.shape[1]
    kg = (k + size - 1) // size
    pad = kg * size - k
    lo = torch.nn.functional.pad(boxes[0:3], (0, pad), value=torch.inf).view(3, kg, size).amin(-1)
    hi = torch.nn.functional.pad(boxes[3:6], (0, pad), value=-torch.inf).view(3, kg, size).amax(-1)
    return torch.cat([lo, hi, boxes.new_zeros((2, kg))]).contiguous()


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


def _boxes_as_clusters(boxes) -> types.SimpleNamespace:
    """[8,K'] boxes in the shape ``cluster._cluster_entries`` reads."""
    return types.SimpleNamespace(cmin=boxes[0:3].T, cmax=boxes[3:6].T, num_clusters=boxes.shape[1])


def nearest_lists(ray_o, ray_d, t_max, fb: FusedBVH, retired=None, groups: bool = True):
    """Plain version of the kernel's list scan: per ray the KCAND smallest
    (entry, id) pairs over the clusters not ``retired`` ([K] bool), and how
    many boxes a thread's scan slab-tests -> (entries [N,KCAND] (inf where
    none), ids [N,KCAND] (K where none), boxes tested [N]).

    ``groups`` scans as the kernel's set-up scan: group by group in
    ascending id, a group's box first, its un-retired members only where the
    group's entry is below the list's last entry; else every un-retired box.
    The lists are the same either way."""
    n, k = ray_o.shape[0], fb.num_clusters
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=ray_o.device).expand(n)
    live = torch.ones(k, dtype=torch.bool, device=ray_o.device) if retired is None else ~retired
    ent = torch.where(live, _cluster_entries(ray_o, ray_d, fb.cluster, m.T_MIN, t_max), torch.inf)
    ids = torch.arange(k, device=ray_o.device).expand(n, k)
    if not groups:
        e, order = torch.sort(ent, dim=1, stable=True)
        e, i = e[:, :KCAND], order[:, :KCAND]
        return e, torch.where(torch.isinf(e), k, i), live.sum().expand(n).clone()
    gent = _cluster_entries(ray_o, ray_d, _boxes_as_clusters(fb.groups), m.T_MIN, t_max)
    size = GROUP_SIZE
    e = torch.full((n, KCAND), torch.inf, device=ray_o.device)
    i = torch.full((n, KCAND), k, dtype=torch.int64, device=ray_o.device)
    tests = torch.zeros(n, dtype=torch.int64, device=ray_o.device)
    for gi in range(fb.groups.shape[1]):
        j0, j1 = gi * size, min(k, (gi + 1) * size)
        take = gent[:, gi] < e[:, -1]
        tests += 1 + take * int(live[j0:j1].sum())
        # list ids all come from earlier groups: the concatenation ascends
        # by id, so a stable sort orders it by (entry, id)
        cand_e = torch.cat([e, torch.where(take[:, None], ent[:, j0:j1], torch.inf)], 1)
        cand_i = torch.cat([i, ids[:, j0:j1]], 1)
        se, order = torch.sort(cand_e, dim=1, stable=True)
        e = se[:, :KCAND]
        i = torch.where(torch.isinf(e), k, torch.gather(cand_i, 1, order[:, :KCAND]))
    return e, i, tests


def block_weights(ray_o, ray_d, t_max, fb: FusedBVH, block: int = BLOCK_RAYS):
    """Plain version of the kernel's block weights: per block of
    ``block`` rays the number of distinct group boxes (:func:`group_boxes`)
    that its rays enter within their t_max -> [N / block] int64."""
    n = ray_o.shape[0]
    if n % block:
        raise ValueError(f"N={n} is not a multiple of the block {block}")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=ray_o.device).expand(n)
    gent = _cluster_entries(ray_o, ray_d, _boxes_as_clusters(fb.groups), m.T_MIN, t_max)
    return torch.isfinite(gent).view(n // block, block, -1).any(1).sum(1)


def block_order(weights):
    """Plain version of the kernel's block order: the blocks by weight,
    heaviest first, equal weights in block order -> order [G] int64, where
    order[rank] is the block launched at that rank."""
    return torch.sort(torch.as_tensor(weights), descending=True, stable=True).indices


def build_kernels() -> tuple:
    """Build (if needed) and load the kernel library -> (path, seconds, log)."""
    global _cuda_lib
    path, seconds, log = build_cuda_library("owlpt_fused", [CSRC])
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        head = [ptr] * 7 + [i64] + [i32] * 5  # rays ... out, weight, order; n, k, c, gsize, block, max_steps
        for name, args in ((ENTRY, head + [ptr]), (PROFILE_ENTRY, head + [ptr] * 3)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        fn = getattr(lib, f"{ENTRY}_resources")
        fn.restype = ctypes.c_int
        fn.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
        _cuda_lib = lib
    return path, seconds, log


def kernel_resources(fb: FusedBVH, block: int = BLOCK_RAYS) -> dict:
    """Threads and CTAs per block of rays, registers, shared bytes and
    blocks per SM of the kernel (its traversal kernel, not the pre-pass) at
    ``fb``'s K and C, on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused kernel's resources need a CUDA device")
    if _cuda_lib is None:
        build_kernels()
    out = (ctypes.c_int * 3)()
    err = getattr(_cuda_lib, f"{ENTRY}_resources")(fb.num_clusters, fb.cluster_size, block, out)
    if err != 0:
        raise RuntimeError(f"kernel {ENTRY}: resource query failed: CUDA error {err}")
    return {"entry": ENTRY, "threads": block, "ctas": 1, "registers": out[0], "shared_bytes": out[1],
            "blocks_per_sm": out[2]}


def _fused_traverse_cuda(rays, fb: FusedBVH, block: int, max_steps: int, profile: bool = False):
    """Launch the kernel (``profile``: the diagnostic entry, which also
    returns the per-block profile and per-ray counts) on the current stream
    -> [N,8] (no sync)."""
    if rays.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the fused kernel needs CUDA tensors on a CUDA device; got {rays.device}")
    n = rays.shape[0]
    k, c = fb.num_clusters, fb.cluster_size
    if block % 32 or not 32 <= block <= 1024 or n % block:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024] dividing N={n}")
    _check_operand("rays", rays, (n, OUT_COLS), rays.device)
    _check_operand("boxes", fb.boxes, (8, k), rays.device)
    _check_operand("groups", fb.groups, (8, -(-k // GROUP_SIZE)), rays.device)
    _check_operand("planes", fb.planes, (k, 16, c), rays.device)
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=rays.device)
    stats = (torch.empty((n // block, len(PROFILE_COLS)), dtype=torch.int64, device=rays.device),
             torch.empty((n, len(COUNT_COLS)), dtype=torch.int32, device=rays.device)) if profile else ()
    if n == 0:
        return (out, *stats) if profile else out
    if _cuda_lib is None:
        build_kernels()
    # the pre-pass's scratch: the blocks' weights and their launch order
    weight = torch.empty(n // block, dtype=torch.int32, device=rays.device)
    order = torch.empty(n // block, dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (rays.data_ptr(), fb.boxes.data_ptr(), fb.groups.data_ptr(), fb.planes.data_ptr(), out.data_ptr(),
                weight.data_ptr(), order.data_ptr(), n, k, c, GROUP_SIZE, block, max_steps)
        if profile:
            err = getattr(_cuda_lib, PROFILE_ENTRY)(*head, stats[0].data_ptr(), stats[1].data_ptr(), stream)
        else:
            err = getattr(_cuda_lib, ENTRY)(*head, stream)
    if err != 0:
        raise RuntimeError(f"fused kernel {PROFILE_ENTRY if profile else ENTRY} launch failed: CUDA error {err}")
    if profile:
        return (out, *stats)
    LAUNCHES[ENTRY] += 1
    return out


def fused_traverse(ray_o, ray_d, t_max, fb: FusedBVH, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS):
    """Raw sweep: [N] rays (``t_max`` scalar or [N]) -> [N,8] (t, u, v, tri,
    hit, resolved, steps, 0): the kernel for CUDA tensors, the plain version
    for CPU tensors.  N must be a multiple of ``block``."""
    if ray_o.device.type == "cpu":
        return fused_traverse_plain(ray_o, ray_d, t_max, fb, block, max_steps)
    return _fused_traverse_cuda(pack_rays(ray_o, ray_d, t_max), fb, block, max_steps)


def fused_traverse_profile(ray_o, ray_d, t_max, fb: FusedBVH, block: int = BLOCK_RAYS,
                           max_steps: int = MAX_STEPS):
    """The kernel's diagnostic entry (CUDA tensors only, no render path):
    the sweep with clock64 phase times -> (out [N,8] as fused_traverse,
    profile [N/block, PROFILE_COLS] int64 cycles, steps, launch rank and
    weight per block, counts [N, COUNT_COLS] int32: each ray's rescans,
    boxes slab-tested and clusters tested).  Not counted in LAUNCHES."""
    if ray_o.device.type != "cuda":
        raise RuntimeError(f"the fused kernel's profile needs CUDA tensors; got {ray_o.device}")
    return _fused_traverse_cuda(pack_rays(ray_o, ray_d, t_max), fb, block, max_steps, profile=True)


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
        up = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        up[:, 2] = 1.0  # a fill on the device: no copy from the host, no sync
        ray_d_p = torch.cat([ray_d, up])
        if not scalar:
            t_max_p = torch.cat([t_max, torch.full((pad,), m.T_MIN, dtype=torch.float32, device=dev)])
    out = fused_traverse(ray_o_p, ray_d_p, t_max_p, fb, block, max_steps)[:n]
    t = out[:, 0].clone()
    tri = torch.where(out[:, 4] > 0.0, out[:, 3].to(torch.int64), -1)
    uv = out[:, 1:3].clone()
    t_max = _t_max_rows(t_max, n, dev, "owlpt.sync.k5_t_max")
    with span("owlpt.sync.resolved"):
        rows = torch.nonzero(out[:, 5] <= 0.0).squeeze(1)
    if rows.numel():
        UNRESOLVED_RAYS += rows.numel()
        with span("owlpt.unresolved"):
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
