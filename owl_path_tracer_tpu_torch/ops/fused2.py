"""Fused wavefront traversal (counterpart of ``owl_path_tracer_tpu/ops/fused2.py``).

Fat SAH clusters (C up to 512 triangles), a per-block cluster frontier, and
the winner's shading attributes read straight from the cluster attribute
planes, so the integrator needs no per-ray gather of surface data.

Two plane layouts, as in the JAX package:

* component ``[K,16,C]`` float32 (rows p0/e1/e2, tri id): Moller-Trumbore per
  slot (kernels K1-K3, and K4's component form);
* MXU feature ``[K,16,4C]`` (:func:`_mxu_features`), float32 or bfloat16, the
  default of :func:`build_fused2` and of ``make_accel("fused2")`` /
  ``"fused2-bf16"``: ray features ``[d, o x d, o, 1]`` times each cluster's
  feature matrix give ``det | u*det | v*det | t*det`` per slot (kernel K1b);
  the traversal retires up to ``fanout`` clusters per loop iteration
  (FANOUT = 2).

The traversal is one hand-written CUDA kernel source, ``csrc/fused2_traverse.cu``,
with one entry per (layout, mode): ``closest`` (closest hit + attributes;
K1, K1b), ``closest`` with ``with_attrs=False`` (loop t/u/v and the in-plane
tri id, no attributes; K4), ``any_hit`` (occlusion; K2, K1b) and ``mixed``
(closest hit for lanes whose ray column 7 is 0, occlusion for the shadow
lanes whose column 7 is 1; K3, K1b).  The component entries run the
slot-parallel body (a cluster's slots tested in parallel by a thread block
cluster of CTAs per block of rays, heavy blocks first); ``serial=True``
(closest hit with attributes, mixed) runs the serial body instead, one
thread per ray, with the same outputs bit for bit: the reference of the
slot-parallel body's steps and resolved columns in the card tests, off every
render path.  :func:`fused2_traverse_profile` (the profile entry)
splits either body's time per block by clock64.  On the MXU layout the
three modes take the feature products on the tensor cores (bf16 planes:
bf16 products; f32 planes: 3xTF32, each operand split into two TF32
terms), and so does closest hit without attributes (K4) on f32 planes;
their sums may differ from the plain version's by a few ulps of the summed
magnitudes (:func:`mxu_slot_sums` gives the plain sums and their magnitudes,
:func:`mxu_tensor_sums` the f32 tensor-core ones on the card).  A block
keeps its frontier row ``[K]`` in shared memory where the block's bytes fit
under the device's opt-in limit and lose no block per SM by it, else in
device memory (:func:`row_form`), so the kernels take
any K the reference takes; what cannot launch at all raises a ValueError
that names K, C, the block and the bytes.  :func:`fused2_traverse_packed` launches
it for CUDA tensors and raises if it cannot; for CPU tensors it takes the
plain version, :func:`fused2_traverse_packed_plain` (an exact per-ray walk
over the clusters in entry order, same [N,32] output contract).  Rays a
kernel block leaves unresolved (its retirement loop hit ``max_steps``) go
through the exact cluster query in the wrappers (:func:`fused2_closest_hit`,
:func:`fused2_occluded`, :func:`fused2_sweep_mixed`), as in the reference.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import numpy as np
import torch

from ..native import bind_resources, build_cuda_library
from ..native import kernel_resources as _kernel_resources
from ..render.metrics import host_copy, span
from ..utils.tensors import TensorBundle
from . import math as m
from .cluster import (
    ClusterBVH, _intersect_cluster, build_cluster_arrays, cluster_closest_hit, cluster_occluded,
    cluster_query,
)
from .intersect import HitRecord, mt_components

BLOCK_RAYS = 128
# clusters retired per loop iteration on the MXU layout (the component layout
# retires one); results do not depend on it
FANOUT = 2
# retirement-loop bound per block, in loop iterations; a block that reaches
# it marks its rays unresolved and the wrapper answers them with the exact
# cluster query
MAX_STEPS = 512
# per-ray frontier refresh interval, in retired clusters
REFRESH_CLUSTERS = 16

# attr plane row layout (32 rows x C slots per cluster, f32)
#   0:3 n0  3:6 n1  6:9 n2  9:11 tc0  11:13 tc1  13:15 tc2  15 material id
#   16 tri id (exact f32 < 2^24)  17:20 p0  20:23 e1  23:26 e2  26:32 zero
ATTR_ROWS = 32
# kernel output columns [N,32]:
#   0 t  1 u  2 v  3 tri  4 hit  5 resolved  6 steps  7 winner cluster
#   8 winner slot  9:16 zero  16:32 attr rows 0-15 of the winner
OUT_COLS = 32

# sort keys: origin Morton bits and direction bits per axis (3*(5+4) < 30);
# coherence keys stay below 2^30, and the mixed sweep puts the shadow class
# on bit 30 so that sorted blocks are pure bounce or pure shadow
SORT_O_BITS = 5
SORT_D_BITS = 4
SHADOW_CLASS_BIT = 30
# candidate-scan K-chunk width and meta-box coarsening of the cid2 key
CID_CHUNK = 512
CID_META = 4

# rays per exact cluster query in the plain version (bounds its [n,C] temporaries)
PLAIN_CHUNK = 16384
# rays per MXU cluster test in the plain version (bounds its [n,19,C] plane gather)
PLAIN_MXU_CHUNK = 2048

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fused2_traverse.cu"
# the tensor-core staging and products, shared with the latency probe
TENSOR_OPS = CSRC.with_name("tensor_ops.cuh")

MODES = ("closest", "any_hit", "mixed")
# kernel entry points in the kernel library, by (layout, mode, with_attrs):
# K1-K3 on the component layout, K1b on the MXU layouts, K4 = closest hit
# without attributes (f32 planes only)
_ENTRY = {
    ("component", "closest", True): "owlpt_fused2_closest_hit",
    ("component", "any_hit", False): "owlpt_fused2_occluded",
    ("component", "mixed", True): "owlpt_fused2_sweep_mixed",
    ("component", "closest", False): "owlpt_fused2_closest_hit_noattr",
    # the serial component body (one thread per ray), kept as K1's and K3's
    # bit-exact witness (serial=True)
    ("component_serial", "closest", True): "owlpt_fused2_serial_closest_hit",
    ("component_serial", "mixed", True): "owlpt_fused2_serial_sweep_mixed",
    ("mxu_f32", "closest", True): "owlpt_fused2_mxu_closest_hit",
    ("mxu_f32", "any_hit", False): "owlpt_fused2_mxu_occluded",
    ("mxu_f32", "mixed", True): "owlpt_fused2_mxu_sweep_mixed",
    ("mxu_f32", "closest", False): "owlpt_fused2_mxu_closest_hit_noattr",
    ("mxu_bf16", "closest", True): "owlpt_fused2_mxu_bf16_closest_hit",
    ("mxu_bf16", "any_hit", False): "owlpt_fused2_mxu_bf16_occluded",
    ("mxu_bf16", "mixed", True): "owlpt_fused2_mxu_bf16_sweep_mixed",
}

# the slot-parallel component entries (K1-K4) take scratch besides the
# common arguments: the blocks' launch order, first frontiers and entered
# cluster counts (csrc launch_slot)
_SLOT_ENTRIES = frozenset(v for (layout, _, _), v in _ENTRY.items() if layout == "component")

# diagnostic entry (no render path): the f32 tensor-core feature sums
SUMS_ENTRY = "owlpt_fused2_mxu_tf32_sums"
# diagnostic entry (no render path): a component entry, slot-parallel or
# serial, with clock64 phase cycles per block (csrc PhaseClock): the scene
# gate and first frontier, the picks with their bound reductions and
# refreshes, the wait for a cluster's plane rows, the slot tests with the
# per-ray combine, the winner payload, the block's total (their sum) and its
# retired clusters
PROFILE_ENTRY = "owlpt_fused2_profile"
PROFILE_COLS = ("setup", "pick", "stage", "test", "payload", "total", "steps")
# launch shape of the slot-parallel component entries at (C, mode): threads
# per CTA, CTAs per block of rays, and whether the blocks are ordered (the
# entry then takes scratch)
SHAPE_ENTRY = "owlpt_fused2_slot_shape"
# the device's opt-in shared memory per block
LIMIT_ENTRY = "owlpt_fused2_smem_limit"
# where a block keeps its frontier row [K] f32 (csrc shared_bytes): in shared
# memory, or in a scratch in device memory
ROW_FORMS = ("shared", "global")

# launches of the CUDA kernel, by entry point (one per call that ran it)
LAUNCHES = dict.fromkeys([*_ENTRY.values(), PROFILE_ENTRY], 0)
# rays (of every mode) answered by the exact cluster query because their
# block overflowed
UNRESOLVED_RAYS = 0

_cuda_lib = None


def reset_counts():
    """Set every launch count and the unresolved-ray count to 0."""
    global UNRESOLVED_RAYS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    UNRESOLVED_RAYS = 0


@dataclasses.dataclass
class Fused2BVH(TensorBundle):
    boxes: torch.Tensor  # [8,K]: rows 0-2 cmin.xyz, 3-5 cmax.xyz
    # component layout [K,16,C] f32: rows 0-8 p0/e1/e2 components, 9 tid,
    # 10-15 zero; or MXU layout [K,16,4C] f32 or bf16 (_mxu_features)
    planes: torch.Tensor
    attrs: torch.Tensor  # [K,ATTR_ROWS,C] shading payload planes (f32)
    attr_table: torch.Tensor  # [T,ATTR_ROWS] the same payload by tri id
    bounds: torch.Tensor  # [2,3] scene AABB (sort-key quantization)
    cluster: ClusterBVH  # exact per-ray query (plain version, unresolved rays)

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[1]

    @property
    def cluster_size(self) -> int:
        return self.attrs.shape[2]

    @property
    def mxu(self) -> bool:
        return self.planes.shape[2] == 4 * self.attrs.shape[2]

    @property
    def layout(self) -> str:
        if not self.mxu:
            return "component"
        return "mxu_bf16" if self.planes.dtype == torch.bfloat16 else "mxu_f32"


def _mxu_features(tri_planes: np.ndarray, tid: np.ndarray) -> np.ndarray:
    """Per-triangle Moller-Trumbore feature matrix of the MXU layout.

    With ray features R = [d(3), m = o x d (3), o(3), 1, 0...] ([16]) and per
    cluster F [16,4C] in column groups [det | u*det | v*det | t*det]:

        R @ F = [d.(e2 x e1) | e2.m - (e2 x p0).d | -e1.m - (p0 x e1).d | n.o - n.p0]

    with n = e1 x e2: Moller-Trumbore's det, u*det, v*det and t*det.  Only
    rows 0-9 multiply non-zero ray features; the tri id sits in row 10 of
    group 0, where the ray feature is 0.  Padding slots are all zero.
    """
    kk, _, c = tri_planes.shape
    p0 = tri_planes[:, 0:3].transpose(0, 2, 1)  # [K,C,3]
    e1 = tri_planes[:, 3:6].transpose(0, 2, 1)
    e2 = tri_planes[:, 6:9].transpose(0, 2, 1)
    n = np.cross(e1, e2)
    f = np.zeros((kk, 16, 4 * c), np.float32)
    f[:, 0:3, 0:c] = np.cross(e2, e1).transpose(0, 2, 1)
    f[:, 10, 0:c] = tid
    f[:, 0:3, c : 2 * c] = -np.cross(e2, p0).transpose(0, 2, 1)
    f[:, 3:6, c : 2 * c] = e2.transpose(0, 2, 1)
    f[:, 0:3, 2 * c : 3 * c] = -np.cross(p0, e1).transpose(0, 2, 1)
    f[:, 3:6, 2 * c : 3 * c] = -e1.transpose(0, 2, 1)
    f[:, 6:9, 3 * c : 4 * c] = n.transpose(0, 2, 1)
    f[:, 9, 3 * c : 4 * c] = -np.einsum("kcx,kcx->kc", n, p0)
    return f


def build_fused2_arrays(vertices, tri_idx, cluster_size: int = 512, normals=None,
                        texcoords=None, tri_mat=None, mxu: bool = True) -> dict:
    """Host build -> dict of numpy arrays (the Fused2BVH fields, ``cluster``
    as a nested dict); float32 planes of the MXU or the component layout."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    cmin, cmax, tri_planes, tid = build_cluster_arrays(vertices, tri_idx, cluster_size)
    k, c = cmin.shape[0], tri_planes.shape[2]
    if tid.max() >= (1 << 24):
        raise ValueError("triangle ids exceed the exact float32 range")

    boxes = np.zeros((8, k), np.float32)
    boxes[0:3] = cmin.T
    boxes[3:6] = cmax.T
    if mxu:
        planes = _mxu_features(tri_planes, tid.astype(np.float32))
    else:
        planes = np.zeros((k, 16, c), np.float32)
        planes[:, 0:9] = tri_planes
        planes[:, 9] = tid.astype(np.float32)

    t_count = tri_idx.shape[0]
    attr_table = np.zeros((t_count, ATTR_ROWS), np.float32)
    nrm = np.asarray(normals if normals is not None else np.zeros((len(vertices), 3)), np.float32)
    tc = np.asarray(texcoords if texcoords is not None else np.zeros((len(vertices), 2)), np.float32)
    mat = np.asarray(tri_mat if tri_mat is not None else np.zeros((t_count,)), np.float32)
    for v_i in range(3):
        attr_table[:, 3 * v_i : 3 * v_i + 3] = nrm[tri_idx[:, v_i]]
        attr_table[:, 9 + 2 * v_i : 11 + 2 * v_i] = tc[tri_idx[:, v_i]]
    attr_table[:, 15] = mat
    attr_table[:, 16] = np.arange(t_count, dtype=np.float32)
    # winner geometry comes from the same plane bits the intersectors read
    valid = tid >= 0
    attr_table[tid[valid], 17:26] = tri_planes.transpose(0, 2, 1)[valid]
    attrs = attr_table[np.maximum(tid, 0)].transpose(0, 2, 1).copy()
    bounds = np.stack([vertices.min(0), vertices.max(0)]).astype(np.float32)
    return dict(
        boxes=boxes, planes=planes, attrs=attrs, attr_table=attr_table, bounds=bounds,
        cluster=dict(cmin=cmin, cmax=cmax, tri_planes=tri_planes, tri_id=tid),
    )


def build_fused2(vertices, tri_idx, cluster_size: int = 512, normals=None, texcoords=None,
                 tri_mat=None, mxu: bool = True, plane_dtype=torch.float32, *, device) -> Fused2BVH:
    """SAH-leaf clusters + planes (MXU feature layout by default, else the
    component layout) + shading-attribute planes.  ``plane_dtype``
    ``torch.bfloat16`` (MXU layout only) rounds the planes to nearest even."""
    from ..convert import fused2_from_numpy

    if plane_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"plane_dtype must be torch.float32 or torch.bfloat16, got {plane_dtype}")
    if plane_dtype == torch.bfloat16 and not mxu:
        raise ValueError("bf16 planes require the MXU feature layout")
    arrays = build_fused2_arrays(vertices, tri_idx, cluster_size, normals, texcoords, tri_mat, mxu)
    fb = fused2_from_numpy(arrays, device=device)
    fb.planes = fb.planes.to(plane_dtype)
    return fb


def build_fused2_scene(scene, cluster_size: int = 512, mxu: bool = True,
                       plane_dtype=torch.float32) -> Fused2BVH:
    """Build from a compiled Scene, with its shading attributes, on its device."""
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return build_fused2(
        host(scene.vertices), host(scene.tri_idx), cluster_size=cluster_size,
        normals=host(scene.normals), texcoords=host(scene.texcoords),
        tri_mat=host(scene.tri_mat), mxu=mxu, plane_dtype=plane_dtype,
        device=scene.vertices.device,
    )


# ── rays ──────────────────────────────────────────────────────────────────


def _detached(*xs):
    """Each tensor argument detached from autograd (others as they are)."""
    return tuple(x.detach() if torch.is_tensor(x) else x for x in xs)


def _t_max_rows(t_max, n: int, device, site: str):
    """``t_max`` (a number, or a tensor [] or [N]) as [n] float32 on
    ``device``; a number is copied from the host, under the range ``site``."""
    if torch.is_tensor(t_max):
        return torch.as_tensor(t_max, dtype=torch.float32, device=device).expand(n)
    return host_copy(site, t_max, dtype=torch.float32, device=device).expand(n)


def pack_rays(ray_o, ray_d, t_max, shadow=None):
    """[N,8] kernel ray layout: o(3) d(3) tmax flag.  The flag column marks
    the shadow (any-hit) lanes of a mixed sweep; 0 otherwise.  Detached, as
    in the JAX package: the traversal is not differentiable (hit records do
    not depend on materials or the environment; camera gradients take
    :func:`fused2_closest_hit_diff`'s refit)."""
    ray_o, ray_d, t_max, shadow = _detached(ray_o, ray_d, t_max, shadow)
    n = ray_o.shape[0]
    t_max = _t_max_rows(t_max, n, ray_o.device, "owlpt.sync.pack_rays")
    if shadow is None:
        flag = torch.zeros((n, 1), dtype=torch.float32, device=ray_o.device)
    else:
        flag = shadow.to(torch.float32)[:, None]
    return torch.cat([ray_o, ray_d, t_max[:, None], flag], dim=1).contiguous()


def _pad_rays(ray_o, ray_d, t_max, block: int):
    """Pad to a whole number of blocks; pad rays get t_max = T_MIN (no hits)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    t_max = _t_max_rows(t_max, n, dev, "owlpt.sync.pad_rays")
    pad = (-n) % block
    if not pad:
        return ray_o, ray_d, t_max, n
    ray_o = torch.cat([ray_o, torch.zeros((pad, 3), dtype=torch.float32, device=dev)])
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(pad, 3)
    ray_d = torch.cat([ray_d, up])
    t_max = torch.cat([t_max, torch.full((pad,), m.T_MIN, dtype=torch.float32, device=dev)])
    return ray_o, ray_d, t_max, n


# ── coherence sort ────────────────────────────────────────────────────────


def _morton3(x, y, z, bits: int = 4):
    key = torch.zeros_like(x)
    for i in range(bits):
        key = (
            key
            | (((x >> i) & 1) << (3 * i + 2))
            | (((y >> i) & 1) << (3 * i + 1))
            | (((z >> i) & 1) << (3 * i))
        )
    return key


def ray_sort_keys(ray_o, ray_d, bounds):
    """Origin Morton cell (major) + direction cell (minor), int64 < 2^27."""
    ob, db = SORT_O_BITS, SORT_D_BITS
    lo = bounds[0]
    ext = torch.clamp(bounds[1] - bounds[0], min=1e-6)
    cells = float(1 << ob)
    q = torch.clamp(((ray_o - lo) / ext) * cells, 0.0, cells - 1.0).to(torch.int64)
    mk = _morton3(q[:, 0], q[:, 1], q[:, 2], bits=ob)
    dcells = float(1 << db)
    dq = torch.clamp((ray_d * 0.5 + 0.5) * dcells, 0.0, dcells - 1.0).to(torch.int64)
    dk = (dq[:, 0] << (2 * db)) | (dq[:, 1] << db) | dq[:, 2]
    return (mk << (3 * db)) | dk


def _top2_candidates(ray_o, ray_d, t_max, boxes, k: int):
    """Per-ray ids of the two nearest candidate boxes (slab entry order);
    rays with fewer candidates get the sentinel ``k``.  Scans K in chunks
    of CID_CHUNK so memory stays [N, CID_CHUNK]."""
    n = ray_o.shape[0]
    dev = ray_o.device
    ch = min(CID_CHUNK, k)
    kp = (k + ch - 1) // ch * ch
    bx = boxes
    if kp != k:
        pad = torch.cat([
            torch.full((6, kp - k), 3e37, dtype=torch.float32, device=dev),
            torch.zeros((2, kp - k), dtype=torch.float32, device=dev),
        ])
        bx = torch.cat([boxes, pad], 1)
    inv = 1.0 / torch.where(torch.abs(ray_d) < 1e-12, torch.where(ray_d < 0, -1e-12, 1e-12), ray_d)
    ia = [inv[:, a : a + 1] for a in range(3)]
    oa = [ray_o[:, a : a + 1] for a in range(3)]
    tmax_col = t_max[:, None]
    col = torch.arange(ch, device=dev)[None, :]
    e1 = torch.full((n, 1), torch.inf, device=dev)
    e2 = e1.clone()
    i1 = torch.full((n, 1), kp, dtype=torch.int64, device=dev)
    i2 = i1.clone()
    for k0 in range(0, kp, ch):
        cb = bx[:, k0 : k0 + ch]
        tn = torch.full((n, ch), -torch.inf, device=dev)
        tf = torch.full((n, ch), torch.inf, device=dev)
        for a in range(3):
            t0 = ia[a] * cb[a : a + 1] - oa[a] * ia[a]
            t1 = ia[a] * cb[3 + a : 4 + a] - oa[a] * ia[a]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        enter = torch.clamp(tn, min=m.T_MIN)
        ent = torch.where(enter <= torch.minimum(tf, tmax_col), enter, torch.inf)
        c1, a1 = torch.min(ent, dim=1, keepdim=True)  # first index of the minimum
        ent2 = torch.where(col == a1, torch.inf, ent)
        c2, a2 = torch.min(ent2, dim=1, keepdim=True)
        g1, g2 = a1 + k0, a2 + k0
        # merge {(e1,i1),(e2,i2)} with {(c1,g1),(c2,g2)}; ties keep the carry
        take_c = c1 < e1
        ne1 = torch.where(take_c, c1, e1)
        ni1 = torch.where(take_c, g1, i1)
        lo2 = torch.where(take_c, e1, c1)
        li2 = torch.where(take_c, i1, g1)
        take_c2 = torch.minimum(e2, c2) < lo2
        use_e2 = e2 <= c2
        ne2 = torch.where(take_c2, torch.minimum(e2, c2), lo2)
        ni2 = torch.where(take_c2, torch.where(use_e2, i2, g2), li2)
        e1, i1, e2, i2 = ne1, ni1, ne2, ni2
    first = torch.where(torch.isinf(e1[:, 0]), k, torch.clamp(i1[:, 0], max=k))
    second = torch.where(torch.isinf(e2[:, 0]), k, torch.clamp(i2[:, 0], max=k))
    return first, second


def _meta_boxes(boxes, k: int, meta: int):
    """[8,K] boxes -> [8,KM] unions of ``meta`` consecutive clusters; pads
    (cmin >= 1e30) are left out, all-pad groups become far point boxes."""
    if meta <= 1:
        return boxes, k
    km = (k + meta - 1) // meta
    kp = km * meta
    bx = boxes
    if kp != k:
        bx = torch.cat([boxes, torch.full((8, kp - k), 3e37, device=boxes.device)], 1)
    real = bx[0:1] < 1e30
    lo = torch.where(real, bx[0:3], torch.inf).reshape(3, km, meta).amin(-1)
    hi = torch.where(real, bx[3:6], -torch.inf).reshape(3, km, meta).amax(-1)
    none = ~real.reshape(1, km, meta).any(-1)
    lo = torch.where(none, 3e37, lo)
    hi = torch.where(none, 3e37, hi)
    return torch.cat([lo, hi, torch.zeros((2, km), device=boxes.device)]), km


def auto_sort_mode(scene) -> str:
    """Sort mode for ``sort=True``: "cid2" for enclosed scenes (triangle
    area over AABB surface area > 0.6, e.g. cornell-box), else "morton"."""
    with span("owlpt.sync.scene"):
        v = scene.vertices.cpu().numpy()
    with span("owlpt.sync.scene"):
        tri = scene.tri_idx.cpu().numpy()
    p0 = v[tri[:, 0]]
    e1 = v[tri[:, 1]] - p0
    e2 = v[tri[:, 2]] - p0
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum()
    ext = np.maximum(v.max(0) - v.min(0), 1e-6)
    aabb_area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
    return "cid2" if tri_area / aabb_area > 0.6 else "morton"


def resolve_sort(sort) -> str | None:
    """False -> None, True -> "morton", else the mode string."""
    if not sort:
        return None
    mode = "morton" if sort is True else sort
    if mode not in ("cid2", "morton"):
        raise ValueError(f"unknown sort mode {mode!r}")
    return mode


def wave_sort_keys(ray_o, ray_d, t_max, fb: Fused2BVH, mode: str = "morton"):
    """Coherence key (< 2^30).  ``cid2``: (first candidate meta-cluster,
    second candidate, coarse morton) lexicographic; ``morton``: origin and
    direction cells."""
    if mode == "morton":
        return ray_sort_keys(ray_o, ray_d, fb.bounds)
    boxes, k = _meta_boxes(fb.boxes, fb.num_clusters, CID_META)
    first, second = _top2_candidates(ray_o, ray_d, t_max, boxes, k)
    kb = max(1, (k + 1).bit_length())  # bits for ids in [0, k]
    mb = 30 - 2 * kb  # leftover minor-key bits
    if mb < 0:  # beyond ~23k clusters: first candidate only
        kb = min(kb, 30)
        return first << (30 - kb)
    key = (first << (kb + mb)) | (second << mb)
    if mb > 0:
        morton = ray_sort_keys(ray_o, ray_d, fb.bounds)
        key = key | (morton >> max(0, 3 * (SORT_O_BITS + SORT_D_BITS) - mb))
    return key


def _inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


# ── traversal: kernel and plain version ───────────────────────────────────


def _check_mode(mode: str, fb: Fused2BVH, with_attrs: bool = True):
    if mode not in MODES:
        raise ValueError(f"unknown traversal mode {mode!r}; expected one of {MODES}")
    if mode == "closest" and not with_attrs and fb.layout == "mxu_bf16":
        # the in-plane tri id would be bf16-rounded; bf16 closest hit takes
        # its tri id and (t, u, v) from the f32 attribute planes
        raise ValueError("bf16 planes require with_attrs=True for closest-hit sweeps")


def _entry(fb: Fused2BVH, mode: str, with_attrs: bool, serial: bool = False) -> str:
    """Kernel entry point of a layout and mode (any-hit reads no attributes,
    mixed always does); ``serial`` picks the serial body of component closest
    hit or mixed."""
    attrs = mode == "mixed" or (mode == "closest" and with_attrs)
    if serial:
        if fb.mxu or (mode, attrs) not in (("closest", True), ("mixed", True)):
            raise ValueError("serial=True is the serial body of closest hit with attributes or of the mixed sweep on "
                             f"component planes; got layout {fb.layout}, mode {mode!r}, with_attrs={with_attrs}")
        return _ENTRY[("component_serial", mode, attrs)]
    return _ENTRY[(fb.layout, mode, attrs)]


def _ray_features(ray_o, ray_d, bf16: bool):
    """[n,10] ray features d, m = o x d, o, 1 (the MXU layout's rows 0-9;
    rows 10-15 are 0), rounded to nearest-even bf16 for bf16 planes."""
    ox, oy, oz = ray_o.unbind(-1)
    dx, dy, dz = ray_d.unbind(-1)
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    f = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, torch.ones_like(ox)], -1)
    return f.to(torch.bfloat16).float() if bf16 else f


# the non-zero rows of each MXU column group: (group, first row, end row)
MXU_ROWS = ((0, 0, 3), (1, 0, 6), (2, 0, 6), (3, 6, 10))


def _feature_sums(feat, planes, cid, cols, groups=MXU_ROWS, absolute=False):
    """Per column group, sum_r feat[:, r] * planes[cid, r, g*C + cols] over
    the group's non-zero rows in ascending order, in float32 (the zero rows
    would add exact zeros; bf16 planes widen exactly).  ``cols`` is
    ``slice(0, C)`` ([n,C] sums) or an [n] slot index ([n] sums).
    ``absolute``: the sums of |feat * plane| in the same order."""
    c = planes.shape[2] // 4
    term = torch.abs if absolute else (lambda x: x)  # noqa: E731
    sums = []
    for g, r0, r1 in groups:
        if isinstance(cols, slice):
            pl = planes[cid, r0:r1, g * c : (g + 1) * c].float()  # [n, rows, C]
            f = feat[:, r0:r1, None]
        else:
            pl = planes[cid, r0:r1, g * c + cols].float()  # [n, rows]
            f = feat[:, r0:r1]
        acc = term(f[:, 0] * pl[:, 0])
        for r in range(1, r1 - r0):
            acc = acc + term(f[:, r] * pl[:, r])
        sums.append(acc)
    return sums


def _mxu_intersect_chunk(planes, ray_o, ray_d, cb: ClusterBVH, cid, t_min, best_t):
    feat = _ray_features(ray_o, ray_d, planes.dtype == torch.bfloat16)
    det, ua, vb, tcd = _feature_sums(feat, planes, cid, slice(0, cb.cluster_size))  # [n,C] each
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    dd = det * sgn
    ua, vb, tcd = ua * sgn, vb * sgn, tcd * sgn
    # no tid >= 0 term: padding slots are all zero, so dd < 1e-12 drops them
    ok = ((dd >= 1e-12) & (ua >= 0.0) & (vb >= 0.0) & (ua + vb <= dd)
          & (tcd > dd * t_min) & (tcd < dd * best_t[:, None]))
    t = torch.where(ok, tcd / torch.where(dd < 1e-12, 1.0, dd), torch.inf)
    tj, j = torch.min(t, dim=-1)  # first index of the minimum
    hit = torch.isfinite(tj)
    rows = torch.arange(t.shape[0], device=t.device)
    dd_w = dd[rows, j]
    dd_w = torch.where(dd_w < 1e-12, 1.0, dd_w)
    uv = torch.stack([ua[rows, j] / dd_w, vb[rows, j] / dd_w], -1)
    tri = torch.where(hit, cb.tri_id[cid, j].long(), -1)
    return tj, tri, uv, j, hit


def mxu_slot_sums(ray_o, ray_d, fb: Fused2BVH, cid, slot):
    """Slot ``slot`` of cluster ``cid`` per ray (clamped to 0 where negative)
    -> (sums, absolute sums), each a list [det, u*det, v*det, t*det] of [N]
    tensors: the plain version's feature sums (:func:`_feature_sums`, on
    bf16-rounded features for bf16 planes) and the sums of their terms'
    magnitudes in the same float32 arithmetic, which bound how far another
    summation order or rounding (the tensor cores') can move each sum."""
    cid, slot = cid.long().clamp(min=0), slot.long().clamp(min=0)
    feat = _ray_features(ray_o, ray_d, fb.planes.dtype == torch.bfloat16)
    return (_feature_sums(feat, fb.planes, cid, slot),
            _feature_sums(feat, fb.planes, cid, slot, absolute=True))


def mxu_slot_test(ray_o, ray_d, fb: Fused2BVH, cid, slot, t_max):
    """The MXU layout's test of slot ``slot`` of cluster ``cid`` per ray, in
    the kernel's arithmetic -> (t, ok): the matmul-space t (t*det / det,
    what its loop compares and prunes with; inf where ``cid`` < 0, no
    winner) and whether the slot passes the window of :func:`_mxu_intersect`
    with best t = ``t_max`` [N].  For checks."""
    cid = cid.long()
    (det, ua, vb, tcd), _ = mxu_slot_sums(ray_o, ray_d, fb, cid, slot)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    dd, ua, vb, tcd = det * sgn, ua * sgn, vb * sgn, tcd * sgn
    ok = ((cid >= 0) & (dd >= 1e-12) & (ua >= 0.0) & (vb >= 0.0) & (ua + vb <= dd)
          & (tcd > dd * m.T_MIN) & (tcd < dd * t_max))
    return torch.where(cid >= 0, tcd / dd, torch.inf), ok


def _mxu_intersect(planes, ray_o, ray_d, cb: ClusterBVH, cid, t_min, best_t):
    """MXU-layout test of each ray against its cluster ``cid`` (the
    signature of ``cluster._intersect_cluster``) -> (t, tri, uv, slot, hit):
    the reference kernel's per-slot window and winner chain, the lowest slot
    winning a tie.  t is the matmul-space t*det / det, uv the winner's
    u*det / det and v*det / det, tri its id (the cluster query's, equal to
    plane row 10).  PLAIN_MXU_CHUNK rays at a time."""
    parts = [
        _mxu_intersect_chunk(planes, ray_o[lo : lo + PLAIN_MXU_CHUNK], ray_d[lo : lo + PLAIN_MXU_CHUNK],
                             cb, cid[lo : lo + PLAIN_MXU_CHUNK], t_min, best_t[lo : lo + PLAIN_MXU_CHUNK])
        for lo in range(0, ray_o.shape[0], PLAIN_MXU_CHUNK)
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


def _replay(ray_o, ray_d, fb: Fused2BVH, hit, cid, slot, t_loop):
    """Winner-geometry replay of the MXU layout -> (t, uv): mt_components on
    the winner's attribute rows 17-25 (t_min, inf), used where the winner's
    |det| > 1e-12; elsewhere the loop t stays and uv = 0."""
    g = fb.attrs[cid.clamp(min=0), 17:26, slot.clamp(min=0)]  # [n,9]
    comp = lambda a: a.unbind(-1)  # noqa: E731
    t3, u3, v3, _ = mt_components(comp(ray_o), comp(ray_d), comp(g[:, 0:3]), comp(g[:, 3:6]),
                                  comp(g[:, 6:9]), m.T_MIN, torch.inf)
    dx, dy, dz = comp(ray_d)
    e1x, e1y, e1z = comp(g[:, 3:6])
    e2x, e2y, e2z = comp(g[:, 6:9])
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    use = hit & (torch.abs(e1x * hx + e1y * hy + e1z * hz) > 1e-12)
    return torch.where(use, t3, t_loop), torch.where(use[:, None], torch.stack([u3, v3], -1), 0.0)


def fused2_traverse_packed_plain(rays, fb: Fused2BVH, mode: str = "closest", with_attrs: bool = True):
    """Plain PyTorch version of the kernel: [N,8] rays -> [N,32].

    An exact per-ray walk over the clusters whose boxes the ray enters, in
    entry order, testing each while its entry is nearer than the ray's best
    t (``cluster.cluster_query``), PLAIN_CHUNK rays at a time.  Component
    layout: Moller-Trumbore per slot; MXU layout: the feature products and
    the reference kernel's window (:func:`_mxu_intersect`).  Every ray is
    resolved (col 5 = 1) and the steps column stays 0.

    * ``closest``: t/u/v, tri, hit, winner cluster and slot, and the winner's
      attribute row follow the kernel's contract (misses: t = tmax,
      tri/cluster/slot = -1, zeros).  On the MXU layout (t, u, v) are
      replayed from the winner's geometry rows (:func:`_replay`).  With
      ``with_attrs=False`` (K4): the loop's t/u/v and tri id, a zero blob.
    * ``any_hit``: col 0 = tmax, col 4 = the walk's hit flag (any valid hit
      in (T_MIN, tmax): until a ray's first hit its best t is tmax, so every
      cluster it enters is tested), tri/cluster/slot = -1, everything else 0.
    * ``mixed``: the ``closest`` rows for every lane.  A shadow lane reads
      only col 4, and the closest-hit row's hit flag is its occlusion flag;
      the kernel's other columns of a shadow lane are not part of the
      contract.
    """
    _check_mode(mode, fb, with_attrs)
    attrs = mode == "mixed" or (mode == "closest" and with_attrs)
    intersect = functools.partial(_mxu_intersect, fb.planes) if fb.mxu else _intersect_cluster
    n = rays.shape[0]
    out = torch.zeros((n, OUT_COLS), dtype=torch.float32, device=rays.device)
    for lo in range(0, n, PLAIN_CHUNK):
        r = rays[lo : lo + PLAIN_CHUNK]
        o = out[lo : lo + PLAIN_CHUNK]
        o[:, 5] = 1.0
        t, tri, uv, cid, slot = cluster_query(r[:, 0:3], r[:, 3:6], fb.cluster, m.T_MIN, r[:, 6],
                                              intersect=intersect)
        hit = tri >= 0
        if mode == "any_hit":
            o[:, 0] = r[:, 6]
            o[:, 3] = -1.0
            o[:, 4] = hit.to(torch.float32)
            o[:, 7:9] = -1.0
            continue
        if attrs and fb.mxu:
            t, uv = _replay(r[:, 0:3], r[:, 3:6], fb, hit, cid, slot, t)
        o[:, 0] = t
        o[:, 1:3] = uv
        o[:, 3] = tri.to(torch.float32)
        o[:, 4] = hit.to(torch.float32)
        o[:, 7] = cid.to(torch.float32)
        o[:, 8] = slot.to(torch.float32)
        if attrs:
            o[:, 16:32] = torch.where(hit[:, None], fb.attr_table[tri.clamp(min=0)][:, :16], 0.0)
    return out


# ── shared memory and the frontier row ────────────────────────────────────

def _sized_entry(fb: Fused2BVH, mode: str, with_attrs: bool, serial: bool) -> str:
    """The entry whose counts stand for a launch of ``fb``'s layout and
    ``mode``; with ``serial`` the serial body's, in any mode (the profile
    entry runs it in every mode)."""
    return _ENTRY[("component_serial", "closest", True)] if serial else _entry(fb, mode, with_attrs)


def block_bytes(fb: Fused2BVH, mode: str, block: int, with_attrs: bool = True, serial: bool = False,
                global_row: bool = False) -> int:
    """Dynamic shared memory of one block (one CTA of the slot-parallel
    body) of the entry that ``fb``'s layout and ``mode`` launch at ``fb``'s
    K, with the frontier row in shared memory or (``global_row``) in device
    memory, as the kernel library counts it (``<entry>_shared_bytes``)."""
    name = _sized_entry(fb, mode, with_attrs, serial)
    if _cuda_lib is None:
        build_kernels()
    return getattr(_cuda_lib, f"{name}_shared_bytes")(fb.num_clusters, fb.cluster_size, block, int(global_row))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(name: str, k: int, c: int, block: int, global_row: bool, index: int) -> int:
    with torch.cuda.device(index):
        return _kernel_resources(_cuda_lib, name, k, c, block, int(global_row))["blocks_per_sm"]


def pick_row_form(what: str, k: int, c: int, block: int, nbytes: dict, limit: int, force: str | None = None,
                  blocks: dict | None = None) -> str:
    """Where a block of ``what`` keeps its frontier row at K clusters of C
    slots: "shared" wherever its bytes with the row in shared memory
    (``nbytes["shared"]``) fit under ``limit`` (the device's opt-in shared
    memory per block) and, given ``blocks`` (the blocks per SM of each
    form), the shared form keeps as many blocks per SM as the other; else
    "global" (a scratch [N / block, K] f32 in device memory;
    ``nbytes["global"]``).  ``force`` asks for one form (the card tests'
    private path).  Raises ValueError naming K, C, the block, the bytes and
    the limit where the form cannot launch, before any launch."""
    if force is not None and force not in ROW_FORMS:
        raise ValueError(f"row form {force!r}; expected one of {ROW_FORMS}")
    forms = (force,) if force else ROW_FORMS
    if force is None and blocks is not None and blocks["global"] > blocks["shared"]:
        forms = ("global",)
    for form in forms:
        if nbytes[form] <= limit:
            return form
    raise ValueError(
        f"fused2 {what} at K={k} clusters of C={c}, block {block}: {nbytes[form]} bytes of shared memory per block "
        f"with the frontier row in {'shared' if form == 'shared' else 'device'} memory, above the device's limit "
        f"of {limit} bytes")


def row_form(fb: Fused2BVH, mode: str, block: int, device, with_attrs: bool = True, serial: bool = False,
             force: str | None = None) -> str:
    """:func:`pick_row_form` for the entry of ``fb``'s layout and ``mode``
    at ``fb``'s K on the CUDA ``device``, from the kernel library's byte
    counts of both forms and, where both fit, the blocks per SM the CUDA
    runtime gives each (the f32 tensor-core entries, for one, need fewer
    registers with the row in device memory and keep twice the blocks)."""
    index = device if isinstance(device, int) else torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    limit = _smem_limit(index)
    nbytes = {form: block_bytes(fb, mode, block, with_attrs, serial, form == "global") for form in ROW_FORMS}
    blocks = None
    if force is None and nbytes["shared"] <= limit:
        name = _sized_entry(fb, mode, with_attrs, serial)
        blocks = {form: _blocks_per_sm(name, fb.num_clusters, fb.cluster_size, block, form == "global", index)
                  for form in ROW_FORMS}
    what = f"{fb.layout} {mode}{' serial' if serial else ''}"
    return pick_row_form(what, fb.num_clusters, fb.cluster_size, block, nbytes, limit, force, blocks)


def smem_limit(device) -> int:
    """The opt-in shared memory per block of a CUDA ``device``, in bytes."""
    device = torch.device(device)
    return _smem_limit(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    if _cuda_lib is None:
        build_kernels()
    limit = getattr(_cuda_lib, LIMIT_ENTRY)(index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:{index}")
    return limit


def build_kernels() -> tuple:
    """Build (if needed) and load the kernel library -> (path, seconds, log)."""
    global _cuda_lib
    path, seconds, log = build_cuda_library("owlpt_fused2", [CSRC], depends=[TENSOR_OPS])
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(path))
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            # slot-parallel: order, bent0, entered ... global_row; serial body: rows
            slot = name in _SLOT_ENTRIES
            scratch = [ctypes.c_void_p] * (3 if slot else 1)
            fn.argtypes = ([ctypes.c_void_p] * 5 + scratch + [ctypes.c_longlong] + [ctypes.c_int] * (7 if slot else 6)
                           + [ctypes.c_void_p])
            bind_resources(lib, name, extra=1)
            fn = getattr(lib, f"{name}_shared_bytes")
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int] * 4
        fn = getattr(lib, SUMS_ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn = getattr(lib, PROFILE_ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
        fn = getattr(lib, SHAPE_ENTRY)
        fn.restype = None
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn = getattr(lib, LIMIT_ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        _cuda_lib = lib
    return path, seconds, log


def kernel_resources(fb: Fused2BVH, mode: str = "closest", block: int = BLOCK_RAYS, with_attrs: bool = True,
                     serial: bool = False, row: str | None = None) -> dict:
    """Registers, shared bytes and blocks per SM (``native.kernel_resources``),
    threads per CTA, CTAs per block of rays and the frontier row's form
    ("row") of the entry that ``fb``'s layout and ``mode`` launch for blocks
    of ``block`` rays on the current CUDA device, in the form that launches
    (:func:`row_form`; ``row`` asks for one)."""
    name = _entry(fb, mode, with_attrs, serial)
    if _cuda_lib is None:
        build_kernels()
    form = row_form(fb, mode, block, torch.cuda.current_device(), with_attrs, serial, row)
    res = _kernel_resources(_cuda_lib, name, fb.num_clusters, fb.cluster_size, block, int(form == "global"))
    res["threads"], res["ctas"], res["row"] = block, 1, form
    if not fb.mxu and not serial:  # the slot-parallel body
        res["threads"], res["ctas"], _ = _slot_shape(fb.cluster_size, mode)
    return res


@functools.lru_cache(maxsize=None)
def _slot_shape(c: int, mode: str) -> tuple:
    """(threads per CTA, CTAs per block of rays, ordered blocks) of the
    slot-parallel component entries at C and ``mode``, as the kernel
    library launches them."""
    shape = (ctypes.c_int * 3)()
    getattr(_cuda_lib, SHAPE_ENTRY)(c, MODES.index(mode), shape)
    return shape[0], shape[1], bool(shape[2])


def _check_operand(name, x, shape, device, dtype=torch.float32):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte aligned rows; data_ptr is not")


def _fused2_traverse_cuda(rays, fb: Fused2BVH, block: int, max_steps: int, mode: str = "closest",
                          fanout: int = FANOUT, with_attrs: bool = True, serial: bool = False, profile: bool = False,
                          row: str | None = None):
    """Launch the kernel entry of ``fb``'s layout and ``mode`` on the current
    stream -> [N,32] (no sync); with ``profile`` the profile entry instead
    (component layout) -> ([N,32], [N/block, PROFILE_COLS] int64).  The
    frontier rows take :func:`row_form`'s form, or ``row``'s (checks of the
    global form at small K)."""
    _check_mode(mode, fb, with_attrs)
    if profile:
        if fb.mxu:
            raise ValueError(f"the profile entry runs the component layout; got {fb.layout}")
        name = PROFILE_ENTRY
    else:
        name = _entry(fb, mode, with_attrs, serial)
    if rays.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the fused2 kernel needs CUDA tensors on a CUDA device; got {rays.device}")
    n = rays.shape[0]
    k, c = fb.num_clusters, fb.cluster_size
    if not fb.mxu:
        fanout = 1  # the component layout retires one cluster per iteration
    if block % 32 or not 32 <= block <= 1024 or n % block:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024] dividing N={n}")
    _check_operand("rays", rays, (n, 8), rays.device)
    _check_operand("boxes", fb.boxes, (8, k), rays.device)
    _check_operand("planes", fb.planes, (k, 16, 4 * c if fb.mxu else c), rays.device,
                   torch.bfloat16 if fb.layout == "mxu_bf16" else torch.float32)
    _check_operand("attrs", fb.attrs, (k, ATTR_ROWS, c), rays.device)
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=rays.device)
    prof = torch.empty((n // block, len(PROFILE_COLS)), dtype=torch.int64, device=rays.device) if profile else None
    if n == 0:
        return (out, prof) if profile else out
    if _cuda_lib is None:
        build_kernels()
    # before any launch: the form of the frontier rows, or a ValueError
    glob = row_form(fb, mode, block, rays.device, with_attrs, serial, row) == "global"
    blocks = n // block
    args = (rays.data_ptr(), fb.boxes.data_ptr(), fb.planes.data_ptr(), fb.attrs.data_ptr(), out.data_ptr())
    if profile or name in _SLOT_ENTRIES:
        # the slot-parallel body's scratch where it orders the blocks: first
        # frontiers bent0 [blocks, K] f32 (the global form's rows too), then
        # the order and the entered counts [blocks] int32 each, in one
        # allocation; the global form's rows alone where it does not order
        # them (any-hit; the profile entry's serial body); else null pointers
        ptrs = (None, None, None)
        if not serial and _slot_shape(c, mode)[2]:
            scratch = torch.empty(blocks * (k + 2), dtype=torch.float32, device=rays.device)
            base = scratch.data_ptr()
            ptrs = (base + 4 * blocks * k, base, base + 4 * blocks * (k + 1))  # order, bent0, entered
        elif glob:
            scratch = torch.empty(blocks * k, dtype=torch.float32, device=rays.device)
            ptrs = (None, scratch.data_ptr(), None)
        args += ptrs
    else:  # the serial body: the global form's rows [blocks, K] f32, else a null pointer
        scratch = torch.empty(blocks * k, dtype=torch.float32, device=rays.device) if glob else None
        args += (None if scratch is None else scratch.data_ptr(),)
    args += (n, k, c, block, max_steps, REFRESH_CLUSTERS)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        if profile:
            err = getattr(_cuda_lib, name)(*args, MODES.index(mode), int(with_attrs), int(serial), int(glob),
                                           prof.data_ptr(), stream)
        elif name in _SLOT_ENTRIES:
            err = getattr(_cuda_lib, name)(*args, fanout, int(glob), stream)
        else:
            err = getattr(_cuda_lib, name)(*args, fanout, stream)
    if err != 0:
        raise RuntimeError(f"fused2 kernel {name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return (out, prof) if profile else out


def mxu_tensor_sums(rays, fb: Fused2BVH, cids):
    """The f32 tensor-core feature sums on the card (a diagnostic entry, off
    every render path): for the 32 packed rays of each warp w ([N,8], N a
    multiple of 32) and cluster ``cids[w]`` ([N/32] int), det | u*det | v*det
    | t*det of every slot -> [N,4,C], by the staging and products of the f32
    tensor-core traversal (compare :func:`mxu_slot_sums`)."""
    if rays.device.type != "cuda" or fb.layout != "mxu_f32":
        raise ValueError(f"mxu_tensor_sums needs f32 MXU planes and CUDA rays; got {fb.layout} on {rays.device}")
    n, c = rays.shape[0], fb.cluster_size
    if n % 32 or tuple(cids.shape) != (n // 32,):
        raise ValueError(f"{n} rays are not whole warps of 32, or cids has shape {tuple(cids.shape)}")
    _check_operand("rays", rays, (n, 8), rays.device)
    _check_operand("planes", fb.planes, (fb.num_clusters, 16, 4 * c), rays.device)
    cids = cids.to(device=rays.device, dtype=torch.int32).contiguous()
    out = torch.empty((n, 4, c), dtype=torch.float32, device=rays.device)
    if _cuda_lib is None:
        build_kernels()
    with torch.cuda.device(rays.device):
        err = getattr(_cuda_lib, SUMS_ENTRY)(rays.data_ptr(), fb.planes.data_ptr(), cids.data_ptr(), out.data_ptr(),
                                             n, c, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{SUMS_ENTRY} launch failed: CUDA error {err}")
    return out


def fused2_traverse(ray_o, ray_d, t_max, fb: Fused2BVH, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                    with_attrs: bool = True, any_hit: bool = False, fanout: int = FANOUT):
    """Raw sweep of unpacked rays -> [N,32] (closest hit, or any-hit with
    ``any_hit``): :func:`pack_rays`, then :func:`fused2_traverse_packed`.
    N must be a multiple of ``block``."""
    return fused2_traverse_packed(pack_rays(ray_o, ray_d, t_max), fb, block=block, max_steps=max_steps,
                                  mode="any_hit" if any_hit else "closest", fanout=fanout, with_attrs=with_attrs)


def fused2_traverse_packed(rays, fb: Fused2BVH, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                           mode: str = "closest", fanout: int = FANOUT, with_attrs: bool = True,
                           serial: bool = False):
    """[N,8] packed rays -> [N,32] in ``mode``: the kernel for CUDA tensors,
    the plain version for CPU tensors.  N must be a multiple of ``block``.
    ``fanout`` (clusters retired per loop iteration, MXU layout only) does
    not change the answers; ``with_attrs=False`` is closest hit without
    attributes (K4); ``serial=True`` (component planes, closest hit with
    attributes or mixed) launches the serial body (one thread per ray)
    instead of the slot-parallel one, with the same outputs."""
    rays = rays.detach()  # no kernel has a backward pass; the plain version gets none either
    if rays.device.type == "cpu":
        if serial:
            _entry(fb, mode, with_attrs, serial)  # the same argument check as on the card
        return fused2_traverse_packed_plain(rays, fb, mode, with_attrs)
    return _fused2_traverse_cuda(rays, fb, block, max_steps, mode, fanout, with_attrs, serial)


def fused2_traverse_profile(rays, fb: Fused2BVH, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                            mode: str = "closest", with_attrs: bool = True, serial: bool = False):
    """The profile entry (CUDA tensors, component planes; no render path):
    the slot-parallel body, or with ``serial`` the serial one, in ``mode``
    with clock64 phase cycles per block -> (out [N,32] as
    :func:`fused2_traverse_packed`, profile [N/block, PROFILE_COLS] int64).
    Any-hit and K4 (``with_attrs=False``) have no serial entry; this is
    where their serial body runs.  Counted in LAUNCHES[PROFILE_ENTRY]."""
    if rays.device.type != "cuda":
        raise RuntimeError(f"the fused2 profile entry needs CUDA tensors; got {rays.device}")
    return _fused2_traverse_cuda(rays.detach(), fb, block, max_steps, mode, 1, with_attrs, serial=serial,
                                 profile=True)


def _sweep(ray_o, ray_d, t_max, fb: Fused2BVH, sort, block: int, max_steps: int, mode: str,
           fanout: int, shadow=None, with_attrs: bool = True):
    """Pad to whole blocks, pack, optionally sort by the coherence key (the
    shadow class on key bit 30), traverse in ``mode`` and unsort -> [N,32]
    rows of the first N (unpadded) rays (``pack_rays`` detaches them)."""
    n0 = ray_o.shape[0]
    ray_o_p, ray_d_p, t_max_p, _ = _pad_rays(ray_o, ray_d, t_max, block)
    if shadow is not None:
        shadow = torch.cat([shadow, shadow.new_zeros(ray_o_p.shape[0] - n0)])
    rays = pack_rays(ray_o_p, ray_d_p, t_max_p, shadow)
    sort_mode = resolve_sort(sort)
    if not sort_mode:
        return fused2_traverse_packed(rays, fb, block=block, max_steps=max_steps, mode=mode,
                                      fanout=fanout, with_attrs=with_attrs)[:n0]
    with span("owlpt.sort"):
        keys = wave_sort_keys(ray_o_p, ray_d_p, t_max_p, fb, mode=sort_mode)
        if shadow is not None:
            keys = keys | (shadow.to(torch.int64) << SHADOW_CLASS_BIT)
        perm = torch.sort(keys, stable=True).indices
        rays, unsort = rays[perm], _inverse_perm(perm)
    out = fused2_traverse_packed(rays, fb, block=block, max_steps=max_steps, mode=mode,
                                 fanout=fanout, with_attrs=with_attrs)
    return out[unsort][:n0]


def _hits_from_output(out, ray_o, ray_d, fb: Fused2BVH, t_min, t_max):
    """[N,32] traversal output -> (HitRecord, attr blob [N,16]).

    Rows the kernel left unresolved get the exact cluster query's answer and
    the attribute-table row of its winner; a miss keeps a zero payload, as
    on the resolved path (the JAX package gives such a miss row 0 of the
    table, which no caller reads).  Everything it returns is detached, the
    fallback's answers too (the JAX package stops their gradient)."""
    global UNRESOLVED_RAYS
    ray_o, ray_d, t_max = _detached(ray_o, ray_d, t_max)
    t = out[:, 0].clone()
    hit = out[:, 4] > 0.0
    tri = torch.where(hit, out[:, 3].to(torch.int64), -1)
    uv = out[:, 1:3].clone()
    blob = out[:, 16:32].clone()
    t_max = _t_max_rows(t_max, out.shape[0], out.device, "owlpt.sync.hit_t_max")
    with span("owlpt.sync.resolved"):
        rows = torch.nonzero(out[:, 5] <= 0.0).squeeze(1)
    if rows.numel():
        UNRESOLVED_RAYS += rows.numel()
        with span("owlpt.unresolved"):
            rec = cluster_closest_hit(ray_o[rows], ray_d[rows], fb.cluster, t_min=t_min, t_max=t_max[rows])
            t[rows] = rec.t
            tri[rows] = rec.tri
            uv[rows] = rec.uv
            blob[rows] = torch.where(rec.hit[:, None], fb.attr_table[rec.tri.clamp(min=0)][:, :16], 0.0)
    t = torch.where(tri >= 0, t, t_max)
    return HitRecord(t=t, tri=tri, uv=uv), blob


def fused2_closest_hit(ray_o, ray_d, fb: Fused2BVH, t_min: float = m.T_MIN, t_max=m.T_MAX,
                       sort=False, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                       with_attrs: bool = True, fanout: int = FANOUT):
    """Exact closest hit + shading payload -> (HitRecord, attr_blob [N,16]).

    Pads to whole blocks; with ``sort`` ("morton", "cid2" or True) stably
    sorts the packed rays by a coherence key before the traversal and
    unsorts after.  ``with_attrs=False`` (f32 planes only) returns the
    loop's t/u/v and in-plane tri id and a zero blob for resolved rows."""
    out = _sweep(ray_o, ray_d, t_max, fb, sort, block, max_steps, "closest", fanout,
                 with_attrs=with_attrs)
    return _hits_from_output(out, ray_o, ray_d, fb, t_min, t_max)


def fused2_occluded(ray_o, ray_d, fb: Fused2BVH, t_min: float = m.T_MIN, t_max=m.T_MAX,
                    sort=False, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                    fanout: int = FANOUT):
    """Any-hit occlusion -> [N] bool: is there a valid hit in (t_min, t_max)?

    The first valid hit retires a ray (terminate-on-first-hit).  Pads, sorts
    and unsorts like :func:`fused2_closest_hit`; rows a block leaves
    unresolved take ``cluster_occluded`` on the detached rays."""
    global UNRESOLVED_RAYS
    ray_o, ray_d, t_max = _detached(ray_o, ray_d, t_max)
    out = _sweep(ray_o, ray_d, t_max, fb, sort, block, max_steps, "any_hit", fanout)
    occ = out[:, 4] > 0.0
    with span("owlpt.sync.resolved"):
        rows = torch.nonzero(out[:, 5] <= 0.0).squeeze(1)
    if rows.numel():
        UNRESOLVED_RAYS += rows.numel()
        with span("owlpt.unresolved"):
            t_max = torch.as_tensor(t_max, dtype=torch.float32, device=out.device).expand(out.shape[0])
            occ[rows] = cluster_occluded(ray_o[rows], ray_d[rows], fb.cluster, t_min, t_max[rows])
    return occ


def fused2_sweep_mixed(ray_o, ray_d, t_max, shadow, fb: Fused2BVH, t_min: float = m.T_MIN,
                       sort=False, block: int = BLOCK_RAYS, max_steps: int = MAX_STEPS,
                       fanout: int = FANOUT):
    """One kernel sweep over closest-hit and shadow (any-hit) lanes.

    ``shadow`` [N] bool marks the any-hit lanes.  Returns (HitRecord,
    attr_blob, occluded): the hit record and blob are meaningful for
    closest-hit lanes (misses get t = T_MAX), ``occluded`` for shadow lanes.
    The deferred-NEE wavefront pairs each lane's bounce ray with the previous
    vertex's shadow ray; with ``sort`` the shadow class is the top key bit,
    so sorted blocks stay pure and keep the any-hit early exit.  Unresolved
    rows get the exact cluster query, whose closest hit gives both answers
    (occluded iff it hit)."""
    out = _sweep(ray_o, ray_d, t_max, fb, sort, block, max_steps, "mixed", fanout, shadow=shadow)
    rec, blob = _hits_from_output(out, ray_o, ray_d, fb, t_min, t_max)
    occluded = rec.tri >= 0
    t = torch.where(occluded, rec.t, m.T_MAX)
    return HitRecord(t=t, tri=rec.tri, uv=rec.uv), blob, occluded


def make_fused2_intersector(fb: Fused2BVH, **kw):
    """Intersector returning (HitRecord, attr_blob)."""

    def intersect(ray_o, ray_d):
        return fused2_closest_hit(ray_o, ray_d, fb, **kw)

    return intersect


def fused2_closest_hit_diff(ray_o, ray_d, fb: Fused2BVH, vertices, tri_idx, **kw):
    """:func:`fused2_closest_hit` with differentiable hit geometry -> (HitRecord, attr_blob).

    The traversal picks the winning triangle on detached rays (a discrete
    choice); t, u and v are then derived again in plain PyTorch from the
    live rays and the winner's vertices, by the pvec/qvec Moller-Trumbore
    form with the same ``det`` guard, so camera gradients (and geometry
    gradients, where ``vertices`` requires them) flow through hit positions.
    The refit's values lie within rounding of the traversal's; rows where
    the winner's ``det`` is degenerate keep the traversal's answer.  The
    blob stays detached."""
    rec, blob = fused2_closest_hit(ray_o, ray_d, fb, **kw)
    hit = rec.tri >= 0
    tri = tri_idx[rec.tri.clamp(min=0)].long()
    p0 = vertices[tri[:, 0]]
    e1 = vertices[tri[:, 1]] - p0
    e2 = vertices[tri[:, 2]] - p0
    pvec = torch.linalg.cross(ray_d, e2)
    det = _dot3(e1, pvec)
    det_ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(det_ok, det, 1.0)
    tvec = ray_o - p0
    u = _dot3(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1)
    v = _dot3(ray_d, qvec) * inv
    t = _dot3(e2, qvec) * inv
    use = hit & det_ok
    return HitRecord(t=torch.where(use, t, rec.t), tri=rec.tri,
                     uv=torch.where(use[:, None], torch.stack([u, v], -1), rec.uv)), blob


def _dot3(a, b):
    """Row dot product of [N,3] tensors, summed left to right."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def make_fused2_intersector_diff(fb: Fused2BVH, vertices, tri_idx, **kw):
    """Intersector of :func:`fused2_closest_hit_diff` (the gradient path's)."""

    def intersect(ray_o, ray_d):
        return fused2_closest_hit_diff(ray_o, ray_d, fb, vertices, tri_idx, **kw)

    return intersect
