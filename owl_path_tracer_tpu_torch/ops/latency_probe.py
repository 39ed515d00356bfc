"""Retirement-loop latency probe (counterpart of ``tools/tpu_probe6.py``'s
``mini_kernel`` and ``run_variant``).

The skeleton of the fused2 retirement loop with its stages switched on or
off one at a time, so that the slope of a launch's time over the loop's trip
count splits one iteration into pick, copy, product and loop control.  One
block of ``block`` rays per grid row:

  phase A  every ray slab-tests every cluster box; ``front`` [K] is the
           block's nearest entry into each cluster over the rays that need
           it, and each of the P chains starts its own row as a copy of it
           (so the chains of ``interleave<P>`` pick the same clusters);
  loop     ``trips = iters // P`` iterations, each running the P chains in
           turn:
             pick     the row's minimum, lowest id among equal entries, then
                      retire it (an all-inf row keeps picking cluster 0);
                      without it the cluster is ``(i*P + p) % K``;
             copy     the cluster's [16,4C] feature planes into the chain's
                      buffer;
             product  [B,16] ray features x [16,4C] planes, the window test
                      of the MXU layout against the block's best t, and the
                      best-t update.
The output [G,B,16] holds the best t in column 0 and zeros elsewhere: the
result only keeps the work from being optimised away.

Variants (``VARIANTS``, the names ``run_variant`` accepts): ``nop_loop``
(empty body: the loop-control floor), ``pick_only``, ``sched_mm`` (product on
a buffer nothing fills), ``sched_mm_bf16``, ``sched_mm_recip``, ``sched_dma``,
``sched_dma_bf16``, ``sched_dma_mm``, ``pick_dma_mm``, ``pick_dma_mm_bf16``
(bf16 and the approximate reciprocal) and ``interleave<P>``.

:func:`latency_probe` launches the CUDA kernel (``csrc/latency_probe.cu``)
for CUDA tensors and raises if it cannot; for CPU tensors it takes
:func:`latency_probe_plain`.  Differences from the reference, on purpose:

  * ``sched_mm*`` read a buffer that nothing fills (the reference reads
    scratch memory it never writes, zeros in interpret mode); here the
    buffer is zero-filled before the loop, so those variants never hit;
  * the kernel copies a cluster in column tiles of ``tile`` slots
    (:func:`tile_cols`) where P whole [16,4C] buffers do not fit in one
    block's shared memory; every chain still copies and tests the whole
    cluster each iteration;
  * the plain version divides exactly where ``*_recip`` asks for the
    approximate reciprocal (the kernel's ``rcp.approx``).
The reference's ``"pipe"`` copy mode is reached by no variant and is not
ported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from ..native import build_cuda_library
from . import math as m
from .fused2 import _check_operand

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "latency_probe.cu"
ENTRY = "owlpt_latency_probe"
REPLACES = "tools/tpu_probe6.py:68"

# run_variant's defaults (tools/tpu_probe6.py:48)
DEFAULT_VARIANTS = ("nop_loop", "pick_only", "sched_mm", "sched_dma", "sched_dma_mm", "pick_dma_mm",
                    "interleave2", "interleave4")
FEATURES = 16  # ray feature rows ([d, o x d, o, 1, 0 x 6])
GROUPS = 4  # plane column groups: det | u*det | v*det | t*det
OUT_COLS = 16
MAX_CHAINS = 16  # chains the kernel keeps cluster ids for
TILE_ALIGN = 8  # tile widths are multiples of 8 slots (16-byte copies of bf16 and f32)
# rays per plain-version pass (bounds its [n,4C] products)
PLAIN_CHUNK = 8192

# launches of the CUDA kernel (one per call that ran it)
LAUNCHES = {ENTRY: 0}

_cuda_lib = None


def reset_counts():
    """Set the launch count to 0."""
    LAUNCHES[ENTRY] = 0


@dataclasses.dataclass(frozen=True)
class Variant:
    """Which stages a variant runs (``run_variant``'s flags)."""

    name: str
    pick: bool = False
    copy: bool = False
    mm: bool = False
    bf16: bool = False
    recip: bool = False
    chains: int = 1

    @property
    def flags(self) -> int:
        """The kernel's stage bits: 1 pick, 2 copy, 4 product, 8 bf16, 16 approximate reciprocal."""
        return self.pick | self.copy << 1 | self.mm << 2 | self.bf16 << 3 | self.recip << 4


VARIANTS = {
    v.name: v
    for v in (
        Variant("nop_loop"),
        Variant("pick_only", pick=True),
        Variant("sched_mm", mm=True),
        Variant("sched_mm_bf16", mm=True, bf16=True),
        Variant("sched_mm_recip", mm=True, recip=True),
        Variant("sched_dma", copy=True),
        Variant("sched_dma_bf16", copy=True, bf16=True),
        Variant("sched_dma_mm", copy=True, mm=True),
        Variant("pick_dma_mm", pick=True, copy=True, mm=True),
        Variant("pick_dma_mm_bf16", pick=True, copy=True, mm=True, bf16=True, recip=True),
    )
}


def variant(name: str) -> Variant:
    """The variant of a name, ``interleave<P>`` included; raises ValueError otherwise."""
    if name in VARIANTS:
        return VARIANTS[name]
    if name.startswith("interleave") and name[len("interleave"):].isdigit():
        chains = int(name[len("interleave"):])
        if not 1 <= chains <= MAX_CHAINS:
            raise ValueError(f"{name}: the kernel runs 1 to {MAX_CHAINS} chains")
        return Variant(name, pick=True, copy=True, mm=True, chains=chains)
    raise ValueError(name)


def trips(v: Variant, iters: int) -> int:
    """Loop iterations of a launch: ``iters // P`` (P chains run per iteration)."""
    return max(iters // v.chains, 0)


# ── tiling ────────────────────────────────────────────────────────────────


def shared_bytes(k: int, chains: int, block: int, tile: int, bf16: bool) -> int:
    """Dynamic shared memory of one block (``shared_bytes`` in the kernel
    source): the chains' rows [P,K], the block's rays [10,B] and 64
    reduction words as float32 (padded to 16 bytes), then P buffers of
    [16,4,tile] plane elements."""
    head = (chains * k + 10 * block + 64 + 3) & ~3
    return 4 * head + chains * FEATURES * GROUPS * tile * (2 if bf16 else 4)


def tile_cols(c: int, k: int, chains: int, block: int, bf16: bool, limit: int) -> int:
    """Slots per copied tile: the whole cluster (C) when the P buffers fit
    in ``limit`` bytes of shared memory, else C halved while it fits no
    more and stays a multiple of TILE_ALIGN.  Raises where even the smallest
    tile per chain does not fit."""
    if c % TILE_ALIGN:
        raise ValueError(f"cluster size C={c} must be a multiple of {TILE_ALIGN}")
    tile = c
    while shared_bytes(k, chains, block, tile, bf16) > limit and tile % (2 * TILE_ALIGN) == 0:
        tile //= 2
    if shared_bytes(k, chains, block, tile, bf16) > limit:
        raise ValueError(
            f"{chains} chain(s) at K={k}, B={block}: {shared_bytes(k, chains, block, tile, bf16)} bytes of shared "
            f"memory even with tiles of {tile} slots, above the device's {limit}")
    return tile


# ── plain version ─────────────────────────────────────────────────────────


def probe_features(rays, bf16: bool):
    """[n,8] rays -> [n,16] features d, m = o x d, o, 1, zeros (bf16-rounded
    for the bf16 variants)."""
    ox, oy, oz, dx, dy, dz = rays[:, 0:6].unbind(-1)
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    f = torch.stack([dx, dy, dz, mx, my, mz, ox, oy, oz, torch.ones_like(ox)], -1)
    f = torch.cat([f, torch.zeros_like(f[:, :6])], -1)
    return f.to(torch.bfloat16).float() if bf16 else f


def _inv(dc):
    return 1.0 / torch.where(torch.abs(dc) < 1e-12, torch.where(dc < 0, -1e-12, 1e-12), dc)


def front_rows(rays, boxes):
    """Phase A: [G,B,8] rays, [8,K] boxes -> [G,K] block minimum of each
    cluster's slab entry over the rays that need it (inf where none does).
    ``ia*bmin - o*ia`` with NaN-propagating min/max, as the reference."""
    o, tmx = rays[..., 0:3], rays[..., 6:7]
    ia = _inv(rays[..., 3:6])
    tn = tf = None
    for a in range(3):
        oi = o[..., a : a + 1] * ia[..., a : a + 1]
        t0 = ia[..., a : a + 1] * boxes[a] - oi
        t1 = ia[..., a : a + 1] * boxes[3 + a] - oi
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    t_enter = torch.clamp(tn, min=m.T_MIN)
    need = t_enter <= torch.minimum(tf, tmx)
    return torch.where(need, t_enter, torch.inf).amin(dim=1)


def _pick(bent, col, k: int):
    """[G,K] rows -> [G] lowest id of each row's minimum (k-1 where none
    equals it), then retire it in place."""
    mn = bent.amin(-1, keepdim=True)
    cid = torch.where(bent == mn, col, k - 1).amin(-1)
    bent.scatter_(1, cid[:, None], torch.inf)
    return cid


def _chain_best(feat, pl, best):
    """One chain's product and window on [g,B,16] features and its [g,16,4C]
    planes -> best t after it.  The 16 feature products are summed in
    ascending row order without FMA, the kernel's order."""
    c = pl.shape[2] // GROUPS
    acc = feat[:, :, 0:1] * pl[:, None, 0]
    for r in range(1, FEATURES):
        acc = acc + feat[:, :, r : r + 1] * pl[:, None, r]
    det, ua, vb, tcd = acc.split(c, dim=-1)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    dd, ua, vb, tcd = det * sgn, ua * sgn, vb * sgn, tcd * sgn
    ok = ((dd >= 1e-12) & (ua >= 0.0) & (vb >= 0.0) & (ua + vb <= dd) & (tcd > dd * m.T_MIN)
          & (tcd < dd * best[..., None]))
    t = torch.where(ok, tcd / torch.where(dd < 1e-12, 1.0, dd), torch.inf)
    tc = t.amin(-1)
    return torch.where(tc < best, tc, best)


def _probe_blocks(rays, boxes, planes, v: Variant, n_trips: int):
    """The probe on [g,B,8] rays (whole blocks) -> [g,B] best t."""
    g = rays.shape[0]
    k = boxes.shape[1]
    dev = rays.device
    best = rays[..., 6].clone()
    if not v.mm:  # picks and copies alone leave best t = t_max
        return best
    front = front_rows(rays, boxes)
    bent = [front.clone() for _ in range(v.chains)]
    feat = probe_features(rays.reshape(-1, 8), v.bf16).view(g, -1, FEATURES)
    col = torch.arange(k, device=dev)
    zeros = torch.zeros((g, FEATURES, planes.shape[2]), device=dev)
    for i in range(n_trips):
        for p in range(v.chains):
            if v.pick:
                cid = _pick(bent[p], col, k)
            else:
                cid = torch.full((g,), (i * v.chains + p) % k, dtype=torch.int64, device=dev)
            pl = planes[cid].float() if v.copy else zeros
            best = _chain_best(feat, pl, best)
    return best


def latency_probe_plain(rays, boxes, planes, variant_name: str, iters: int, block: int):
    """Plain PyTorch version of the kernel: [N,8] rays (``fused2.pack_rays``),
    [8,K] boxes, [K,16,4C] planes of the variant's dtype -> [N/B,B,16].
    Blocks are independent; PLAIN_CHUNK rays at a time."""
    v = variant(variant_name)
    _check_shapes(rays, boxes, planes, v, block)
    n = rays.shape[0]
    g = n // block
    out = torch.zeros((g, block, OUT_COLS), dtype=torch.float32, device=rays.device)
    per = max(1, PLAIN_CHUNK // block)
    rr = rays.view(g, block, 8)
    for lo in range(0, g, per):
        out[lo : lo + per, :, 0] = _probe_blocks(rr[lo : lo + per], boxes, planes, v, trips(v, iters))
    return out


def _check_shapes(rays, boxes, planes, v: Variant, block: int):
    n = rays.shape[0]
    if block % 32 or not 32 <= block <= 1024 or n % block:
        raise ValueError(f"block {block} must be a multiple of 32 in [32, 1024] dividing N={n}")
    k = boxes.shape[1]
    if tuple(rays.shape) != (n, 8) or tuple(boxes.shape) != (8, k) or planes.dim() != 3 \
            or tuple(planes.shape[:2]) != (k, FEATURES) or planes.shape[2] % GROUPS:
        raise ValueError(f"rays {tuple(rays.shape)}, boxes {tuple(boxes.shape)}, planes {tuple(planes.shape)}: "
                         "expected [N,8], [8,K], [K,16,4C]")
    want = torch.bfloat16 if v.bf16 else torch.float32
    if planes.dtype != want:
        raise ValueError(f"{v.name} reads {want} planes, got {planes.dtype}")


# ── kernel ────────────────────────────────────────────────────────────────


def build_kernels() -> tuple:
    """Build (if needed) and load the kernel library -> (path, seconds, log)."""
    global _cuda_lib
    path, seconds, log = build_cuda_library("owlpt_latency_probe", [CSRC])
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.owlpt_latency_probe_smem_limit.restype = ctypes.c_int
        lib.owlpt_latency_probe_smem_limit.argtypes = [ctypes.c_int]
        lib.owlpt_latency_probe_shared_bytes.restype = ctypes.c_longlong
        lib.owlpt_latency_probe_shared_bytes.argtypes = [ctypes.c_int] * 5
        _cuda_lib = lib
    return path, seconds, log


def smem_limit(device) -> int:
    """The opt-in shared memory per block of a CUDA ``device``, in bytes."""
    device = torch.device(device)
    return _smem_limit(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    if _cuda_lib is None:
        build_kernels()
    limit = _cuda_lib.owlpt_latency_probe_smem_limit(index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:{index}")
    return limit


def kernel_tile(rays, boxes, planes, variant_name: str, block: int) -> int:
    """The kernel's tile width for these operands on their CUDA device."""
    v = variant(variant_name)
    return tile_cols(planes.shape[2] // GROUPS, boxes.shape[1], v.chains, block, v.bf16, smem_limit(rays.device))


def _latency_probe_cuda(rays, boxes, planes, v: Variant, iters: int, block: int):
    """Launch the kernel on the current stream -> [N/B,B,16] (no sync)."""
    if rays.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the latency probe kernel needs CUDA tensors on a CUDA device; got {rays.device}")
    _check_shapes(rays, boxes, planes, v, block)
    n, k, c = rays.shape[0], boxes.shape[1], planes.shape[2] // GROUPS
    _check_operand("rays", rays, (n, 8), rays.device)
    _check_operand("boxes", boxes, (8, k), rays.device)
    _check_operand("planes", planes, tuple(planes.shape), rays.device, planes.dtype)
    tile = tile_cols(c, k, v.chains, block, v.bf16, smem_limit(rays.device))
    out = torch.empty((n // block, block, OUT_COLS), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_cuda_lib, ENTRY)(rays.data_ptr(), boxes.data_ptr(), planes.data_ptr(), out.data_ptr(), n,
                                        block, k, c, trips(v, iters), v.chains, tile, v.flags, stream)
    if err != 0:
        raise RuntimeError(f"latency probe kernel {ENTRY} ({v.name}) launch failed: CUDA error {err}")
    LAUNCHES[ENTRY] += 1
    return out


def latency_probe(rays, boxes, planes, variant_name: str, iters: int, block: int):
    """[N,8] rays, [8,K] boxes, [K,16,4C] planes (bf16 for the bf16
    variants) -> [N/B,B,16]: the kernel for CUDA tensors (copies in tiles of
    :func:`kernel_tile` slots; the results do not depend on them), the plain
    version for CPU tensors."""
    if rays.device.type == "cpu":
        return latency_probe_plain(rays, boxes, planes, variant_name, iters, block)
    return _latency_probe_cuda(rays, boxes, planes, variant(variant_name), iters, block)
