"""Persistent-wavefront renderer with path regeneration (counterpart of
``owl_path_tracer_tpu/render/wavefront.py``, queue film).

A fixed pool of lanes traces one bounce per step; finished paths are added
into the film and their lanes respawn on the next (pixel, sample) work item
of a global queue.  Each work item seeds its LCG stream from
(pixel, sample + sample_base), so the image does not depend on the pool size
or on which lane ran which item.

With ``settings.use_nee`` each bounce is ``trace_bounce_nee``, in one of the
JAX package's two forms:
  * separate (``fused_nee=False``): the bounce rays go through the closest-hit
    kernel, then each vertex's light sample through the any-hit kernel;
  * deferred (``fused_nee=True``, area lights only): one mixed sweep traces
    the bounce rays together with the previous step's shadow rays, whose
    contributions are added before the bounce; a lane whose path ended with a
    shadow ray still pending (a zombie) banks one step later.

With ``checkpoint_path`` the frame is crash-safe: every
``checkpoint_every_s`` seconds the pool is drained (hand-outs capped at the
queue position, steps until no path is alive and no shadow ray is pending)
and the film, the queue position and the ray count are written atomically
with a guard of the configuration; a rerun with the same path resumes from
it with a fresh pool.  Every work item seeds its stream from its id alone, so
finished items are in the film once and the rest render as they would have.

With ``strided=True`` (and a frame whose work divides into the pool) the
film is strided: lane l owns the work items of P consecutive pixels (all
their samples) and banks into its own slots of an accumulator [P,3,L] (lane
axis minor) with a one-hot add, no scatter; the frame is done when every
lane has walked its slice.  Under the sharded renderer's "sample" split
(``parallel/shard.py``) ``work_map`` maps the pool's local queue ids to
global (pixel, sample) ids; the strided film's slot arithmetic assumes
unmapped ids, so the two exclude each other.

Differences from the JAX package, all exact in value:
  * the film is banked in place into the pool's accumulator (:func:`_bank`):
    on the CPU with ``index_add_``, lane by lane (its ``film_mode="scatter"``);
    on the card deterministically, each pixel's finished lanes accumulated
    in lane order without atomics;
  * the ray counter and work ids are int64, so they cannot wrap;
  * the host reads the pool's status after each launch, and after each step
    once the frame could have finished (its queue handed out and one step
    more run); a launch ends at the first read that finds the frame
    finished, so a frame runs no step past its last busy one.  The fused2
    wrapper synchronizes every step (to find unresolved rays), so the JAX
    package's overlap of the next dispatch with the previous status read
    would buy nothing;
  * a drain that ends with paths still in flight raises instead of writing a
    checkpoint that would drop them, and the checkpoint's guard also holds a
    hash of the scene (vertices, triangles, materials), the accelerator's
    kind and layout, the sort mode, ``fused_nee`` and the other render
    settings: resuming under another configuration raises and names the keys
    that differ.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import time

import numpy as np
import torch

from ..models.camera import primary_rays
from ..models.lights import build_light_table  # noqa: F401  (callers stepping a pool build lights through it)
from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import math as m
from ..ops import rng as rng_mod
from ..ops.fused2 import auto_sort_mode, resolve_sort
from ..ops.intersect import HitRecord
from ..utils.tensors import TensorBundle
from . import integrator
from .film import scene_has_textures, scene_lights
from .metrics import host_copy, span

# ray origin of parked (dead) lanes: far outside every scene AABB, so their
# traversal blocks retire at the scene gate
PARK = 1e8
# launches a checkpoint's drain may take before it gives up (a path lives at
# most depth + 2 steps, a launch is at least 2 steps)
DRAIN_LAUNCHES = 64

# _run_chunk's launches, the steps they ran, and the steps of a launch left
# unrun because the frame had finished ("cut")
STEPS = {"launches": 0, "run": 0, "cut": 0}


def reset_counts():
    """Set the launch and step counts to 0."""
    for name in STEPS:
        STEPS[name] = 0


@dataclasses.dataclass
class PoolState(TensorBundle):
    pixel: torch.Tensor  # [L] int64 linear pixel index of each lane's path
    ray_o: torch.Tensor  # [L,3]
    ray_d: torch.Tensor  # [L,3]
    throughput: torch.Tensor  # [L,3]
    result: torch.Tensor  # [L,3]
    rng: torch.Tensor  # [L] int64 LCG state
    alive: torch.Tensor  # [L] bool: lane is tracing a live path
    prev_lobe: torch.Tensor  # [L] int64
    depth: torch.Tensor  # [L] int64
    prev_pdf: torch.Tensor  # [L] f32
    work_counter: torch.Tensor  # [] int64 next work item of the queue, or the
    #                             pool's work base (strided film)
    acc: torch.Tensor  # film accumulator: [W*H,3] (queue), or [P,3,L] per-lane pixel slots (strided)
    rays: torch.Tensor  # [] int64 live rays traced
    work_local: torch.Tensor  # [L] int64 each lane's position in its slice (strided film)
    # deferred NEE (fused_nee): the previous vertex's light sample, traced in
    # this step's mixed sweep beside the bounce rays (zeros otherwise)
    sh_o: torch.Tensor  # [L,3] shadow origin (the previous vertex)
    sh_d: torch.Tensor  # [L,3] shadow direction
    sh_dist: torch.Tensor  # [L] occlusion distance
    sh_contrib: torch.Tensor  # [L,3] contribution if unoccluded
    sh_active: torch.Tensor  # [L] bool: a shadow ray is pending


def _spawn(scene: Scene, settings: RenderSettings, lane_work_id, sample_base: int = 0):
    """Work item -> (pixel, primary ray origin and direction, LCG state)."""
    spp = settings.max_samples
    pixel_lin = lane_work_id // spp
    sample = lane_work_id % spp
    px = pixel_lin % settings.width
    py = pixel_lin // settings.width
    st = rng_mod.seed(pixel_lin, (sample + sample_base) & rng_mod.MASK32)
    j0, st = rng_mod.next_f32(st)
    j1, st = rng_mod.next_f32(st)
    o, d = primary_rays(
        scene.camera, torch.stack([px, py], -1), torch.stack([j0, j1], -1),
        (settings.width, settings.height),
    )
    return pixel_lin, o, d, st


def _bank(acc, pixel, contrib):
    """acc[pixel] += contrib in place, the same sums on every run.

    On the CPU ``index_add_`` adds the lanes one after another.  On CUDA it
    adds with atomics in whatever order the threads run, and the lanes of
    one step often share a pixel (work id // spp), so two renders of one
    frame would differ in the last bits of many film values; there
    ``index_put_(accumulate=True)`` sorts the lanes by pixel (stably) and
    accumulates each pixel's lanes in that order, without atomics."""
    if acc.device.type == "cuda":
        return acc.index_put_((pixel,), contrib, accumulate=True)
    return acc.index_add_(0, pixel, contrib)


def wavefront_step(scene: Scene, settings: RenderSettings, st: PoolState, intersect_fn,
                   enable_textures: bool, total_work: int, sample_base: int = 0, lights=None,
                   occlude_fn=None, env_light=None, mixed_fn=None, work_map=None,
                   local_spp: int | None = None) -> PoolState:
    """One bounce for every lane, banking of finished paths (in place into
    ``st.acc``) and regeneration of idle lanes, under the range
    ``owlpt.step`` (banking under ``owlpt.bank``, regeneration under
    ``owlpt.regen``).  With ``mixed_fn`` and area lights only, NEE takes the
    deferred form, its sweep under ``owlpt.mixed``.

    The film's layout picks the work assignment: a [W*H,3] film hands idle
    lanes the next ids of the pool's queue (up to ``total_work``); a
    [P,3,L] film (strided) lets each lane walk its own slice of P pixels.
    ``work_map`` maps queue ids to the (pixel, sample) ids they render
    (identity when None); ``local_spp`` is the samples per pixel that queue
    draws (under the sharded "sample" split; in the JAX package it sizes the
    window film, which the port does not have).  Neither goes with the
    strided film: ValueError."""
    if st.acc.dim() == 3 and (work_map is not None or local_spp is not None):
        raise ValueError("the strided film is incompatible with work_map/local_spp (the sharded 'sample' "
                         "split): use the queue film there")
    with span("owlpt.step"):
        strided = st.acc.dim() == 3
        ray_o_t = torch.where(st.alive[:, None], st.ray_o, PARK)
        lanes = st.pixel.shape[0]
        use_nee = settings.use_nee and occlude_fn is not None and (
            lights is not None or env_light is not None)
        use_fused_nee = use_nee and mixed_fn is not None and lights is not None and env_light is None
        precomputed = None
        result = st.result
        if use_fused_nee:
            # one mixed sweep of 2L rays, under the range ``owlpt.mixed``: this
            # step's bounce rays, then the pending shadow rays (parked where
            # none is pending)
            with span("owlpt.mixed"):
                sh_on = st.sh_active
                up = host_copy("owlpt.sync.shadow_dir", [0.0, 0.0, 1.0], device=sh_on.device).expand(lanes, 3)
                comb_o = torch.cat([ray_o_t, torch.where(sh_on[:, None], st.sh_o, PARK)])
                comb_d = torch.cat([st.ray_d, torch.where(sh_on[:, None], st.sh_d, up)])
                comb_t = torch.cat([torch.full((lanes,), m.T_MAX, device=sh_on.device),
                                    torch.where(sh_on, st.sh_dist, m.T_MIN)])
                comb_sh = torch.cat([torch.zeros_like(sh_on), torch.ones_like(sh_on)])
                rec, blob, occ = mixed_fn(comb_o, comb_d, comb_t, comb_sh)
                precomputed = (HitRecord(t=rec.t[:lanes], tri=rec.tri[:lanes], uv=rec.uv[:lanes]), blob[:lanes])
                # the pending contributions land before this bounce accumulates
                result = result + torch.where((sh_on & ~occ[lanes:])[:, None], st.sh_contrib, 0.0)
        ps = integrator.PathState(
            ray_o=ray_o_t, ray_d=st.ray_d, result=result, throughput=st.throughput,
            rng=st.rng, alive=st.alive, prev_lobe=st.prev_lobe, depth=st.depth,
            prev_pdf=st.prev_pdf,
        )
        rays = st.rays + ps.alive.sum()  # path rays only; shadow rays are not counted
        pend = None
        if use_nee:
            # regeneration has no last bounce: a vertex at the depth limit samples no light
            allow_nee = ps.depth < settings.max_path_depth - 1
            ps = integrator.trace_bounce_nee(
                scene, settings, lights, ps, intersect_fn, occlude_fn, enable_textures,
                allow_nee=allow_nee, env_light=None if use_fused_nee else env_light,
                deferred=use_fused_nee, precomputed=precomputed,
            )
            if use_fused_nee:
                ps, pend = ps
        else:
            ps = integrator.trace_bounce(scene, settings, ps, intersect_fn, enable_textures)
        exhausted = ps.alive & (ps.depth >= settings.max_path_depth)
        path_done = st.alive & (~ps.alive | exhausted)
        if use_fused_nee:
            # a path that ends with a fresh pending shadow ray is a zombie: it
            # banks next step, once that ray is resolved; last step's zombies
            # (resolved above) bank now
            path_done = (path_done & ~pend[4]) | (~st.alive & st.sh_active)
        # non-zombie dead lanes respawn (sh_active is all False outside deferred NEE)
        idle = path_done | (~st.alive & ~st.sh_active)

        contrib = torch.where(path_done[:, None], ps.result, 0.0)
        with span("owlpt.bank"):
            if strided:
                # bank into each lane's own pixel slots (one-hot add, no scatter)
                p_slots = st.acc.shape[0]
                slice_items = p_slots * settings.max_samples
                lane_idx = torch.arange(lanes, device=st.acc.device)
                lane_first_pixel = (st.work_counter + lane_idx * slice_items) // settings.max_samples
                slot = (st.pixel - lane_first_pixel)[None, :]
                onehot = torch.arange(p_slots, device=st.acc.device)[:, None] == slot
                acc = st.acc.add_(torch.where(onehot[:, None, :], contrib.T[None], 0.0))
            else:
                acc = _bank(st.acc, st.pixel, contrib)
        with span("owlpt.regen"):
            if strided:
                # each lane walks its own slice
                new_ids = st.work_counter + lane_idx * slice_items + st.work_local
                can_spawn = idle & (st.work_local < slice_items)
                work_local = st.work_local + can_spawn.to(torch.int64)
                work_counter = st.work_counter
            else:
                # idle lanes take fresh work items of the queue
                order = torch.cumsum(idle.to(torch.int64), 0) - 1
                new_ids = st.work_counter + order
                can_spawn = idle & (new_ids < total_work)
                handed_out = torch.minimum(idle.sum(), torch.clamp(total_work - st.work_counter, min=0))
                work_counter = st.work_counter + handed_out
                work_local = st.work_local
            mapped_ids = torch.clamp(new_ids, min=0)
            if work_map is not None:
                mapped_ids = work_map(mapped_ids)
            pixel_s, o_s, d_s, rng_s = _spawn(scene, settings, mapped_ids, sample_base)

            def sel(new, old):
                mask = can_spawn[:, None] if old.dim() > 1 else can_spawn
                return torch.where(mask, new, old)

            shadow = dict(sh_o=st.sh_o, sh_d=st.sh_d, sh_dist=st.sh_dist, sh_contrib=st.sh_contrib,
                          sh_active=st.sh_active)
            if use_fused_nee:
                pend_o, pend_d, pend_dist, pend_c, pend_on = pend

                def keep(new, old):
                    return torch.where(pend_on[:, None] if old.dim() > 1 else pend_on, new, old)

                shadow = dict(
                    sh_o=sel(0.0, keep(pend_o, st.sh_o)), sh_d=sel(0.0, keep(pend_d, st.sh_d)),
                    sh_dist=sel(0.0, keep(pend_dist, st.sh_dist)),
                    sh_contrib=sel(0.0, keep(pend_c, st.sh_contrib)), sh_active=pend_on & ~can_spawn,
                )
            return PoolState(
                pixel=sel(pixel_s, st.pixel),
                ray_o=sel(o_s, ps.ray_o),
                ray_d=sel(d_s, ps.ray_d),
                throughput=sel(1.0, ps.throughput),
                result=sel(0.0, ps.result),
                rng=sel(rng_s, ps.rng),
                alive=can_spawn | (ps.alive & ~path_done),
                prev_lobe=sel(disney.LOBE_NONE, ps.prev_lobe),
                depth=sel(0, ps.depth),
                prev_pdf=sel(0.0, ps.prev_pdf),
                work_counter=work_counter,
                acc=acc,
                rays=rays,
                work_local=work_local,
                **shadow,
            )


def _status(settings: RenderSettings, st: PoolState, work_hi: int):
    """The pool's status [work_done, busy] on the host, read under
    ``owlpt.sync.status``; the strided film's work is done when every lane
    has walked its slice."""
    if st.acc.dim() == 3:
        work_done = st.work_local.min() >= st.acc.shape[0] * settings.max_samples
    else:
        work_done = st.work_counter >= work_hi
    # a pending shadow ray keeps the frame busy: its zombie lane has not banked
    status = torch.stack([work_done, (st.alive | st.sh_active).any()])
    with span("owlpt.sync.status"):
        return status.cpu()


def _run_chunk(scene: Scene, settings: RenderSettings, st: PoolState, accel,
               enable_textures: bool, work_hi: int, iters: int, fused2_block=None,
               fused2_sort=False, sample_base: int = 0, lights=None, env_light=None,
               fused_nee: bool = False, fused2_fanout=None, work_map=None, local_spp: int | None = None,
               stop_from: int | None = None):
    """``iters`` wavefront steps -> (pool, status [work_done, busy] on the
    host).  With ``stop_from`` the status is also read after every step from
    the ``stop_from``-th on, and the launch ends at the first read that finds
    the frame finished (work done, not busy); without it, or before a frame
    finishes, the launch runs all ``iters`` steps."""
    intersect_fn, occlude_fn = integrator.make_intersectors(
        scene, accel, fused2_block=fused2_block, fused2_sort=fused2_sort, fused2_fanout=fused2_fanout
    )
    mixed_fn = None
    if settings.use_nee and fused_nee:
        mixed_fn = integrator.make_mixed_sweep_fn(accel, fused2_block=fused2_block, fused2_sort=fused2_sort,
                                                  fused2_fanout=fused2_fanout)
    STEPS["launches"] += 1
    for i in range(1, iters + 1):
        st = wavefront_step(scene, settings, st, intersect_fn, enable_textures, work_hi, sample_base,
                            lights=lights, occlude_fn=occlude_fn, env_light=env_light,
                            mixed_fn=mixed_fn, work_map=work_map, local_spp=local_spp)
        STEPS["run"] += 1
        if i == iters or (stop_from is not None and i >= stop_from):
            status = _status(settings, st, work_hi)
            work_done, busy = status.tolist()
            if i == iters or (work_done and not busy):
                STEPS["cut"] += iters - i
                return st, status


def render_image_wavefront(scene: Scene, settings: RenderSettings, accel=None, lanes: int = 131072,
                           iters_per_launch: int = 32, max_launches: int = 1000,
                           fused2_block: int | None = None, fused2_sort=False,
                           sample_base: int = 0, fused_nee: bool = False,
                           fused2_fanout: int | None = None, checkpoint_path: str | None = None,
                           checkpoint_every_s: float = 600.0, progress: bool = False,
                           strided: bool = False) -> tuple:
    """Full frame via the persistent pool -> (image [H,W,3] top row first, on
    the scene's device; live rays traced).  ``accel=None`` (``make_accel``'s
    ``"brute"``) is the brute sweep over every triangle.

    ``fused2_sort=True`` picks the sort mode from the scene (cid2 for
    enclosed scenes, else morton).  Launch size adapts to the frame: the
    expected step count (work / lanes + depth + 3) caps ``iters_per_launch``.
    With ``settings.use_nee`` the light table (and, with
    ``settings.environment_use``, the environment light) is built from the
    scene; ``fused_nee`` selects the deferred form.  ``fused2_fanout``
    (default FANOUT) is the clusters the traversal retires per loop
    iteration on the MXU layout.  ``checkpoint_path``: drained checkpoints
    every ``checkpoint_every_s`` seconds, and resumption from an existing
    one (module docstring); ``progress`` prints each resume and each
    checkpoint with the seconds its drain and its write took.
    ``max_launches`` bounds the launches of this call (drains not counted).
    ``strided=True`` takes the strided film where the frame's work divides
    into the pool (W*H*spp a multiple of ``lanes``, and the work per lane a
    multiple of spp: P = W*H*spp / lanes / spp pixels per lane), and the
    queue film otherwise, as in the JAX package; checkpoints need the queue
    film (ValueError).
    """
    with span("owlpt.frame"):
        enable_textures = scene_has_textures(scene)
        if fused2_sort is True:
            fused2_sort = auto_sort_mode(scene)
        total_work = settings.width * settings.height * settings.max_samples
        lights, env_light = scene_lights(scene, settings)
        spp = settings.max_samples
        strided_pixels = None
        if strided and total_work % lanes == 0 and (total_work // lanes) % spp == 0:
            strided_pixels = total_work // lanes // spp
        st = new_pool(settings, lanes, strided_pixels=strided_pixels, device=scene.vertices.device)
    est_steps = (total_work + lanes - 1) // lanes + settings.max_path_depth + 3
    iters = max(2, min(iters_per_launch, est_steps))
    chunk = functools.partial(
        _run_chunk, scene, settings, accel=accel, enable_textures=enable_textures,
        iters=iters, fused2_block=fused2_block, fused2_sort=fused2_sort,
        sample_base=sample_base, lights=lights, env_light=env_light, fused_nee=fused_nee,
        fused2_fanout=fused2_fanout,
    )
    guard = None
    work_lo = 0
    if checkpoint_path is not None:
        if strided_pixels is not None:
            raise ValueError("checkpointing requires the queue film (strided=False)")
        guard = checkpoint_guard(scene, settings, accel, lanes, fused2_sort, fused_nee, sample_base)
        if os.path.exists(checkpoint_path):
            st = _resume(st, checkpoint_path, guard)
            work_lo = int(st.work_counter)
            if progress:
                print(f"[wavefront] resumed at work item {work_lo}/{total_work} "
                      f"({100.0 * work_lo / total_work:.1f}%)", flush=True)
    # no frame finishes before its queue is handed out (at most one item a
    # lane a step) and one step more has traced the last items: the status
    # is read after every step from then on
    first_read = (total_work - work_lo + lanes - 1) // lanes + 1
    steps = 0
    last_ck = time.monotonic()
    for _ in range(max_launches):
        st, status = chunk(st, work_hi=total_work, stop_from=max(1, first_read - steps))
        work_done, busy = status.tolist()
        if work_done and not busy:
            break
        steps += iters  # a launch that leaves its frame unfinished runs all its steps
        if checkpoint_path is not None and time.monotonic() - last_ck > checkpoint_every_s:
            t_drain = time.perf_counter()
            st = _drain(chunk, st)  # ends on a host read of the pool's status
            t_write = time.perf_counter()
            _write_checkpoint(checkpoint_path, st, guard)
            if progress:
                done = int(st.work_counter)
                print(f"[wavefront] checkpoint @ {done}/{total_work} ({100.0 * done / total_work:.1f}%), "
                      f"{int(st.rays) / 1e6:.0f}M rays, drain {t_write - t_drain:.6f} s, write "
                      f"{time.perf_counter() - t_write:.6f} s", flush=True)
            last_ck = time.monotonic()
    acc = st.acc
    if acc.dim() == 3:  # [P,3,L] -> [L*P,3]: lane l holds pixels l*P .. l*P + P - 1
        acc = acc.permute(2, 0, 1).reshape(-1, 3)
    img = acc.reshape(settings.height, settings.width, 3) / settings.max_samples
    with span("owlpt.sync.rays"):
        rays = int(st.rays)
    return img.flip(0), rays


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def checkpoint_guard(scene: Scene, settings: RenderSettings, accel, lanes: int, sort, fused_nee: bool,
                     sample_base: int) -> dict:
    """What a checkpoint must have been written under to be resumed: the
    frame and pool sizes, the scene's geometry and materials (a hash), the
    accelerator's kind and layout, the sort mode (resolved), the NEE form,
    the sample base and the other render settings."""
    mats = scene.materials
    planes = getattr(accel, "planes", None)
    accel_desc = (f"{type(accel).__name__} {getattr(accel, 'layout', '-')} "
                  f"{'-' if planes is None else planes.dtype} C={getattr(accel, 'cluster_size', '-')} "
                  f"K={getattr(accel, 'num_clusters', '-')}")
    rest = {f.name: getattr(settings, f.name) for f in dataclasses.fields(settings)
            if f.name not in ("width", "height", "max_samples", "max_path_depth", "use_nee")}
    return dict(
        width=settings.width, height=settings.height, spp=settings.max_samples, depth=settings.max_path_depth,
        lanes=lanes, nee=int(settings.use_nee), sample_base=sample_base, fused_nee=int(bool(fused_nee)),
        scene=_digest(scene.vertices, scene.tri_idx, scene.tri_mat,
                      *(getattr(mats, f.name) for f in dataclasses.fields(mats))),
        accel=accel_desc, sort=str(resolve_sort(sort)), settings=repr(sorted(rest.items())),
    )


def _resume(st: PoolState, path: str, guard: dict) -> PoolState:
    """A fresh pool that continues from the checkpoint at ``path``; raises
    ValueError if the checkpoint was written under another guard."""
    with np.load(path) as ck:
        mismatch = [k for k, v in guard.items() if k not in ck or ck[k].item() != v]
        if mismatch:
            raise ValueError(f"checkpoint {path} was written by a different configuration (mismatched: "
                             f"{mismatch}); refusing to resume")
        dev = st.acc.device
        return dataclasses.replace(
            st, acc=torch.as_tensor(ck["acc"], device=dev),
            work_counter=torch.tensor(int(ck["work_counter"]), dtype=torch.int64, device=dev),
            rays=torch.tensor(int(ck["rays"]), dtype=torch.int64, device=dev),
        )


def _drain(chunk, st: PoolState) -> PoolState:
    """Step without new hand-outs (capped at the current queue position)
    until no path is alive and no shadow ray is pending; raises if that
    takes more than DRAIN_LAUNCHES launches, so no checkpoint drops a path."""
    cap = int(st.work_counter)
    for _ in range(DRAIN_LAUNCHES):
        st, status = chunk(st, work_hi=cap)
        if not status[1]:
            return st
    raise RuntimeError(f"the pool did not drain in {DRAIN_LAUNCHES} launches: paths still in flight, "
                       "no checkpoint written")


def _write_checkpoint(path: str, st: PoolState, guard: dict):
    """Film, queue position, ray count and guard, atomically (temporary file + rename)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no .npz
        np.savez(f, acc=st.acc.cpu().numpy(), work_counter=int(st.work_counter), rays=int(st.rays), **guard)
    os.replace(tmp, path)


def new_pool(settings: RenderSettings, lanes: int, work_lo: int = 0, strided_pixels: int | None = None, *,
             device) -> PoolState:
    """Fresh all-idle pool; lanes spawn on the first step from work item
    ``work_lo``.  ``strided_pixels=P`` makes the strided film: lane l owns
    the P * spp work items from ``work_lo + l * P * spp``, acc [P,3,lanes]."""
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    const = functools.partial(host_copy, "owlpt.sync.pool", device=device)
    return PoolState(
        pixel=z(lanes, dtype=torch.int64),
        ray_o=z(lanes, 3),
        ray_d=const([0.0, 0.0, 1.0]).repeat(lanes, 1),
        throughput=torch.ones((lanes, 3), device=device),
        result=z(lanes, 3),
        rng=z(lanes, dtype=torch.int64),
        alive=z(lanes, dtype=torch.bool),
        prev_lobe=torch.full((lanes,), disney.LOBE_NONE, dtype=torch.int64, device=device),
        depth=z(lanes, dtype=torch.int64),
        prev_pdf=z(lanes),
        work_counter=const(work_lo, dtype=torch.int64),
        acc=z(strided_pixels, 3, lanes) if strided_pixels else z(settings.width * settings.height, 3),
        rays=const(0, dtype=torch.int64),
        work_local=z(lanes, dtype=torch.int64),
        sh_o=z(lanes, 3),
        sh_d=const([0.0, 0.0, 1.0]).repeat(lanes, 1),
        sh_dist=z(lanes),
        sh_contrib=z(lanes, 3),
        sh_active=z(lanes, dtype=torch.bool),
    )
