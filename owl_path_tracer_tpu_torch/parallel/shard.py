"""Multi-device rendering on ``torch.distributed`` (counterpart of
``owl_path_tracer_tpu/parallel/shard.py``).

Every rank runs the same program on its shard (SPMD): the scene, the
accelerator and the material table are replicated (each rank builds its
own), the pixels or the (pixel, sample) work items are split among the
ranks, and the ranks meet only in a collective at the end: the film summed
or gathered, the loss and the material gradients averaged.

* ``make_pixel_mesh``: the rank's view of the group (rank, world size, the
  rank's device, the process group).  The backend follows the device the
  caller names, ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``, unless the
  caller passes ``backend=``; nothing switches it silently.  One card per
  rank under NCCL (it refuses two ranks on one card); two ranks on one card
  need ``backend="gloo"``.
* ``render_image_sharded``: the scan renderer, pixels split into equal
  contiguous shards (padded with copies of the last pixel); the image equals
  the single-device scan render on the exact accelerators.
* ``sharded_loss_and_grad``: the image loss and its material gradients,
  averaged over the ranks (the global loss is the mean of the shard means).
* ``render_image_wavefront_sharded``: one persistent lane pool per rank over
  its part of the (pixel, sample) queue, ``work_split`` "sample" (rank k
  renders samples [k*spp/n, (k+1)*spp/n) of every pixel, through the
  wavefront's ``work_map``) or "contiguous" (bands of the queue), the films
  summed at the end.  Each work item's stream depends only on its id, so the
  image is the single-device wavefront image up to the film's summation
  order; at world size 1 it is the same bits.

Collectives under gloo: gloo runs ``all_reduce`` and ``broadcast`` on CUDA
tensors and the other collectives on host tensors only, so ``all_gather``
(the scan image's shards, the per-rank ray counts) copies a CUDA tensor to
the host and back, always: a stated design, not a fallback.  Under NCCL
every collective runs on the card.

Differences from the JAX package: the ranks are processes, not devices of
one program, so each rank's wavefront loop ends when its own pool is done
(no per-launch status exchange); ``sharded_sample_sum``'s ray count is the
sum over the ranks; the light table of ``sharded_loss_and_grad`` is built
from the given materials outside the differentiated function (the JAX
package builds it with numpy inside ``jax.jit``, which raises with NEE).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pathlib
import queue as queue_mod
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.lights import build_light_table
from ..models.scene import RenderSettings, Scene
from ..ops import rng as rng_mod
from ..render import integrator
from ..render.diff import _value_and_grad
from ..render.film import _pixel_grid, scene_has_textures, scene_lights

WORK_SPLITS = ("auto", "sample", "contiguous")


@dataclasses.dataclass(frozen=True)
class PixelMesh:
    """One rank's view of the 1-D group the pixels are split over."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None  # the process group (None: the default one)
    owns_group: bool = False  # make_pixel_mesh initialised the default group

    def close(self):
        """Destroy the default group if :func:`make_pixel_mesh` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_pixel_mesh(device="cuda", backend: str | None = None, init_method: str | None = None,
                    rank: int | None = None, world_size: int | None = None) -> PixelMesh:
    """This rank's mesh over the default process group, initialising it
    (with ``init_method``, ``rank`` and ``world_size``, e.g.
    ``init_method="file:///<tmp>/store"``) unless it is initialised already.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU.  A CUDA device without an index becomes ``cuda:<rank % cards>``.
    """
    device = torch.device(device)
    want = backend or ("nccl" if device.type == "cuda" else "gloo")
    owns = False
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("no process group is initialised: pass init_method, rank and world_size")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if want == "nccl":
            torch.cuda.set_device(device)
        dist.init_process_group(want, init_method=init_method, rank=rank, world_size=world_size)
        owns = True
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have}, not the {want} asked for")
    if want == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs a CUDA device")
    rank = dist.get_rank()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return PixelMesh(rank=rank, size=dist.get_world_size(), device=device, backend=have, group=dist.group.WORLD,
                     owns_group=owns)


def _mesh_for(scene: Scene, mesh: Optional[PixelMesh]) -> PixelMesh:
    """``mesh`` (default: over the initialised default group, on the scene's
    device); the scene must lie on the rank's device."""
    mesh = mesh or make_pixel_mesh(scene.vertices.device)
    if scene.vertices.device != mesh.device:
        raise ValueError(f"the scene is on {scene.vertices.device}, this rank's device is {mesh.device}")
    return mesh


def _all_reduce_sum(mesh: PixelMesh, x):
    """In place sum over the ranks (both backends run it on CUDA tensors)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _all_gather(mesh: PixelMesh, x) -> list:
    """Every rank's ``x``, in rank order, on ``x``'s device; under gloo a
    CUDA tensor goes through host memory (gloo gathers host tensors only)."""
    host = mesh.backend == "gloo" and x.is_cuda
    src = (x.cpu() if host else x).contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(x.device) for o in out] if host else out


def sharded_sample_sum(mesh: PixelMesh, scene: Scene, settings: RenderSettings, accel, lights,
                       enable_textures: bool, num_samples: int, env_light=None):
    """The per-rank sampler ``fn(pixel_xy, rng_state) -> (sum [N,3], rng', rays)``
    over this rank's pixels; ``rays`` is the sum over every rank's call
    (each rank calls ``fn`` the same number of times)."""
    intersect_fn, occlude_fn = integrator.make_intersectors(scene, accel)

    def fn(pixel_xy, rng_state):
        acc, st, rays = integrator.sample_sum(scene, settings, pixel_xy, rng_state, num_samples, intersect_fn,
                                              enable_textures, lights=lights, occlude_fn=occlude_fn,
                                              env_light=env_light)
        return acc, st, _all_reduce_sum(mesh, rays.clone())

    return fn


def render_image_sharded(scene: Scene, settings: RenderSettings, mesh: Optional[PixelMesh] = None,
                         spp: int | None = None, accel=None, pixel_chunk: int = 65536):
    """Full frame with the pixels split over the ranks -> image [H,W,3]
    (top row first) on every rank, on the scene's device.  The pixel count
    is padded to a multiple of the world size with the last pixel; each
    rank renders its shard ``pixel_chunk`` pixels at a time."""
    mesh = _mesh_for(scene, mesh)
    spp = settings.max_samples if spp is None else spp
    lights, env_light = scene_lights(scene, settings)
    dev = scene.vertices.device
    px = _pixel_grid(settings.width, settings.height, dev)
    total = px.shape[0]
    pad = (-total) % mesh.size
    if pad:
        px = torch.cat([px, px[-1:].expand(pad, 2)])
    per = px.shape[0] // mesh.size
    local = px[mesh.rank * per : (mesh.rank + 1) * per]
    fn = sharded_sample_sum(mesh, scene, settings, accel, lights, scene_has_textures(scene), spp,
                            env_light=env_light)
    acc = torch.zeros((per, 3), device=dev)
    for lo in range(0, per, pixel_chunk):
        chunk = local[lo : lo + pixel_chunk]
        acc[lo : lo + chunk.shape[0]] = fn(chunk, rng_mod.seed(chunk[:, 0], chunk[:, 1]))[0]
    acc = torch.cat(_all_gather(mesh, acc))[:total]
    return (acc.reshape(settings.height, settings.width, 3) / float(spp)).flip(0)


def sharded_loss_and_grad(mesh: PixelMesh, scene: Scene, settings: RenderSettings, accel, num_samples: int):
    """The per-rank ``fn(materials, pixel_xy, rng_state, target) -> (loss,
    grads)`` over this rank's pixels (their LCG states and target radiance):
    the mean squared error of the shard, then loss and every material
    gradient averaged over the ranks, so every rank returns the same
    values.  Winners through the differentiable intersectors
    (``make_intersectors(..., differentiable=True)``)."""

    def fn(materials, pixel_xy, rng_state, target):
        s2 = dataclasses.replace(scene, materials=materials)
        lights = build_light_table(s2) if settings.use_nee else None  # a constant of the render
        enable_textures = scene_has_textures(s2)

        def local_loss(mats):
            s3 = dataclasses.replace(scene, materials=mats)
            intersect_fn, occlude_fn = integrator.make_intersectors(s3, accel, differentiable=True)
            acc, _, _ = integrator.sample_sum(s3, settings, pixel_xy, rng_state, num_samples, intersect_fn,
                                              enable_textures, lights=lights, occlude_fn=occlude_fn)
            return torch.mean((acc / float(num_samples) - target) ** 2)

        loss, grads = _value_and_grad(local_loss, materials)
        loss = _all_reduce_sum(mesh, loss.clone()) / mesh.size
        fields = {f.name: _all_reduce_sum(mesh, getattr(grads, f.name).contiguous()) / mesh.size
                  for f in dataclasses.fields(grads)}
        return loss, dataclasses.replace(grads, **fields)

    return fn


def _work_range(mesh: PixelMesh, total_work: int, spp: int, work_split: str):
    """(work_lo, work_hi, work_map, local_spp) of this rank's queue."""
    n, k = mesh.size, mesh.rank
    if work_split == "sample":
        if spp % n:
            raise ValueError(f"work_split 'sample' needs spp ({spp}) divisible by the world size ({n})")
        local_spp = spp // n

        def work_map(ids):  # local queue id -> global (pixel, sample) id
            return (ids // local_spp) * spp + k * local_spp + ids % local_spp

        return 0, total_work // n, work_map, local_spp
    edges = np.linspace(0, total_work, n + 1).round().astype(np.int64)
    return int(edges[k]), int(edges[k + 1]), None, None


def sharded_wavefront_chunk(mesh: PixelMesh, scene: Scene, settings: RenderSettings, accel,
                            enable_textures: bool, iters: int, lights, env_light, work_split: str = "contiguous",
                            fused_nee: bool = False, fused2_block: int | None = None, fused2_sort=False,
                            fused2_fanout: int | None = None):
    """``chunk(pool, work_hi) -> (pool, status [work_done, busy])``: ``iters``
    wavefront steps of this rank's pool under its ``work_split`` share."""
    from ..render.wavefront import _run_chunk

    total_work = settings.width * settings.height * settings.max_samples
    _, _, work_map, local_spp = _work_range(mesh, total_work, settings.max_samples, work_split)

    def chunk(st, work_hi):
        return _run_chunk(scene, settings, st, accel, enable_textures, work_hi, iters, fused2_block=fused2_block,
                          fused2_sort=fused2_sort, lights=lights, env_light=env_light, fused_nee=fused_nee,
                          fused2_fanout=fused2_fanout, work_map=work_map, local_spp=local_spp)

    return chunk


def render_image_wavefront_sharded(scene: Scene, settings: RenderSettings, mesh: Optional[PixelMesh] = None,
                                   accel=None, lanes_per_chip: int = 131072, iters_per_launch: int = 32,
                                   max_launches: int = 1000, return_stats: bool = False, work_split: str = "auto",
                                   fused_nee: bool = False, fused2_block: int | None = None, fused2_sort=False,
                                   fused2_fanout: int | None = None):
    """Full frame with one persistent lane pool per rank -> (image [H,W,3]
    top row first, rays traced by all ranks[, stats]) on every rank.
    Launches are ``iters_per_launch`` steps (``render_image_wavefront``'s
    default, where the JAX package's sharded renderer takes 16), capped at
    the steps the rank's share of the work needs: work / lanes + depth + 3.

    ``work_split``: "sample", "contiguous", or "auto" (sample where the world
    size divides spp).  ``stats``: ``per_chip_rays`` (each rank's live rays,
    in rank order) and ``load_balance`` (their mean over their max)."""
    from ..ops.fused2 import auto_sort_mode
    from ..render.wavefront import new_pool

    if work_split not in WORK_SPLITS:
        raise ValueError(f"work_split must be one of {WORK_SPLITS}, not {work_split!r}")
    mesh = _mesh_for(scene, mesh)
    spp = settings.max_samples
    total_work = settings.width * settings.height * spp
    if work_split == "auto":
        work_split = "sample" if spp % mesh.size == 0 else "contiguous"
    if fused2_sort is True:
        fused2_sort = auto_sort_mode(scene)
    lights, env_light = scene_lights(scene, settings)
    work_lo, work_hi, _, _ = _work_range(mesh, total_work, spp, work_split)
    # launch size as render_image_wavefront's: capped at the steps this rank's work needs
    est_steps = (work_hi - work_lo + lanes_per_chip - 1) // lanes_per_chip + settings.max_path_depth + 3
    iters = max(2, min(iters_per_launch, est_steps))
    chunk = sharded_wavefront_chunk(mesh, scene, settings, accel, scene_has_textures(scene), iters,
                                    lights, env_light, work_split=work_split, fused_nee=fused_nee,
                                    fused2_block=fused2_block, fused2_sort=fused2_sort, fused2_fanout=fused2_fanout)
    st = new_pool(settings, lanes_per_chip, work_lo=work_lo, device=mesh.device)
    for _ in range(max_launches):
        st, status = chunk(st, work_hi)
        work_done, busy = status.tolist()
        if work_done and not busy:
            break
    # contiguous: disjoint pixel bands; sample: every rank holds its samples
    # of every pixel -- either way the film's sum is the whole frame
    acc = _all_reduce_sum(mesh, st.acc)
    img = (acc.reshape(settings.height, settings.width, 3) / spp).flip(0)
    per_chip = [int(r) for r in _all_gather(mesh, st.rays.reshape(1))]
    rays = sum(per_chip)
    if return_stats:
        stats = {"per_chip_rays": per_chip,
                 "load_balance": float(np.mean(per_chip) / max(max(per_chip), 1))}
        return img, rays, stats
    return img, rays


def _rank_main(rank: int, world_size: int, device: str, backend, init_method: str, fn, args, results):
    """A spawned rank: its mesh, ``fn(mesh, *args)``, and (rank, result,
    error text) on ``results``.  Ranks on the CPU share the host's cores:
    each takes its share of them as threads (more threads than cores slow
    gloo ranks down by orders of magnitude)."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        mesh = make_pixel_mesh(device, backend=backend, init_method=init_method, rank=rank, world_size=world_size)
        try:
            results.put((rank, fn(mesh, *args), None))
        finally:
            mesh.close()
    except BaseException:  # the parent reports the rank's traceback
        results.put((rank, None, traceback.format_exc()))
        raise


def spawn_ranks(fn, world_size: int, *, device: str, backend: str | None = None, args=(), timeout_s: float = 600.0,
                store_dir=None) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned processes, one per
    rank, over a group initialised from a FileStore (in ``store_dir``, by
    default a new temporary directory) -> each rank's result, in rank order.
    ``fn`` and ``args`` must be picklable (a module-level function; numpy
    arrays, not CUDA tensors).  Build the kernel libraries before calling,
    so that no two ranks build them at once.  Raises RuntimeError with the
    rank's traceback if a rank fails, and stops every rank still running
    after ``timeout_s`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = (pathlib.Path(tmp) / "store").as_uri()
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, world_size, device, backend, init_method, fn, args,
                                                      results)) for r in range(world_size)]
        for p in procs:
            p.start()
        out, errors = {}, {}
        try:
            for _ in range(world_size):  # drain before joining
                rank, value, err = results.get(timeout=timeout_s)
                if err is not None:
                    errors[rank] = err
                    break
                out[rank] = value
        except queue_mod.Empty:
            errors[-1] = f"no result within {timeout_s} s"
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [out[r] for r in range(world_size)]
