"""Observability (counterpart of ``owl_path_tracer_tpu/render/metrics.py``):
live rays per bounce, gradient norms, profiler traces, and the registry of
the program's spans.

The renderers mark their work with ``torch.profiler.record_function``
ranges, each opened through :func:`span` and named in :data:`SPANS`.  They
show in ``profile_trace``'s traces and ``key_averages()``, and anything that
wraps ``record_function`` (the benchmark's host clock) times them; while
nothing records ranges a span is a no-op.  A range is opened per frame, per
step, per launch or per host sync, never per lane or per op:

  * ``owlpt.frame``: a frame's set-up (sort mode, textures, lights, pool or
    film copies);
  * ``owlpt.step``: one bounce of one wave, the parent of that bounce's other
    ranges;
  * ``owlpt.intersect``, ``owlpt.sort``, ``owlpt.unresolved``: the
    closest-hit query, its coherence sort, its exact fallback;
  * ``owlpt.mixed``: deferred NEE's mixed sweep of bounce and shadow rays
    (its sort and fallback inside);
  * ``owlpt.shade``, ``owlpt.nee``, ``owlpt.occlude``: shading, its area
    light samples and MIS weights, NEE shadow tests;
  * ``owlpt.bank``, ``owlpt.regen``, ``owlpt.film``: banking finished paths,
    regenerating idle lanes, accumulating the scan's samples;
  * ``owlpt.sync.<site>``: each read that blocks the host on the card, one
    site name per place in the code: ``status``, ``resolved``, ``rays``,
    ``scene``, ``lights``, and the copies of host constants ``pool``,
    ``camera``, ``sky``, ``normal``, ``pad_rays``, ``pack_rays``,
    ``hit_t_max``, ``k5_t_max``, ``shadow_dir``, ``env_color``, ``x_axis``.

A count of ranges per frame is a counter: steps, syncs by site.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from ..models.scene import RenderSettings, Scene

SPANS = (
    "owlpt.frame",  # a frame's set-up: wavefront sort mode, textures, lights, pool; scan intersectors, film copies
    "owlpt.step",  # one bounce of one wave: a wavefront_step, or one depth of the scan's trace_paths
    "owlpt.intersect",  # one closest-hit query: pad, pack, sort, traversal, unsort, fallback
    "owlpt.sort",  # fused2's coherence sort of a sweep: keys, torch.sort, gather, inverse permutation
    "owlpt.unresolved",  # the exact cluster query for the rows a sweep left unresolved (only when there are some)
    "owlpt.mixed",  # deferred NEE's sweep: 2L rays joined, the mixed sweep, the split, pending contributions added
    "owlpt.shade",  # shading of a bounce, its BSDF sample and Russian roulette
    "owlpt.nee",  # NEE's area-light sample, its BSDF value, MIS weight and contribution, inside owlpt.shade
    "owlpt.occlude",  # NEE shadow tests, inside owlpt.shade
    "owlpt.bank",  # banking a wavefront step's finished paths into the film
    "owlpt.regen",  # new work ids, spawned primary rays and the selects of the next pool state
    "owlpt.film",  # accumulating the scan loop's samples
    "owlpt.sync.status",  # the wavefront's status read after each launch
    "owlpt.sync.resolved",  # the nonzero of a sweep's resolved column (fused2 closest hit and any-hit, K5)
    "owlpt.sync.rays",  # a frame's ray count read to the host
    "owlpt.sync.scene",  # the frame's scene reads: the sort mode's mesh read-back, the texture test
    "owlpt.sync.pool",  # the wavefront pool's constants (new_pool), four copies from the host
    "owlpt.sync.camera",  # primary_rays' framebuffer size, copied from the host
    "owlpt.sync.sky",  # the auto sky's colour (sky_gradient), copied from the host
    "owlpt.sync.normal",  # the fallback shading normal of the payload path (_fetch_surface_blob)
    "owlpt.sync.pad_rays",  # fused2 _pad_rays' scalar t_max, copied from the host
    "owlpt.sync.pack_rays",  # pack_rays' scalar t_max (the fused kernel's sweep), copied from the host
    "owlpt.sync.hit_t_max",  # fused2 _hits_from_output's scalar t_max, copied from the host
    "owlpt.sync.k5_t_max",  # fused_closest_hit's scalar t_max, copied from the host
    "owlpt.sync.lights",  # a NEE frame's light table: the scene read back, the table copied to the device
    "owlpt.sync.shadow_dir",  # deferred NEE's direction of parked shadow lanes, copied from the host
    "owlpt.sync.env_color",  # the constant environment colour (_environment_radiance), copied from the host
    "owlpt.sync.x_axis",  # the VNDF sampler's fallback tangent (corrected mode), copied from the host
)


# ``record_function``'s own enter: a wrap of it (the benchmark's host clock) records ranges
_ENTER = torch.autograd.profiler.record_function.__enter__
_OFF = contextlib.nullcontext()


def span(name: str):
    """The ``record_function`` range ``name``, one of :data:`SPANS`, while
    something records ranges: a profiler, or a wrap of ``record_function``'s
    enter.  Else a no-op: a range's enter and exit are two operator calls,
    about 11 us of host time on the card's host, which no one reads then."""
    rf = torch.autograd.profiler.record_function
    if rf.__enter__ is _ENTER and not torch.autograd._profiler_enabled():
        return _OFF
    return rf(name)


def host_copy(site: str, data, **kw):
    """``torch.tensor(data, **kw)`` under the range ``site`` (an
    ``owlpt.sync.*`` name): on a card, a copy from pageable host memory,
    which waits for the stream."""
    with span(site):
        return torch.tensor(data, **kw)


@dataclasses.dataclass
class WaveStats:
    """Statistics of one traced wavefront."""

    live_per_bounce: np.ndarray  # [depth] live rays entering each bounce
    occupancy: np.ndarray  # [depth] live fraction
    mean_path_length: float
    total_rays: int

    def to_json(self) -> str:
        return json.dumps({
            "live_per_bounce": self.live_per_bounce.tolist(),
            "occupancy": [round(float(x), 4) for x in self.occupancy],
            "mean_path_length": round(self.mean_path_length, 3),
            "total_rays": self.total_rays,
        })


def wavefront_stats(scene: Scene, settings: RenderSettings, pixel_xy, intersect_fn: Callable,
                    enable_textures: bool = False) -> WaveStats:
    """Trace one sample wave of ``pixel_xy`` [N,2] and report per-bounce occupancy."""
    # imported here: the ops modules import this one for ``span``
    from ..models.camera import primary_rays
    from ..ops import disney
    from ..ops import rng as rng_mod
    from . import integrator

    n = pixel_xy.shape[0]
    dev = pixel_xy.device
    j0, st = rng_mod.next_f32(rng_mod.seed(pixel_xy[..., 0], pixel_xy[..., 1]))
    j1, st = rng_mod.next_f32(st)
    o, d = primary_rays(scene.camera, pixel_xy, torch.stack([j0, j1], -1), (settings.width, settings.height))
    ps = integrator.PathState(
        ray_o=o, ray_d=d, result=torch.zeros((n, 3), device=dev), throughput=torch.ones((n, 3), device=dev),
        rng=st, alive=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_lobe=torch.full((n,), disney.LOBE_NONE, dtype=torch.int64, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev), prev_pdf=torch.zeros((n,), device=dev),
    )
    lives = []
    for _ in range(settings.max_path_depth):
        lives.append(ps.alive.sum())
        ps = integrator.trace_bounce(scene, settings, ps, intersect_fn, enable_textures)
    lives = torch.stack(lives).cpu().numpy()
    total = int(lives.sum())
    return WaveStats(live_per_bounce=lives, occupancy=lives / float(n), mean_path_length=total / float(n),
                     total_rays=total)


def grad_norms(grads) -> dict:
    """Per-field L2 norms of a dataclass of gradient tensors (a Materials)."""
    return {f.name: float(torch.sqrt(torch.sum(getattr(grads, f.name) ** 2)))
            for f in dataclasses.fields(grads)}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block into ``log_dir`` (a Chrome
    trace, ``*.pt.trace.json``, readable by TensorBoard's profiler plugin);
    CPU activity, and the card's where there is one.  Yields the profiler
    (``key_averages()`` sums the ``owlpt.*`` ranges), or None and records
    nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof

