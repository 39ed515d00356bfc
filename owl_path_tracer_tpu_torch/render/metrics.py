"""Observability (counterpart of ``owl_path_tracer_tpu/render/metrics.py``):
live rays per bounce, gradient norms, profiler traces and a rays/s meter.

``profile_trace`` records with ``torch.profiler``; the renderers mark their
work with ``record_function`` ranges, which show in its traces and in
``key_averages()``: ``owlpt.intersect`` (each closest-hit query),
``owlpt.shade`` (the rest of a bounce), ``owlpt.occlude`` (NEE shadow tests,
inside ``owlpt.shade``) and ``owlpt.film`` (accumulating samples in the scan
loop).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.camera import primary_rays
from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import rng as rng_mod
from . import integrator


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


class Throughput:
    """Wall-clock rays/s meter for render loops."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.rays = 0

    def add(self, rays: int):
        self.rays += int(rays)

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(time.perf_counter() - self.t0, 1e-9) / 1e6
