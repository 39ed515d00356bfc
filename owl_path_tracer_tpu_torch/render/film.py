"""Film: full-frame scan rendering and progressive accumulation
(counterpart of ``owl_path_tracer_tpu/render/film.py``), and the
accelerator set-up every renderer shares.

The film is explicit state -- the sample sum, each pixel's LCG state and the
samples done -- so a render is progressive: more samples continue each
pixel's stream where the last call left it.  Framebuffer conventions
(parity): pixel (x, y=0) is the bottom image row, and ``finalize`` applies
the reference's store-time flip so that row 0 of the image is the top.

Differences from the JAX package, exact in value: the film's tensors live on
the scene's device and its LCG state is int64 (holding values below 2^32,
``ops/rng.py``; checkpoints store it as uint32, as the JAX package does, so
the two packages read each other's); ``finalize`` and ``render_image``
return a tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.envlight import build_env_light
from ..models.lights import build_light_table
from ..models.scene import RenderSettings, Scene
from ..ops import rng as rng_mod
from ..ops.bvh import build_bvh_cached
from ..ops.cluster import build_clusters
from ..ops.fused import build_fused
from ..ops.fused2 import auto_sort_mode, build_fused2_scene
from ..ops.traverse import device_bvh
from . import integrator
from .metrics import span


@dataclasses.dataclass
class Film:
    acc: torch.Tensor  # [H*W,3] f32 radiance sum
    rng: torch.Tensor  # [H*W] int64 per-pixel LCG state
    spp_done: int
    width: int
    height: int
    rays_traced: int = 0  # live rays through the intersector


def _pixel_grid(width: int, height: int, device) -> torch.Tensor:
    """All pixel coordinates [H*W,2] (int64) in the reference's launch order, x fastest."""
    y, x = torch.meshgrid(torch.arange(height, device=device), torch.arange(width, device=device),
                          indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], -1)


def new_film(settings: RenderSettings, *, device) -> Film:
    px = _pixel_grid(settings.width, settings.height, device)
    return Film(
        acc=torch.zeros((settings.width * settings.height, 3), device=device),
        rng=rng_mod.seed(px[:, 0], px[:, 1]),
        spp_done=0,
        width=settings.width,
        height=settings.height,
    )


def build_scene_bvh(scene: Scene, cache_dir=None):
    """The per-ray-stack BVH (``ops/traverse.py``), built (cached in
    ``cache_dir``, default ``ops/bvh.CACHE_DIR``) and put on the scene's device."""
    verts, tris = scene.vertices.cpu().numpy(), scene.tri_idx.cpu().numpy()
    return device_bvh(build_bvh_cached(verts, tris, cache_dir=cache_dir), verts, tris,
                      device=scene.vertices.device)


def make_accel(scene: Scene, kind: str = "cluster", cluster_size: int | None = None, plane_dtype=None):
    """Build the acceleration structure on the scene's device.

    ``fused2`` is the MXU feature layout with float32 planes (``plane_dtype``
    may ask for bfloat16), ``fused2-bf16`` the same with bfloat16 planes, as
    in the JAX package; without a ``cluster_size`` C adapts to the scene:
    512 for enclosed scenes (the cid2 sort), and for open scenes halved from
    512 (down to 128) while the scene would have fewer than 64 clusters.
    ``cluster`` is the exact cluster query (C=128 by default) and ``fused``
    the same clusters traversed by kernel K5.  ``bvh`` is the per-ray-stack
    traversal (:func:`build_scene_bvh`).  ``brute`` returns None, which
    every renderer takes for the brute sweep over every triangle, as in the
    JAX package."""
    if kind in ("fused2", "fused2-bf16"):
        if kind == "fused2-bf16":
            plane_dtype = torch.bfloat16
        if cluster_size is None:
            cluster_size = 512
            if auto_sort_mode(scene) != "cid2":
                n_tris = int(scene.tri_idx.shape[0])
                while cluster_size > 128 and n_tris // cluster_size < 64:
                    cluster_size //= 2
        return build_fused2_scene(scene, cluster_size=cluster_size, plane_dtype=plane_dtype or torch.float32)
    if kind in ("cluster", "fused"):
        cb = build_clusters(scene.vertices.cpu().numpy(), scene.tri_idx.cpu().numpy(),
                            cluster_size=cluster_size or 128, device=scene.vertices.device)
        return build_fused(cb) if kind == "fused" else cb
    if kind == "bvh":
        return build_scene_bvh(scene)
    if kind == "brute":
        return None
    raise ValueError(f"unknown intersector kind {kind!r}")


def scene_has_textures(scene: Scene) -> bool:
    with span("owlpt.sync.scene"):
        return bool((scene.mat_tex >= 0).any())


def scene_lights(scene: Scene, settings: RenderSettings):
    """(light table, environment light) of a render: both None without
    NEE, the environment light only with ``settings.environment_use``."""
    lights = env_light = None
    if settings.use_nee:
        lights = build_light_table(scene)
        if settings.environment_use:
            env_light = build_env_light(scene.env_map, settings.environment_intensity)
    return lights, env_light


def add_samples(scene: Scene, settings: RenderSettings, film: Film, num_samples: int,
                pixel_chunk: int = 65536, accel=None, fused2_block: int | None = None) -> Film:
    """Accumulate ``num_samples`` more samples per pixel into a new film,
    ``pixel_chunk`` pixels at a time (``accel=None``: the brute sweep); the
    last chunk holds the pixels left.  (The JAX package pads it to a whole
    chunk with copies of the last pixel, whose rays its ``rays_traced``
    counts too.)  ``fused2_block`` is the fused2 kernel's rays per block."""
    with span("owlpt.frame"):
        enable_textures = scene_has_textures(scene)
        intersect_fn, occlude_fn = integrator.make_intersectors(scene, accel, fused2_block=fused2_block)
        lights, env_light = scene_lights(scene, settings)
        dev = film.acc.device
        px = _pixel_grid(film.width, film.height, dev)
        total = px.shape[0]
        acc, state = film.acc.clone(), film.rng.clone()
        rays = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, total, pixel_chunk):
        hi = min(lo + pixel_chunk, total)
        s, r, n_rays = integrator.sample_sum(scene, settings, px[lo:hi], state[lo:hi], num_samples, intersect_fn,
                                             enable_textures, lights=lights, occlude_fn=occlude_fn,
                                             env_light=env_light)
        with span("owlpt.film"):
            acc[lo:hi] += s
            state[lo:hi] = r
        rays = rays + n_rays
    with span("owlpt.sync.rays"):
        rays = int(rays)
    return Film(acc=acc, rng=state, spp_done=film.spp_done + num_samples, width=film.width,
                height=film.height, rays_traced=film.rays_traced + rays)


def finalize(film: Film) -> torch.Tensor:
    """Average + store-time vertical flip -> f32 [H,W,3], row 0 = image top."""
    img = film.acc.reshape(film.height, film.width, 3) / max(film.spp_done, 1)
    return img.flip(0)


def render_image(scene: Scene, settings: RenderSettings, spp: int | None = None, pixel_chunk: int = 65536,
                 accel=None, intersector: str | None = None) -> torch.Tensor:
    """One-shot full-frame render -> linear f32 [H,W,3] (top row first) on
    the scene's device.  ``intersector`` names a kind for ``make_accel``
    when no ``accel`` is given."""
    if accel is None and intersector is not None:
        accel = make_accel(scene, intersector)
    film = new_film(settings, device=scene.vertices.device)
    film = add_samples(scene, settings, film, settings.max_samples if spp is None else spp,
                       pixel_chunk=pixel_chunk, accel=accel)
    return finalize(film)


def save_checkpoint(path, film: Film):
    """The film as a compressed npz (``acc``, ``rng``, ``spp_done``,
    ``width``, ``height``; numpy appends ``.npz`` to a path without it)."""
    np.savez_compressed(path, acc=film.acc.cpu().numpy(), rng=film.rng.cpu().numpy().astype(np.uint32),
                        spp_done=film.spp_done, width=film.width, height=film.height)


def load_checkpoint(path, *, device) -> Film:
    with np.load(path) as z:
        return Film(acc=torch.as_tensor(z["acc"], device=device),
                    rng=torch.as_tensor(z["rng"].astype(np.int64), device=device),
                    spp_done=int(z["spp_done"]), width=int(z["width"]), height=int(z["height"]))
