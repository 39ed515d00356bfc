"""One wavefront bounce (counterpart of ``owl_path_tracer_tpu/render/integrator.py``).

Parity semantics of the JAX package's ``trace_bounce``:
  * miss -> environment radiance (map | auto sky | constant) x intensity, terminate;
  * emissive hit -> scalar (monochrome) emission x throughput, terminate;
  * pdf < 1e-5 -> kill with zero contribution;
  * non-finite f -> the bounce is retried: the lane keeps its ray, throughput
    and depth, and the retry uses up one step of the caller's depth budget;
  * Russian roulette without 1/q compensation, skipped for the glass lobe,
    active only at depth > ``rr_start_depth``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.material import Materials
from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import math as m
from ..ops import rng as rng_mod
from ..ops import texture as tex
from ..ops.fused2 import BLOCK_RAYS, Fused2BVH, make_fused2_intersector
from ..utils.tensors import TensorBundle


@dataclasses.dataclass
class PathState(TensorBundle):
    ray_o: torch.Tensor  # [N,3]
    ray_d: torch.Tensor  # [N,3]
    result: torch.Tensor  # [N,3] radiance x throughput once terminated
    throughput: torch.Tensor  # [N,3]
    rng: torch.Tensor  # [N] int64 LCG state in [0, 2^32)
    alive: torch.Tensor  # [N] bool
    prev_lobe: torch.Tensor  # [N] int64 lobe of the previous bounce
    depth: torch.Tensor  # [N] int64 logical depth
    prev_pdf: torch.Tensor  # [N] pdf of the spawning BSDF sample (NEE/MIS; carried)


def _environment_radiance(scene: Scene, settings: RenderSettings, ray_d):
    if settings.environment_use and scene.env_map.shape[0] > 1:
        env = tex.sample_environment(scene.env_map, ray_d)
    elif settings.environment_auto:
        env = tex.sky_gradient(ray_d)
    else:
        color = torch.tensor(settings.environment_color, dtype=torch.float32, device=ray_d.device)
        env = color.expand(ray_d.shape[:-1] + (3,))
    return env * settings.environment_intensity


def _material_blob(scene: Scene):
    """[M,17] material table: base_color then the scalar fields in order."""
    mt = scene.materials
    cols = [mt.base_color] + [
        getattr(mt, f.name)[:, None] for f in dataclasses.fields(mt) if f.name != "base_color"
    ]
    return torch.cat(cols, dim=1)


def _material_lookup(scene: Scene, mat_id):
    """Material rows by index.  (The JAX package multiplies a one-hot matrix
    on the TPU; indexing gives the same values and no matmul precision mode
    can round them.)"""
    return _material_blob(scene)[mat_id]


def _split_materials(mblob) -> Materials:
    names = [f.name for f in dataclasses.fields(Materials) if f.name != "base_color"]
    return Materials(base_color=mblob[:, 0:3], **{f: mblob[:, 3 + i] for i, f in enumerate(names)})


def _tex_lookup(scene: Scene, mat_id, tc, base_color):
    tex_id = scene.mat_tex[mat_id]
    tex_color = tex.sample_atlas_nearest(scene.textures, tex_id, tc, scene.tex_hw)
    return torch.where((tex_id >= 0)[..., None], tex_color, base_color)


def _fetch_surface_blob(scene: Scene, hit, blob, ray_o, ray_d, enable_textures: bool):
    """Surface data from the traversal's attribute payload -> (hit position
    ``o + t*d``, interpolated shading normal (unit +z for miss lanes, whose
    payload is zero), material with its optional texture)."""
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v
    pos = ray_o + hit.t[..., None] * ray_d

    sh_n = w * blob[:, 0:3] + u * blob[:, 3:6] + v * blob[:, 6:9]
    len2 = m.dot(sh_n, sh_n)
    unit = sh_n / torch.sqrt(torch.clamp(len2, min=1e-20))[..., None]
    up = torch.tensor([0.0, 0.0, 1.0], device=unit.device).expand(unit.shape)
    sh_n = torch.where((len2 > 1e-12)[..., None], unit, up)

    mat_id = blob[:, 15].to(torch.int64)
    mat = _split_materials(_material_lookup(scene, mat_id))
    if enable_textures:
        tc = w * blob[:, 9:11] + u * blob[:, 11:13] + v * blob[:, 13:15]
        mat = dataclasses.replace(mat, base_color=_tex_lookup(scene, mat_id, tc, mat.base_color))
    return pos, sh_n, mat


def trace_bounce(scene: Scene, settings: RenderSettings, state: PathState,
                 intersect_fn: Callable, enable_textures: bool) -> PathState:
    """One wavefront bounce for every lane."""
    hit, blob = intersect_fn(state.ray_o, state.ray_d)

    # miss -> environment, terminate
    miss = state.alive & ~hit.hit
    env = _environment_radiance(scene, settings, state.ray_d)
    result = torch.where(miss[..., None], env * state.throughput, state.result)
    alive = state.alive & hit.hit

    pos, sh_n, mat = _fetch_surface_blob(
        scene, hit, blob, state.ray_o, state.ray_d, enable_textures
    )

    # emissive -> monochrome radiance, terminate
    emissive = alive & (mat.emission > 0.0)
    result = torch.where(emissive[..., None], mat.emission[..., None] * state.throughput, result)
    alive = alive & ~emissive

    # local frame + BSDF sample
    t_b, b_b = m.onb(sh_n)
    local_wo = m.to_local(t_b, b_b, sh_n, -state.ray_d)
    bs = disney.sample(mat, local_wo, state.rng, state.prev_lobe, corrected=not settings.parity)
    rng_state = torch.where(alive, bs.state, state.rng)
    wi_world = m.to_world(t_b, b_b, sh_n, bs.wi)

    # degenerate pdf -> kill with zero contribution
    alive = alive & ~(bs.pdf < 1e-5)

    # non-finite f -> retry the bounce (the lane keeps its ray and depth)
    bad_f = ~torch.isfinite(bs.f).all(dim=-1)
    ok = alive & ~bad_f

    cos_i = torch.abs(m.cos_theta(bs.wi))
    f_safe = torch.where(ok[..., None], bs.f, 0.0)
    pdf_safe = torch.where(ok, bs.pdf, 1.0)
    thr_new = state.throughput * f_safe * (cos_i / pdf_safe)[..., None]
    throughput = torch.where(ok[..., None], thr_new, state.throughput)
    ray_o = torch.where(ok[..., None], pos, state.ray_o)
    ray_d = torch.where(ok[..., None], wi_world, state.ray_d)
    prev_lobe = torch.where(ok, bs.lobe, state.prev_lobe)

    # inverted Russian roulette, no 1/q compensation, glass-exempt
    beta_max = torch.amax(throughput, dim=-1)
    rr_active = ok & (bs.lobe != disney.LOBE_GLASS) & (state.depth > settings.rr_start_depth)
    q = torch.clamp(1.0 - beta_max, min=0.05)
    rr_draw, rr_state = rng_mod.next_f32(rng_state)
    rng_state = torch.where(rr_active, rr_state, rng_state)
    alive = alive & ~(rr_active & (rr_draw > q))

    depth = torch.where(ok, state.depth + 1, state.depth)
    return PathState(
        ray_o=ray_o, ray_d=ray_d, result=result, throughput=throughput, rng=rng_state,
        alive=alive, prev_lobe=prev_lobe, depth=depth, prev_pdf=state.prev_pdf,
    )


def make_intersectors(scene: Scene, accel, fused2_block: int | None = None, fused2_sort=False):
    """Accel -> (intersect_fn, occlude_fn).  Only the fused2 accelerator is
    ported; its occlusion query belongs to the NEE slice (ROADMAP)."""
    if not isinstance(accel, Fused2BVH):
        raise NotImplementedError(
            f"only the fused2 accelerator is ported; got {type(accel).__name__} (ROADMAP queue 1)"
        )

    def occlude(pos, direction, max_dist):
        raise NotImplementedError("fused2 occlusion (kernel K2) belongs to the NEE slice: ROADMAP")

    isect = make_fused2_intersector(accel, block=fused2_block or BLOCK_RAYS, sort=fused2_sort)
    return isect, occlude
