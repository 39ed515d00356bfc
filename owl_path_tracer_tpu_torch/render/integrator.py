"""Wavefront path integrator (counterpart of ``owl_path_tracer_tpu/render/integrator.py``):
one bounce for every lane (``trace_bounce``, ``trace_bounce_nee``), and the
scan renderer's loops over bounces and samples (``trace_paths``,
``sample_sum``, ``render_pixels``; the JAX package's ``lax.scan``s are Python
loops here).

An intersector returns a HitRecord (cluster, fused) or a (HitRecord,
attribute blob) pair (fused2).  Surface data comes from the blob where there
is one, else from one [T,24] shade-blob gather by the winning triangle
(barycentric hit position and shading normal).

Parity semantics of the JAX package's ``trace_bounce``:
  * miss -> environment radiance (map | auto sky | constant) x intensity, terminate;
  * emissive hit -> scalar (monochrome) emission x throughput, terminate;
  * pdf < 1e-5 -> kill with zero contribution;
  * non-finite f -> the bounce is retried: the lane keeps its ray, throughput
    and depth, and the retry uses up one step of the caller's depth budget;
  * Russian roulette without 1/q compensation, skipped for the glass lobe,
    active only at depth > ``rr_start_depth``.

``trace_bounce_nee`` (``settings.use_nee``) is the JAX package's
next-event-estimation bounce: at every vertex a light point (and, with an
environment map, an environment direction) is sampled, shadow-tested and
combined with the BSDF sample by the power heuristic; radiance accumulates
additively and Russian roulette is the compensated kind.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import envlight as envlight_mod
from ..models import lights as lights_mod
from ..models.material import Materials
from ..models.scene import RenderSettings, Scene
from ..ops import disney
from ..ops import math as m
from ..ops import rng as rng_mod
from ..ops import shade
from ..ops import texture as tex
from ..ops.cluster import ClusterBVH, cluster_closest_hit, cluster_occluded
from ..ops.fused import FusedBVH, fused_occluded, make_fused_intersector
from ..ops.fused2 import (
    BLOCK_RAYS, FANOUT, Fused2BVH, fused2_occluded, fused2_sweep_mixed, make_fused2_intersector,
    make_fused2_intersector_diff,
)
from ..ops.intersect import HitRecord, any_hit_brute, closest_hit_brute
from ..ops.traverse import DeviceBVH, bvh_occluded, make_bvh_intersector
from ..utils.tensors import TensorBundle
from .metrics import host_copy, span


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
    kind = shade.environment_kind(scene, settings)
    if kind == shade.ENV_MAP:
        env = tex.sample_environment(scene.env_map, ray_d)
    elif kind == shade.ENV_AUTO:
        env = tex.sky_gradient(ray_d)
    else:
        color = host_copy("owlpt.sync.env_color", settings.environment_color, dtype=torch.float32,
                          device=ray_d.device)
        env = color.expand(ray_d.shape[:-1] + (3,))
    return env * settings.environment_intensity


def _material_blob(scene: Scene):
    """[M,17] material table: base_color then the scalar fields in order."""
    return scene.materials.rows()


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
    payload is zero), material with its optional texture).

    A miss lane's ``o + t*d`` lies at t = T_MAX; while autograd records a
    gradient of the scene or the rays, its position is the ray origin
    instead, or the NEE light samples it draws there (masked, but evaluated)
    make inf / NaN factors that a zero cotangent turns into NaN gradients.
    The lanes that hit are the same either way, so the forward values are too."""
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v
    pos = ray_o + hit.t[..., None] * ray_d
    if _recording(scene, ray_o, ray_d, hit.t):
        pos = torch.where(hit.hit[..., None], pos, ray_o)

    sh_n = w * blob[:, 0:3] + u * blob[:, 3:6] + v * blob[:, 6:9]
    len2 = m.dot(sh_n, sh_n)
    unit = sh_n / torch.sqrt(torch.clamp(len2, min=1e-20))[..., None]
    up = host_copy("owlpt.sync.normal", [0.0, 0.0, 1.0], device=unit.device).expand(unit.shape)
    sh_n = torch.where((len2 > 1e-12)[..., None], unit, up)

    mat_id = blob[:, 15].to(torch.int64)
    mat = _split_materials(_material_lookup(scene, mat_id))
    if enable_textures:
        tc = w * blob[:, 9:11] + u * blob[:, 11:13] + v * blob[:, 13:15]
        mat = dataclasses.replace(mat, base_color=_tex_lookup(scene, mat_id, tc, mat.base_color))
    return pos, sh_n, mat


def _recording(scene: Scene, *tensors) -> bool:
    """Does autograd record a gradient of the scene's materials or
    environment, or of one of ``tensors``?"""
    if not torch.is_grad_enabled():
        return False
    mats = scene.materials
    return (scene.env_map.requires_grad or any(t.requires_grad for t in tensors)
            or any(getattr(mats, f.name).requires_grad for f in dataclasses.fields(mats)))


def _intersect(intersect_fn, ray_o, ray_d):
    """Intersector result -> (HitRecord, attribute blob or None), under the
    profiler range ``owlpt.intersect``."""
    with span("owlpt.intersect"):
        res = intersect_fn(ray_o, ray_d)
    if isinstance(res, HitRecord):
        return res, None
    return res


def _surface(scene: Scene, hit, blob, ray_o, ray_d, enable_textures: bool):
    if blob is None:
        return _fetch_surface(scene, hit, enable_textures)
    return _fetch_surface_blob(scene, hit, blob, ray_o, ray_d, enable_textures)


def _fetch_surface(scene: Scene, hit, enable_textures: bool):
    """Surface data by one shade-blob gather at the winning triangle ->
    (barycentric hit position ``(1-u-v) p0 + u p1 + v p2``, normalized
    interpolated shading normal, material with its optional texture).  Miss
    lanes read triangle 0.  (The JAX package also returns the geometric
    normal, which no caller reads.)"""
    tri = torch.clamp(hit.tri, min=0)
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v
    blob = scene.shade_blob[tri]  # [N,24]
    pos = w * blob[:, 0:3] + u * blob[:, 3:6] + v * blob[:, 6:9]
    sh_n = w * blob[:, 9:12] + u * blob[:, 12:15] + v * blob[:, 15:18]
    sh_n = sh_n / torch.sqrt(torch.clamp(m.dot(sh_n, sh_n), min=1e-20))[..., None]
    mat_id = scene.tri_mat[tri]
    mat = _split_materials(_material_lookup(scene, mat_id))
    if enable_textures:
        tc = w * blob[:, 18:20] + u * blob[:, 20:22] + v * blob[:, 22:24]
        mat = dataclasses.replace(mat, base_color=_tex_lookup(scene, mat_id, tc, mat.base_color))
    return pos, sh_n, mat


def trace_bounce(scene: Scene, settings: RenderSettings, state: PathState,
                 intersect_fn: Callable, enable_textures: bool) -> PathState:
    """One wavefront bounce for every lane: the closest-hit query, then the
    shading under the profiler range ``owlpt.shade``.

    The shading runs in one kernel (``ops/shade.py``) for CUDA tensors, and
    as the plain version ``_shade_bounce`` for CPU tensors and while autograd
    records a gradient through the bounce: the kernel has no backward."""
    hit, blob = _intersect(intersect_fn, state.ray_o, state.ray_d)
    with span("owlpt.shade"):
        if state.ray_o.device.type == "cpu":
            return _shade_bounce(scene, settings, state, hit, blob, enable_textures)
        grads = (state.ray_o, state.ray_d, state.result, state.throughput, hit.t, hit.uv)
        if _recording(scene, *grads, *(() if blob is None else (blob,))):
            shade.LAUNCHES[shade.PLAIN_CUDA] += 1
            return _shade_bounce(scene, settings, state, hit, blob, enable_textures)
        return PathState(**shade.shade_bounce(scene, settings, state, hit, blob, enable_textures),
                         prev_pdf=state.prev_pdf)


def _shade_bounce(scene: Scene, settings: RenderSettings, state: PathState, hit, blob,
                  enable_textures: bool) -> PathState:
    # miss -> environment, terminate
    miss = state.alive & ~hit.hit
    env = _environment_radiance(scene, settings, state.ray_d)
    result = torch.where(miss[..., None], env * state.throughput, state.result)
    alive = state.alive & hit.hit

    pos, sh_n, mat = _surface(scene, hit, blob, state.ray_o, state.ray_d, enable_textures)

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


def trace_bounce_nee(scene: Scene, settings: RenderSettings, lights, state: PathState,
                     intersect_fn: Callable, occlude_fn: Callable, enable_textures: bool,
                     allow_nee=True, env_light=None, deferred: bool = False, precomputed=None):
    """One bounce with next-event estimation + MIS for every lane.

    ``occlude_fn(pos, direction, max_dist)`` -> [N] bool shadow test.
    ``allow_nee`` (bool or [N] bool) switches the light samples off where a
    vertex is the path's last.  ``deferred=True`` (area lights only) does not
    shadow-test here: it returns ``(PathState, pending)`` with pending =
    (origin, direction, distance, contribution, active) of this vertex's
    untested light sample, which the caller traces in the next step's mixed
    sweep -- the same draws and contribution as the immediate form, banked one
    step later.  ``precomputed`` = (HitRecord, blob) of this step's rays when
    the caller has traced them already.  The shading runs under the
    profiler range ``owlpt.shade``; inside it, the area-light sample and its
    MIS weight under ``owlpt.nee`` and the shadow tests under
    ``owlpt.occlude``.

    The deferred form with area lights runs in one kernel
    (``ops/shade.py``, the whole bounce inside ``owlpt.nee``) for CUDA
    tensors while autograd records nothing; every other case, the CPU and
    the gradient path, the immediate form and the environment light, runs
    the plain version ``_shade_bounce_nee``.
    """
    if deferred and env_light is not None:
        raise ValueError("deferred NEE supports area lights only")
    if precomputed is not None:
        hit, blob = precomputed
    else:
        hit, blob = _intersect(intersect_fn, state.ray_o, state.ray_d)
    with span("owlpt.shade"):
        if state.ray_o.device.type != "cpu":
            grads = (state.ray_o, state.ray_d, state.result, state.throughput, state.prev_pdf, hit.t, hit.uv,
                     *(() if blob is None else (blob,)),
                     *(() if lights is None else (getattr(lights, f.name) for f in dataclasses.fields(lights))))
            if deferred and lights is not None and not _recording(scene, *grads):
                with span("owlpt.nee"):
                    out, pending = shade.shade_bounce_nee(scene, settings, lights, state, hit, blob,
                                                          enable_textures, allow_nee)
                return PathState(**out), pending
            shade.LAUNCHES[shade.PLAIN_CUDA_NEE] += 1
        return _shade_bounce_nee(scene, settings, lights, state, hit, blob, occlude_fn, enable_textures,
                                 allow_nee, env_light, deferred)


def _shade_bounce_nee(scene: Scene, settings: RenderSettings, lights, state: PathState, hit, blob,
                      occlude_fn: Callable, enable_textures: bool, allow_nee, env_light, deferred: bool):
    # miss -> environment; MIS-weighted against environment sampling when an
    # EnvLight is active (primary rays keep weight 1)
    first = (state.depth == 0) | (state.prev_pdf <= 0.0)
    miss = state.alive & ~hit.hit
    if env_light is not None:
        env = envlight_mod.env_radiance(env_light, state.ray_d)
        pdf_e = envlight_mod.pdf_env_direction(env_light, state.ray_d)
        w_env = torch.where(first, 1.0, lights_mod.power_heuristic(1.0, state.prev_pdf, 1.0, pdf_e))
        env = env * w_env[..., None]
    else:
        env = _environment_radiance(scene, settings, state.ray_d)
    result = state.result + torch.where(miss[..., None], env * state.throughput, 0.0)
    alive = state.alive & hit.hit

    pos, sh_n, mat = _surface(scene, hit, blob, state.ray_o, state.ray_d, enable_textures)

    # emissive hit -> MIS-weighted emission, terminate
    emissive = alive & (mat.emission > 0.0)
    if lights is not None:
        pdf_l_hit = lights_mod.pdf_hit_light(lights, hit.tri, state.ray_d, hit.t, sh_n)
        w_b = torch.where(first, 1.0, lights_mod.power_heuristic(1.0, state.prev_pdf, 1.0, pdf_l_hit))
    else:
        w_b = torch.ones_like(hit.t)
    result = result + torch.where(emissive[..., None], (w_b * mat.emission)[..., None] * state.throughput, 0.0)
    alive = alive & ~emissive

    t_b, b_b = m.onb(sh_n)
    local_wo = m.to_local(t_b, b_b, sh_n, -state.ray_d)

    # next-event estimation, area lights: the sample and its MIS weight under
    # the range ``owlpt.nee``, the immediate form's shadow test after it
    rng_state = state.rng
    pending = None
    if lights is not None:
        with span("owlpt.nee"):
            u_l, states_l = rng_mod.next_f32_n(rng_state, 3)
            rng_state = torch.where(alive, states_l[-1], rng_state)
            ls = lights_mod.sample_lights(lights, pos, torch.stack([u_l[0], u_l[1], u_l[2]], -1))
            wl_local = m.to_local(t_b, b_b, sh_n, ls.direction)
            f_l, pdf_b_l = disney.eval_all(mat, local_wo, wl_local)
            can_light = alive & (ls.pdf > 0.0) & (ls.emission > 0.0) & allow_nee
            w_l = lights_mod.power_heuristic(1.0, ls.pdf, 1.0, pdf_b_l)
            contrib = f_l * (torch.abs(m.cos_theta(wl_local)) * ls.emission * w_l
                             / torch.where(ls.pdf > 0.0, ls.pdf, 1.0))[..., None]
            if deferred:
                pend_c = state.throughput * torch.nan_to_num(
                    torch.where(can_light[..., None], contrib, 0.0), nan=0.0, posinf=0.0)
                pend_on = can_light & (pend_c != 0.0).any(dim=-1)
                pending = (pos, ls.direction, ls.distance - m.T_MIN, pend_c, pend_on)
        if not deferred:
            with span("owlpt.occlude"):
                occluded = occlude_fn(pos, ls.direction, ls.distance - m.T_MIN)
            contrib = torch.where((can_light & ~occluded)[..., None], contrib, 0.0)
            result = result + state.throughput * torch.nan_to_num(contrib, nan=0.0, posinf=0.0)

    # environment NEE (CDF importance sampling)
    if env_light is not None:
        u_e, states_e = rng_mod.next_f32_n(rng_state, 2)
        rng_state = torch.where(alive, states_e[-1], rng_state)
        es = envlight_mod.sample_env(env_light, torch.stack([u_e[0], u_e[1]], -1))
        we_local = m.to_local(t_b, b_b, sh_n, es.direction)
        f_e, pdf_b_e = disney.eval_all(mat, local_wo, we_local)
        can_env = alive & (es.pdf > 0.0) & allow_nee
        with span("owlpt.occlude"):
            env_occluded = occlude_fn(pos, es.direction, torch.full(pos.shape[:1], m.T_MAX, device=pos.device))
        w_e = lights_mod.power_heuristic(1.0, es.pdf, 1.0, pdf_b_e)
        contrib_e = f_e * es.radiance * (
            torch.abs(m.cos_theta(we_local)) * w_e / torch.where(es.pdf > 0.0, es.pdf, 1.0))[..., None]
        contrib_e = torch.where((can_env & ~env_occluded)[..., None], contrib_e, 0.0)
        result = result + state.throughput * torch.nan_to_num(contrib_e, nan=0.0, posinf=0.0)

    # BSDF sample; its mixture pdf is recorded for MIS
    bs = disney.sample(mat, local_wo, rng_state, state.prev_lobe, corrected=not settings.parity)
    rng_state = torch.where(alive, bs.state, rng_state)
    wi_world = m.to_world(t_b, b_b, sh_n, bs.wi)
    _, pdf_mix = disney.eval_all(mat, local_wo, bs.wi)

    alive = alive & ~(bs.pdf < 1e-5)
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
    prev_pdf = torch.where(ok, pdf_mix, state.prev_pdf)

    # standard compensated Russian roulette; the survival probability is
    # detached, so the 1/q compensation leaks no score terms into gradients
    beta_max = torch.amax(throughput, dim=-1)
    rr_active = ok & (state.depth > settings.rr_start_depth)
    q = torch.clamp(beta_max, 0.05, 1.0).detach()
    rr_draw, rr_state = rng_mod.next_f32(rng_state)
    rng_state = torch.where(rr_active, rr_state, rng_state)
    survive = ~rr_active | (rr_draw < q)
    throughput = torch.where((rr_active & survive)[..., None], throughput / q[..., None], throughput)
    alive = alive & survive

    depth = torch.where(ok, state.depth + 1, state.depth)
    out = PathState(
        ray_o=ray_o, ray_d=ray_d, result=result, throughput=throughput, rng=rng_state,
        alive=alive, prev_lobe=prev_lobe, depth=depth, prev_pdf=prev_pdf,
    )
    if not deferred:
        return out
    if pending is None:  # no lights: nothing to defer
        n = ray_o.shape[0]
        pending = (ray_o, ray_d, torch.zeros((n,), device=ray_o.device),
                   torch.zeros((n, 3), device=ray_o.device),
                   torch.zeros((n,), dtype=torch.bool, device=ray_o.device))
    return out, pending


def make_mixed_sweep_fn(accel, fused2_block: int | None = None, fused2_sort=False,
                        fused2_fanout: int | None = None):
    """Mixed closest-hit + any-hit sweep for the deferred-NEE wavefront:
    ``sweep(ray_o, ray_d, t_max, shadow)`` -> (HitRecord, blob, occluded); or
    None when the accelerator has no mixed kernel (every kind but fused2),
    and the wavefront then takes the separate form."""
    if not isinstance(accel, Fused2BVH):
        return None
    blk = fused2_block or BLOCK_RAYS
    fo = fused2_fanout or FANOUT

    def sweep(ray_o, ray_d, t_max, shadow):
        return fused2_sweep_mixed(ray_o, ray_d, t_max, shadow, accel, sort=fused2_sort, block=blk, fanout=fo)

    return sweep


def make_brute_intersector(scene: Scene, tri_chunk: int = 512) -> Callable:
    """Closest hit by the brute sweep over every triangle (the exact oracle)."""
    def intersect(ray_o, ray_d):
        return closest_hit_brute(ray_o, ray_d, scene.vertices, scene.tri_idx, tri_chunk=tri_chunk)

    return intersect


def make_brute_occluder(scene: Scene, tri_chunk: int = 512) -> Callable:
    """Occlusion by the brute sweep, ``occlude(pos, direction, max_dist)``."""
    def occlude(pos, direction, max_dist):
        return any_hit_brute(pos, direction, scene.vertices, scene.tri_idx, t_max=max_dist, tri_chunk=tri_chunk)

    return occlude


def make_intersectors(scene: Scene, accel, tri_chunk: int = 512, fused2_block: int | None = None,
                      fused2_sort=False, fused2_fanout: int | None = None, differentiable: bool = False):
    """Accel -> (intersect_fn, occlude_fn), shared by the scan renderer, the
    wavefront and the gradient path.

    * ``Fused2BVH``: closest hit + attribute blob through kernel K1 (component
      planes) or K1b (MXU planes), occlusion through K2 or K1b's any-hit mode;
      ``fused2_block``, ``fused2_sort`` and ``fused2_fanout`` (default FANOUT,
      clusters retired per loop iteration on the MXU layout) apply to it only;
      ``differentiable=True`` (render/diff.py) re-derives the winner's t/u/v
      from the live rays (``fused2_closest_hit_diff``), so camera gradients
      flow through the kernel's detached winners;
    * ``FusedBVH``: closest hit through kernel K5, occlusion as its hit test;
    * ``ClusterBVH``: the exact cluster query (plain PyTorch);
    * ``DeviceBVH``: the per-ray-stack traversal (plain PyTorch);
    * ``None``: the brute sweep over every triangle, ``tri_chunk`` at a time
      (plain PyTorch; the exact oracle of the gradient tests)."""
    if isinstance(accel, Fused2BVH):
        blk = fused2_block or BLOCK_RAYS
        fo = fused2_fanout or FANOUT

        def occlude(pos, direction, max_dist):
            return fused2_occluded(pos, direction, accel, t_max=max_dist, block=blk, sort=fused2_sort,
                                   fanout=fo)

        if differentiable:
            isect = make_fused2_intersector_diff(accel, scene.vertices, scene.tri_idx, block=blk,
                                                 sort=fused2_sort, fanout=fo)
        else:
            isect = make_fused2_intersector(accel, block=blk, sort=fused2_sort, fanout=fo)
        return isect, occlude
    if isinstance(accel, FusedBVH):
        return (make_fused_intersector(accel),
                lambda p, d, dist: fused_occluded(p, d, accel, t_max=dist))
    if isinstance(accel, ClusterBVH):
        return (lambda o, d: cluster_closest_hit(o, d, accel),
                lambda p, d, dist: cluster_occluded(p, d, accel, t_max=dist))
    if isinstance(accel, DeviceBVH):
        return (make_bvh_intersector(accel),
                lambda p, d, dist: bvh_occluded(p, d, accel, t_max=dist))
    if accel is None:
        return make_brute_intersector(scene, tri_chunk), make_brute_occluder(scene, tri_chunk)
    raise TypeError(f"unknown accelerator {type(accel).__name__}")


def trace_paths(scene: Scene, settings: RenderSettings, ray_o, ray_d, rng_state, intersect_fn: Callable,
                enable_textures: bool, lights=None, occlude_fn: Callable | None = None, env_light=None):
    """Trace a wavefront for ``settings.max_path_depth`` bounces, each under
    the range ``owlpt.step`` -> (radiance [N,3], advanced rng [N], live rays
    traced as a 0-dim int64 tensor)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    st = PathState(
        ray_o=ray_o, ray_d=ray_d, result=torch.zeros((n, 3), device=dev),
        throughput=torch.ones((n, 3), device=dev), rng=rng_state,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_lobe=torch.full((n,), disney.LOBE_NONE, dtype=torch.int64, device=dev),
        depth=torch.zeros((n,), dtype=torch.int64, device=dev), prev_pdf=torch.zeros((n,), device=dev),
    )
    use_nee = settings.use_nee and occlude_fn is not None and (lights is not None or env_light is not None)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(settings.max_path_depth):
        with span("owlpt.step"):
            rays = rays + st.alive.sum()
            if use_nee:
                # the last bounce samples no light: a depth-D render integrates
                # transport orders 1..D, as the BSDF-only estimator does
                st = trace_bounce_nee(scene, settings, lights, st, intersect_fn, occlude_fn, enable_textures,
                                      allow_nee=k < settings.max_path_depth - 1, env_light=env_light)
            else:
                st = trace_bounce(scene, settings, st, intersect_fn, enable_textures)
    return st.result, st.rng, rays


def sample_sum(scene: Scene, settings: RenderSettings, pixel_xy, rng_state, num_samples: int,
               intersect_fn: Callable, enable_textures: bool, lights=None,
               occlude_fn: Callable | None = None, env_light=None):
    """Accumulate ``num_samples`` samples per pixel, resumable: the carried
    LCG state keeps each pixel's stream continuous across calls.

    Returns (radiance sum [N,3], advanced rng state [N], live rays traced as a
    0-dim int64 tensor)."""
    from ..models.camera import primary_rays

    st = rng_state
    acc = torch.zeros(pixel_xy.shape[:-1] + (3,), device=pixel_xy.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixel_xy.device)
    for _ in range(num_samples):
        j0, st = rng_mod.next_f32(st)
        j1, st = rng_mod.next_f32(st)
        o, d = primary_rays(scene.camera, pixel_xy, torch.stack([j0, j1], -1), (settings.width, settings.height))
        radiance, st, r = trace_paths(scene, settings, o, d, st, intersect_fn, enable_textures,
                                      lights=lights, occlude_fn=occlude_fn, env_light=env_light)
        with span("owlpt.film"):
            acc = acc + radiance
        rays = rays + r
    return acc, st, rays


def render_pixels(scene: Scene, settings: RenderSettings, pixel_xy, intersect_fn: Callable,
                  enable_textures: bool, num_samples: int | None = None):
    """Render a chunk of pixels ([N,2] integer coordinates, y = 0 the bottom
    row) -> linear color [N,3], averaged over the samples."""
    spp = settings.max_samples if num_samples is None else num_samples
    state0 = rng_mod.seed(pixel_xy[..., 0], pixel_xy[..., 1])
    acc, _, _ = sample_sum(scene, settings, pixel_xy, state0, spp, intersect_fn, enable_textures)
    return acc / float(spp)
