"""One pass of a configuration with next-event estimation and MIS, rendered
again from the scene files and the pass's sample base: a path per pixel, its
radiance, the live path rays it traced, and the clusters that its closest-hit
queries and its shadow segments needed.

Each path is seeded, jittered and shaded on a surface as ``render.py`` does
(the wavefront's loop: ``"depth"``, the hit at ``o + t d``: ``"ray"``), and
bounces as the program's NEE integrator defines its immediate form:

* a vertex is a path's first where its depth is 0 or the pdf its ray was
  sampled with is not above 0; a miss adds the environment and ends;
* an emissive hit adds its monochrome emission, weighted against the light
  sample that could have found it by the power heuristic (weight 1 on a
  first vertex), and ends;
* at every other vertex, three draws, before the BSDF sample's, pick a
  light triangle uniformly and a point uniformly on its area; its pdf is
  per solid angle (0 where the light's cosine is under 1e-4); the BSDF's
  value and mixture pdf there (``eval_all``) give the power heuristic's
  weight; the contribution is added where the shadow segment
  ``(T_MIN, distance - T_MIN)`` meets no triangle.  A vertex at depth
  ``max_path_depth - 1`` or deeper samples no light;
* the BSDF sample is the parity sampler of ``shading.py``; the mixture pdf
  of its direction is the next vertex's MIS pdf;
* Russian roulette past depth 3 survives with q = clamp(max throughput,
  0.05, 1) and divides the throughput by q, glass included.

The program's deferred form traces each shadow segment in the next step's
mixed sweep and banks the same sums one step later, so this reference has
one form.

Where it departs from upstream's ``path_tracer/`` (``device.cu``,
``lights.hpp``): upstream renders without light samples (an emissive hit's
emission replaces the radiance and ends the path; ``lights.hpp``'s sampler,
pdf conversion and power heuristic and ``device.cu``'s visibility test are
never called), so NEE, MIS and the additive radiance here follow the
program; upstream's Russian roulette is uncompensated and spares glass, here
it is compensated and does not; upstream's sampler has no mixture pdf (its
pdf is the sampled lobe's, which this sampler keeps), the mixture of
``eval_all`` is the program's; upstream weights a light triangle by nothing
(it has no light table), here each emissive triangle is picked with
probability 1 / count, whatever its area.

``render_pass`` -> (image, live path rays, clusters the path rays needed,
work): ``work`` holds ``shadow_rays`` (segments traced: those with a
non-zero contribution), ``shadow_needed`` (for each segment, the clusters
whose box it enters before its end, nearest first with ties in cluster
order, up to and including the first that holds a hit inside the segment,
or all of them if none does) and ``mixed_needed`` (the path rays' and the
segments' clusters together: the mixed sweep's work).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import render, rng
from . import shading as sh
from .traversal import Clusters, _entries, _moller_trumbore, closest_hit

MODES = {"wavefront": ("depth", "ray")}  # renderer -> (loop, surface)
RR_START_DEPTH = 3
GRAZING_COS = 1e-4  # a light point seen closer to edge-on than this has pdf 0


@dataclasses.dataclass
class Lights:
    """The emissive triangles, in triangle order."""

    p: torch.Tensor  # [L,3,3] corners
    n: torch.Tensor  # [L,3,3] corner normals
    emission: torch.Tensor  # [L]
    area: torch.Tensor  # [L]
    index: torch.Tensor  # [T] int64: each triangle's row in the table, -1 for no light


@dataclasses.dataclass
class NeeScene(render.RefScene):
    lights: Lights | None = None


def load_scene(config: dict, scene_dir, cluster_size: int, device, **kw) -> NeeScene:
    """``render.load_scene``'s scene and its light table (areas in float32
    numpy, as the program builds its table)."""
    base = render.load_scene(config, scene_dir, cluster_size, device, **kw)
    tri_p = base.tri_p.cpu().numpy()
    emission = base.mats["emission"].cpu().numpy()[base.tri_mat.cpu().numpy()]
    ids = np.nonzero(emission > 0.0)[0]
    if len(ids) == 0:
        raise ValueError("the NEE reference needs an emissive triangle")
    p = tri_p[ids]
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    index = np.full(len(tri_p), -1, np.int64)
    index[ids] = np.arange(len(ids))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    lights = Lights(p=as_t(p), n=base.tri_n[as_t(ids)], emission=as_t(emission[ids].astype(np.float32)),
                    area=as_t(area.astype(np.float32)), index=as_t(index))
    return NeeScene(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)}, lights=lights)


# ── light samples and MIS ─────────────────────────────────────────────────


def power_heuristic(pdf_f, pdf_g):
    """beta = 2, one sample of each strategy; 0 where both pdfs are 0."""
    denom = pdf_f * pdf_f + pdf_g * pdf_g
    return torch.where(denom > 0.0, pdf_f * pdf_f / torch.where(denom > 0.0, denom, 1.0), 0.0)


def solid_angle_pdf(pdf_area, dist_sqr, cos_light):
    a = torch.abs(cos_light)
    return torch.where(a < GRAZING_COS, 0.0, pdf_area * dist_sqr / torch.where(a < GRAZING_COS, 1.0, a))


def sample_light(lights: Lights, target, u0, u1, u2):
    """A uniform light triangle (u0) and a uniform point on it (u1, u2) seen
    from ``target`` -> (unit direction, distance, solid-angle pdf, emission)."""
    count = lights.emission.shape[0]
    li = torch.clamp((u0 * count).to(torch.int64), 0, count - 1)
    su0 = torch.sqrt(u1)
    b1 = (1.0 - su0)[..., None]
    b2 = (u2 * su0)[..., None]
    b0 = 1.0 - b1 - b2
    p, n = lights.p[li], lights.n[li]
    pos = b0 * p[:, 0] + b1 * p[:, 1] + b2 * p[:, 2]
    nrm = b0 * n[:, 0] + b1 * n[:, 1] + b2 * n[:, 2]
    nrm = nrm / torch.sqrt(torch.clamp(sh.dot(nrm, nrm), min=1e-20))[..., None]
    d = pos - target
    dist_sqr = sh.dot(d, d)
    dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-20))
    direction = d / dist[..., None]
    pdf_area = 1.0 / (count * torch.clamp(lights.area[li], min=1e-12))
    return direction, dist, solid_angle_pdf(pdf_area, dist_sqr, sh.dot(-direction, nrm)), lights.emission[li]


def light_pdf_of_hit(lights: Lights, tri, d, t, n):
    """The solid-angle pdf a light sample gives the point a ray meets at
    ``t`` on triangle ``tri`` with normal ``n`` (0 off the lights)."""
    row = lights.index[torch.clamp(tri, min=0)]
    is_light = (tri >= 0) & (row >= 0)
    area = torch.where(is_light, lights.area[torch.clamp(row, min=0)], 1.0)
    pdf_area = 1.0 / (lights.emission.shape[0] * torch.clamp(area, min=1e-12))
    return torch.where(is_light, solid_angle_pdf(pdf_area, t * t, sh.dot(-d, n)), 0.0)


def eval_all(mat, wo, wi):
    """The BSDF's value at ``wi`` with each lobe weighted by its selection
    probability, and the mixture of the lobes' pdfs -> (f [N,3], pdf [N])."""
    dw = (1.0 - mat["specular_transmission"]) * (1.0 - mat["metallic"])
    mw = mat["metallic"]
    cw = 0.25 * mat["clearcoat"]
    gw = (1.0 - mat["metallic"]) * mat["specular_transmission"]
    factor = 1.0 / (mw + gw + dw + cw)
    p_metal, p_diff, p_cc, p_glass = mw * factor, dw * factor, cw * factor, gw * factor
    refl = sh.same_hemisphere(wo, wi)

    wh_r = wo + wi
    wh_r = wh_r / torch.sqrt(torch.clamp(sh.dot(wh_r, wh_r), min=1e-20))[..., None]
    wh_r = torch.where((sh.dot(wh_r, wo) < 0.0)[..., None], -wh_r, wh_r)
    up = refl & (sh.cos_theta(wo) > 0.0) & (sh.cos_theta(wi) > 0.0)
    (f_d, pdf_d), (f_m, pdf_m), (f_c, pdf_c) = (
        (torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0))
        for f, pdf in (sh.eval_diffuse(mat, wo, wi), sh.eval_metal(mat, wo, wh_r, wi),
                       sh.eval_clearcoat(mat, wo, wh_r, wi)))

    eta_i, eta_t, _ = sh.relative_eta(wo, mat["ior"])
    wh_t = -(eta_i[..., None] * wo + eta_t[..., None] * wi)
    wh_t = wh_t / torch.sqrt(torch.clamp(sh.dot(wh_t, wh_t), min=1e-20))[..., None]
    f_g, pdf_g = sh.eval_glass(mat, wo, torch.where(refl[..., None], wh_r, wh_t), wi)

    glass = p_glass > 0.0
    f = (p_diff[..., None] * f_d + p_metal[..., None] * f_m + p_cc[..., None] * f_c
         + torch.where(glass[..., None], p_glass[..., None] * f_g, 0.0))
    pdf = p_diff * pdf_d + p_metal * pdf_m + p_cc * pdf_c + p_glass * torch.where(glass, pdf_g, 0.0)
    return f + torch.where(refl[..., None], sh.eval_sheen(mat, wo, wi), 0.0), pdf


# ── shadow segments ───────────────────────────────────────────────────────


def segment_query(o, d, t_max, cl: Clusters):
    """Is there a triangle in ``(T_MIN, t_max)`` along each segment, and how
    many clusters does it need -> (occluded [N] bool, needed [N] int64): the
    boxes it enters before ``t_max``, nearest first (stable), tested until
    one holds a hit."""
    n = o.shape[0]
    occluded = torch.zeros((n,), dtype=torch.bool, device=o.device)
    needed = torch.zeros((n,), dtype=torch.int64, device=o.device)
    chunk = max(4096, min(65536, (1 << 24) // max(cl.cmin.shape[0], 1)))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ro, rd, tm = o[lo:hi], d[lo:hi], t_max[lo:hi]
        ent = _entries(ro, rd, cl)
        ent_s, ids = torch.sort(torch.where(ent < tm[:, None], ent, torch.inf), dim=1, stable=True)
        occ, need = occluded[lo:hi], needed[lo:hi]
        for col in range(ent_s.shape[1]):
            rows = torch.nonzero(torch.isfinite(ent_s[:, col]) & ~occ).squeeze(1)
            if rows.numel() == 0:
                break
            cid = ids[rows, col]
            *_, ok = _moller_trumbore(ro[rows], rd[rows], cl.planes[cid], tm[rows])
            need[rows] += 1
            occ[rows] = (ok & (cl.tri[cid] >= 0)).any(dim=-1)
    return occluded, needed


# ── the pass ──────────────────────────────────────────────────────────────


def _bounce(scene: NeeScene, s: dict, work: dict):
    """One bounce of the live paths ``s`` (dict of [A,...] tensors) with a
    light sample at each vertex that may take one."""
    t, tri, u, v, need = closest_hit(s["o"], s["d"], scene.clusters)
    work["needed"] += int(need.sum())
    thr, state = s["thr"], s["rng"]
    first = (s["depth"] == 0) | (s["pdf"] <= 0.0)
    hit = tri >= 0
    miss = s["alive"] & ~hit
    result = s["result"] + torch.where(miss[..., None], render._environment(scene, s["d"]) * thr, 0.0)
    alive = s["alive"] & hit
    pos, sh_n, mat = render._surface(scene, s["o"], s["d"], t, tri, u, v, "ray")

    emissive = alive & (mat["emission"] > 0.0)
    w_b = torch.where(first, 1.0, power_heuristic(s["pdf"], light_pdf_of_hit(scene.lights, tri, s["d"], t, sh_n)))
    result = result + torch.where(emissive[..., None], (w_b * mat["emission"])[..., None] * thr, 0.0)
    alive = alive & ~emissive
    t_b, b_b = sh.onb(sh_n)
    wo = sh.to_local(t_b, b_b, sh_n, -s["d"])

    # the light sample: its three draws come before the BSDF sample's
    u0, st = rng.draw(state)
    u1, st = rng.draw(st)
    u2, st = rng.draw(st)
    state = torch.where(alive, st, state)
    l_dir, l_dist, l_pdf, l_em = sample_light(scene.lights, pos, u0, u1, u2)
    wl = sh.to_local(t_b, b_b, sh_n, l_dir)
    f_l, pdf_b = eval_all(mat, wo, wl)
    can = alive & (l_pdf > 0.0) & (l_em > 0.0) & (s["depth"] < scene.depth - 1)
    w_l = power_heuristic(l_pdf, pdf_b)
    contrib = f_l * (torch.abs(sh.cos_theta(wl)) * l_em * w_l / torch.where(l_pdf > 0.0, l_pdf, 1.0))[..., None]
    contrib = thr * torch.nan_to_num(torch.where(can[..., None], contrib, 0.0), nan=0.0, posinf=0.0)
    seg = torch.nonzero(can & (contrib != 0.0).any(dim=-1)).squeeze(1)
    occ, seg_need = segment_query(pos[seg], l_dir[seg], l_dist[seg] - sh.T_MIN, scene.clusters)
    work["shadow_rays"] += seg.numel()
    work["shadow_needed"] += int(seg_need.sum())
    lit = torch.zeros_like(alive).index_fill(0, seg[~occ], True)
    result = result + torch.where(lit[..., None], contrib, 0.0)

    f, wi, pdf, lobe, st = sh.sample_bsdf(mat, wo, state, s["lobe"])
    state = torch.where(alive, st, state)
    wi_world = sh.to_world(t_b, b_b, sh_n, wi)
    _, pdf_mix = eval_all(mat, wo, wi)
    alive = alive & ~(pdf < 1e-5)
    ok = alive & torch.isfinite(f).all(dim=-1)
    cos_i = torch.abs(sh.cos_theta(wi))
    f_safe = torch.where(ok[..., None], f, 0.0)
    pdf_safe = torch.where(ok, pdf, 1.0)
    thr = torch.where(ok[..., None], thr * f_safe * (cos_i / pdf_safe)[..., None], thr)

    rr_active = ok & (s["depth"] > RR_START_DEPTH)
    q = torch.clamp(torch.amax(thr, dim=-1), 0.05, 1.0)
    rr_draw, rr_state = rng.draw(state)
    state = torch.where(rr_active, rr_state, state)
    survive = ~rr_active | (rr_draw < q)
    thr = torch.where((rr_active & survive)[..., None], thr / q[..., None], thr)
    return dict(o=torch.where(ok[..., None], pos, s["o"]), d=torch.where(ok[..., None], wi_world, s["d"]),
                thr=thr, result=result, rng=state, alive=alive & survive,
                lobe=torch.where(ok, lobe, s["lobe"]), depth=torch.where(ok, s["depth"] + 1, s["depth"]),
                pdf=torch.where(ok, pdf_mix, s["pdf"]))


def render_pass(scene: NeeScene, sample_base: int, loop: str, surface: str):
    """-> (image [H,W,3] float32 on the scene's device, top row first; live
    path rays; clusters the path rays needed; work of the shadow segments,
    see the module's docstring).  Only the wavefront's ``MODES``."""
    if (loop, surface) != MODES["wavefront"]:
        raise ValueError(f"the NEE reference renders the wavefront's pass only, not {loop!r} / {surface!r}")
    w, h = scene.width, scene.height
    dev = scene.tri_p.device
    img = torch.zeros((w * h, 3), device=dev)
    rays = 0
    work = {"needed": 0, "shadow_rays": 0, "shadow_needed": 0}
    origin, llc, horizontal, vertical = scene.camera
    fb = torch.tensor((w, h), dtype=torch.float32, device=dev)
    for lo in range(0, w * h, render.PIXEL_CHUNK):
        lin = torch.arange(lo, min(lo + render.PIXEL_CHUNK, w * h), device=dev)
        n = lin.shape[0]
        st = rng.seed(lin, torch.full_like(lin, sample_base & rng.MASK32))
        j0, st = rng.draw(st)
        j1, st = rng.draw(st)
        xy = torch.stack([lin % w, lin // w], -1)
        screen = (xy.to(torch.float32) + torch.stack([j0, j1], -1)) / fb
        d = llc + screen[..., 0:1] * horizontal + screen[..., 1:2] * vertical - origin
        d = d / torch.sqrt(sh.dot(d, d))[..., None]
        s = dict(o=origin.expand(d.shape), d=d, thr=torch.ones((n, 3), device=dev),
                 result=torch.zeros((n, 3), device=dev), rng=st, alive=torch.ones((n,), dtype=torch.bool, device=dev),
                 lobe=torch.full((n,), sh.LOBE_NONE, dtype=torch.int64, device=dev),
                 depth=torch.zeros((n,), dtype=torch.int64, device=dev), pdf=torch.zeros((n,), device=dev))
        # a retry keeps its depth: the loop stops at 4x the depth as a guard
        for _ in range(4 * scene.depth + 8):
            idx = torch.nonzero(s["alive"] & (s["depth"] < scene.depth)).squeeze(1)
            if idx.numel() == 0:
                break
            rays += idx.numel()
            sub = _bounce(scene, {k: x[idx] for k, x in s.items()}, work)
            for k, x in sub.items():
                s[k] = s[k].index_copy(0, idx, x)
        img[lo:lo + n] = s["result"]
    needed = work.pop("needed")
    work["mixed_needed"] = needed + work["shadow_needed"]
    return img.reshape(h, w, 3).flip(0), rays, needed, work
