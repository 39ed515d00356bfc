"""One pass of a configuration, rendered again from the scene files and the
pass's sample base: a path per pixel, its radiance, the live rays it
traced, and the clusters its exact queries needed.

Each path is seeded from (pixel, sample base), draws its pixel jitter, and
bounces as the reference program's BSDF-sampling integrator: a miss takes
the environment and ends, an emissive hit its monochrome emission and ends,
a pdf under 1e-5 ends with nothing, a non-finite BSDF value retries the
bounce, and Russian roulette (no 1/q, glass exempt) starts past depth 3.
The program's renderer fixes two things (``MODES``): how a path runs out
(``"depth"``, the wavefront renderer: traces until the path has made
``max_path_depth`` bounces, retries not counted; ``"steps"``, the scan
renderer: runs ``max_path_depth`` bounce steps, retries included), and
where a hit lies (``"ray"``: at ``o + t d``, the wavefront's attribute
payload; ``"barycentric"``: at ``(1-u-v) p0 + u p1 + v p2``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng
from . import shading as sh
from .traversal import Clusters, build_clusters, closest_hit

PIXEL_CHUNK = 1 << 18  # paths traced together: bounds the reference's memory
MODES = {"wavefront": ("depth", "ray"), "scan": ("steps", "barycentric")}  # renderer -> (loop, surface)
MATERIAL_DEFAULTS = {"base_color": (0.8, 0.8, 0.8), "subsurface": 0.0, "metallic": 0.0, "specular": 0.5,
                     "specular_tint": 1.0, "roughness": 0.5, "anisotropic": 0.0, "sheen": 0.0,
                     "sheen_tint": 0.5, "clearcoat": 0.0, "clearcoat_gloss": 1.0, "ior": 1.5,
                     "specular_transmission": 0.0, "specular_transmission_roughness": 0.0, "emission": 0.0}


@dataclasses.dataclass
class RefScene:
    tri_p: torch.Tensor  # [T,3,3]
    tri_n: torch.Tensor  # [T,3,3]
    tri_mat: torch.Tensor  # [T]
    mats: dict  # field -> [M] (base_color [M,3])
    camera: tuple  # origin, llc, horizontal, vertical: [3] each
    clusters: Clusters
    width: int
    height: int
    depth: int
    env: tuple  # (use_auto_sky, color [3], intensity)


def camera(cam: dict, width: int, height: int):
    """The pinhole camera's raster-plane frame (float32, host)."""
    aspect = float(width) / float(height)
    theta = cam["vertical_fov"] * np.pi / 180.0
    viewport_h = 2.0 * np.tan(theta / 2.0)
    viewport_w = aspect * viewport_h
    look_from = np.asarray(cam["look_from"], np.float32)
    look_at = np.asarray(cam["look_at"], np.float32)
    look_up = np.asarray(cam["look_up"], np.float32)
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(look_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    v = v / np.linalg.norm(v)
    horizontal = (viewport_w * u).astype(np.float32)
    vertical = (viewport_h * v).astype(np.float32)
    llc = (look_from - horizontal / 2.0 - vertical / 2.0 - w).astype(np.float32)
    return look_from, llc, horizontal, vertical


def load_scene(config: dict, scene_dir, cluster_size: int, device, plane_dtype=torch.float32) -> RefScene:
    """The reference's scene from the configuration and its scene files."""
    with np.load(scene_dir / "reference.npz") as z:
        tri_p, tri_n, tri_mat = z["tri_p"], z["tri_n"], z["tri_mat"]
    mats_json = config["scene"]["materials"]
    mats = {}
    for f in sh.FIELDS:
        if f == "base_color":
            rows = [m.get(f, MATERIAL_DEFAULTS[f]) for m in mats_json]
            mats[f] = torch.as_tensor(np.asarray(rows, np.float32).reshape(-1, 3), device=device)
        else:
            mats[f] = torch.as_tensor(np.asarray([float(m.get(f, MATERIAL_DEFAULTS[f])) for m in mats_json],
                                                 np.float32), device=device)
    r = config["render"]
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return RefScene(
        tri_p=as_t(tri_p), tri_n=as_t(tri_n), tri_mat=as_t(tri_mat.astype(np.int64)), mats=mats,
        camera=tuple(as_t(x) for x in camera(config["scene"]["camera"], r["width"], r["height"])),
        clusters=build_clusters(tri_p, cluster_size, device, plane_dtype), width=r["width"], height=r["height"],
        depth=r["max_path_depth"],
        env=(bool(r["environment_auto"]) and not r["environment_use"],
             torch.tensor(r["environment_color"], dtype=torch.float32, device=device),
             float(r["environment_intensity"])),
    )


def _environment(scene: RefScene, d):
    auto, color, intensity = scene.env
    env = sh.sky(d) if auto else color.expand(d.shape[:-1] + (3,))
    return env * intensity


def _surface(scene: RefScene, o, d, t, tri, u, v, mode: str):
    tri = torch.clamp(tri, min=0)
    u, v = u[:, None], v[:, None]
    w = 1.0 - u - v
    n = scene.tri_n[tri]
    sh_n = w * n[:, 0] + u * n[:, 1] + v * n[:, 2]
    if mode == "ray":
        pos = o + t[:, None] * d
        len2 = sh.dot(sh_n, sh_n)
        unit = sh_n / torch.sqrt(torch.clamp(len2, min=1e-20))[..., None]
        up = torch.tensor([0.0, 0.0, 1.0], device=o.device).expand(unit.shape)
        sh_n = torch.where((len2 > 1e-12)[..., None], unit, up)
    else:
        p = scene.tri_p[tri]
        pos = w * p[:, 0] + u * p[:, 1] + v * p[:, 2]
        sh_n = sh_n / torch.sqrt(torch.clamp(sh.dot(sh_n, sh_n), min=1e-20))[..., None]
    mid = scene.tri_mat[tri]
    return pos, sh_n, {f: x[mid] for f, x in scene.mats.items()}


def _bounce(scene: RefScene, s: dict, mode: str, work: list):
    """One bounce of the live paths ``s`` (dict of [A,...] tensors)."""
    t, tri, u, v, need = closest_hit(s["o"], s["d"], scene.clusters)
    work.append(int(need.sum()))
    hit = tri >= 0
    alive = s["alive"]
    miss = alive & ~hit
    result = torch.where(miss[..., None], _environment(scene, s["d"]) * s["thr"], s["result"])
    alive = alive & hit
    pos, sh_n, mat = _surface(scene, s["o"], s["d"], t, tri, u, v, mode)
    emissive = alive & (mat["emission"] > 0.0)
    result = torch.where(emissive[..., None], mat["emission"][..., None] * s["thr"], result)
    alive = alive & ~emissive
    t_b, b_b = sh.onb(sh_n)
    wo = sh.to_local(t_b, b_b, sh_n, -s["d"])
    f, wi, pdf, lobe, st = sh.sample_bsdf(mat, wo, s["rng"], s["lobe"])
    state = torch.where(alive, st, s["rng"])
    wi_world = sh.to_world(t_b, b_b, sh_n, wi)
    alive = alive & ~(pdf < 1e-5)
    ok = alive & torch.isfinite(f).all(dim=-1)
    cos_i = torch.abs(sh.cos_theta(wi))
    f_safe = torch.where(ok[..., None], f, 0.0)
    pdf_safe = torch.where(ok, pdf, 1.0)
    thr = torch.where(ok[..., None], s["thr"] * f_safe * (cos_i / pdf_safe)[..., None], s["thr"])
    rr_active = ok & (lobe != sh.LOBE_GLASS) & (s["depth"] > 3)
    q = torch.clamp(1.0 - torch.amax(thr, dim=-1), min=0.05)
    rr_draw, rr_state = rng.draw(state)
    state = torch.where(rr_active, rr_state, state)
    return dict(o=torch.where(ok[..., None], pos, s["o"]), d=torch.where(ok[..., None], wi_world, s["d"]),
                thr=thr, result=result, rng=state, alive=alive & ~(rr_active & (rr_draw > q)),
                lobe=torch.where(ok, lobe, s["lobe"]), depth=torch.where(ok, s["depth"] + 1, s["depth"]))


def render_pass(scene: RefScene, sample_base: int, loop: str, surface: str):
    """-> (image [H,W,3] float32 on the scene's device, top row first; live
    rays; clusters needed, summed over the rays); ``MODES[renderer]`` gives
    ``loop`` and ``surface`` of a renderer's pass."""
    w, h = scene.width, scene.height
    dev = scene.tri_p.device
    img = torch.zeros((w * h, 3), device=dev)
    rays, work = 0, []
    origin, llc, horizontal, vertical = scene.camera
    fb = torch.tensor((w, h), dtype=torch.float32, device=dev)
    for lo in range(0, w * h, PIXEL_CHUNK):
        lin = torch.arange(lo, min(lo + PIXEL_CHUNK, w * h), device=dev)
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
                 depth=torch.zeros((n,), dtype=torch.int64, device=dev))
        # a retry keeps its depth: the depth loop stops at 4x the depth as a guard
        steps = scene.depth if loop == "steps" else 4 * scene.depth + 8
        for _ in range(steps):
            go = s["alive"] & (s["depth"] < scene.depth) if loop == "depth" else s["alive"]
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                break
            rays += idx.numel()
            sub = _bounce(scene, {k: x[idx] for k, x in s.items()}, surface, work)
            for k, x in sub.items():
                s[k] = s[k].index_copy(0, idx, x)
        img[lo:lo + n] = s["result"]
    return img.reshape(h, w, 3).flip(0), rays, sum(work)
