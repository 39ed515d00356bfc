"""Area lights for next-event estimation + MIS (counterpart of
``owl_path_tracer_tpu/models/lights.py``).

Uniform light-triangle pick, uniform area sample, area-to-solid-angle pdf with
a grazing-angle zero guard, and the beta=2 power heuristic.  Emission is the
material's scalar (monochrome) ``emission``, as on emissive hits.  The table
is built on the host with numpy and lands on the scene's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import math as m
from ..ops import sampling as sm
from ..utils.tensors import TensorBundle
from .scene import Scene


@dataclasses.dataclass
class LightTable(TensorBundle):
    """Per-emissive-triangle SoA."""

    p0: torch.Tensor  # [L,3]
    p1: torch.Tensor  # [L,3]
    p2: torch.Tensor  # [L,3]
    n0: torch.Tensor  # [L,3] vertex normals (for the sampled point's normal)
    n1: torch.Tensor
    n2: torch.Tensor
    emission: torch.Tensor  # [L]
    area: torch.Tensor  # [L]
    tri_id: torch.Tensor  # [L] int32 triangle ids

    @property
    def count(self) -> int:
        return self.tri_id.shape[0]


def build_light_table(scene: Scene) -> LightTable | None:
    """The scene's emissive triangles, or None when it has none."""
    ids = scene.emissive_tris.cpu().numpy()
    ids = ids[ids >= 0]
    if len(ids) == 0:
        return None
    tri = scene.tri_idx.cpu().numpy()[ids]
    v = scene.vertices.cpu().numpy()
    n = scene.normals.cpu().numpy()
    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    mat_id = scene.tri_mat.cpu().numpy()[ids]
    emission = scene.materials.emission.detach().cpu().numpy()[mat_id]  # a constant of the table
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=scene.vertices.device)  # noqa: E731
    return LightTable(
        p0=as_t(p0), p1=as_t(p1), p2=as_t(p2),
        n0=as_t(n[tri[:, 0]]), n1=as_t(n[tri[:, 1]]), n2=as_t(n[tri[:, 2]]),
        emission=as_t(emission.astype(np.float32)),
        area=as_t(area.astype(np.float32)),
        tri_id=as_t(ids.astype(np.int32)),
    )


def pdf_area_to_solid_angle(pdf_area, dist_sqr, cos_theta):
    """Area pdf -> solid-angle pdf; 0 at grazing angles (|cos| < 1e-4)."""
    a = torch.abs(cos_theta)
    return torch.where(a < 1e-4, 0.0, pdf_area * dist_sqr / torch.where(a < 1e-4, 1.0, a))


def power_heuristic(n_f, pdf_f, n_g, pdf_g):
    """beta=2 power heuristic; 0 where both pdfs are 0."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / torch.where(denom > 0.0, denom, 1.0), 0.0)


@dataclasses.dataclass
class LightSample:
    direction: torch.Tensor  # [N,3] unit, shading point -> light
    distance: torch.Tensor  # [N]
    pdf: torch.Tensor  # [N] solid-angle pdf (incl. the 1/count light choice)
    emission: torch.Tensor  # [N] scalar Le
    normal: torch.Tensor  # [N,3] light-surface normal at the sample
    tri_id: torch.Tensor  # [N] sampled light triangle id


def sample_lights(lights: LightTable, target, u3) -> LightSample:
    """Uniform light pick + uniform area sample.

    target [N,3] shading points; u3 [N,3] uniforms (light pick, 2 x barycentric).
    """
    count = lights.count
    li = torch.clamp((u3[..., 0] * count).to(torch.int64), 0, count - 1)
    bary = sm.sample_uniform_triangle(u3[..., 1:3])
    b0 = (1.0 - bary[..., 0] - bary[..., 1])[..., None]
    b1 = bary[..., 0:1]
    b2 = bary[..., 1:2]
    pos = b0 * lights.p0[li] + b1 * lights.p1[li] + b2 * lights.p2[li]
    nrm = b0 * lights.n0[li] + b1 * lights.n1[li] + b2 * lights.n2[li]
    nrm = nrm / torch.sqrt(torch.clamp(m.dot(nrm, nrm), min=1e-20))[..., None]

    d = pos - target
    dist_sqr = m.dot(d, d)
    dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-20))
    direction = d / dist[..., None]
    cos_l = m.dot(-direction, nrm)
    pdf_area = 1.0 / (count * torch.clamp(lights.area[li], min=1e-12))
    pdf = pdf_area_to_solid_angle(pdf_area, dist_sqr, cos_l)
    return LightSample(direction=direction, distance=dist, pdf=pdf, emission=lights.emission[li],
                       normal=nrm, tri_id=lights.tri_id[li])


def pdf_hit_light(lights: LightTable, tri, ray_d, t, light_n):
    """Solid-angle pdf that NEE would have given a BSDF-sampled hit of
    triangle ``tri`` at distance ``t`` (0 where ``tri`` is no light)."""
    count = lights.count
    eq = tri[:, None] == lights.tri_id[None, :]  # [N,L]; L is small
    is_light = eq.any(dim=-1)
    area = torch.where(is_light, (eq * lights.area[None, :]).sum(dim=-1), 1.0)
    pdf_area = 1.0 / (count * torch.clamp(area, min=1e-12))
    cos_l = m.dot(-ray_d, light_n)
    pdf = pdf_area_to_solid_angle(pdf_area, t * t, cos_l)
    return torch.where(is_light, pdf, 0.0)
