"""Batched low-level samplers and pdfs (counterpart of
``owl_path_tracer_tpu/ops/sampling.py``).  ``u`` has shape [..., 2]."""
from __future__ import annotations

import torch

from . import math as m


def sample_uniform_disk(u):
    phi = m.TWO_PI * u[..., 1]
    r = torch.sqrt(u[..., 0])
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def sample_concentric_disk(u):
    """Concentric (Shirley) square -> disk map."""
    dx = 2.0 * u[..., 0] - 1.0
    dy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(dx) > torch.abs(dy)
    safe_dx = torch.where(dx == 0.0, 1.0, dx)
    safe_dy = torch.where(dy == 0.0, 1.0, dy)
    r = torch.where(use_x, dx, dy)
    phi = torch.where(
        use_x,
        m.PI_OVER_FOUR * (dy / safe_dx),
        m.PI_OVER_TWO - m.PI_OVER_FOUR * (dx / safe_dy),
    )
    pt = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    degenerate = (dx == 0.0) & (dy == 0.0)
    return torch.where(degenerate[..., None], 0.0, pt)


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = m.TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_cosine_hemisphere(u):
    d = sample_concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def pdf_cosine_hemisphere(wi):
    return torch.abs(m.cos_theta(wi)) * m.INV_PI


def sample_uniform_hemisphere(u):
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = m.TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_uniform_hemisphere() -> float:
    return 0.5 * m.INV_PI


def sample_uniform_triangle(u):
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)
