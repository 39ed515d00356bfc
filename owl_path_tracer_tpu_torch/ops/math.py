"""Batched shading-frame math (counterpart of ``owl_path_tracer_tpu/ops/math.py``).

Every function maps over leading batch dimensions with vector components in
the trailing axis.  Conventions: the local shading frame has the normal at
+z, ``reflect(w, n) = 2 (w.n) n - w`` with w pointing away from the surface,
and the ONB is the branchy ``(1,1,1) x N`` construction of the JAX package.
"""
from __future__ import annotations

import torch

PI = 3.14159265358979323
TWO_PI = 6.28318530717958648
PI_OVER_TWO = 1.57079632679489661
PI_OVER_FOUR = 0.78539816339744830
INV_PI = 0.31830988618379067
INV_TWO_PI = 0.15915494309189533
INV_FOUR_PI = 0.07957747154594766
T_MIN = 1e-3
T_MAX = 1e10
ALPHA_MIN = 1e-3


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v):
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def lerp(a, b, t):
    """a + (b - a) * t."""
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def sqr(x):
    return x * x


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return sqr(w[..., 2])


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin_theta(w):
    return torch.sqrt(torch.clamp(1.0 - cos2_theta(w), min=0.0))


def tan_theta(w):
    # division by zero yields +-inf; callers mask on isinf
    return sin_theta(w) / cos_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    safe = torch.where(st == 0.0, 1.0, st)
    return torch.where(st == 0.0, 1.0, torch.clamp(w[..., 0] / safe, -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    safe = torch.where(st == 0.0, 1.0, st)
    return torch.where(st == 0.0, 1.0, torch.clamp(w[..., 1] / safe, -1.0, 1.0))


def same_hemisphere(a, b):
    return cos_theta(a) * cos_theta(b) > 0.0


def spherical_direction(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def spherical_direction_sincos(sin_t, cos_t, phi):
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def reflect(w, n):
    return 2.0 * dot(w, n)[..., None] * n - w


def refract(w, n, eta):
    """Walter-style refraction -> (ok, wi); ok is False on total internal
    reflection, and eta == 1 passes straight through (-w)."""
    cos_i = dot(w, n)
    sin2_i = torch.clamp(1.0 - sqr(cos_i), min=0.0)
    sin2_t = sqr(eta) * sin2_i
    ok = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = eta[..., None] * -w + (eta * cos_i - cos_t)[..., None] * n
    straight = (eta == 1.0)
    wi = torch.where(straight[..., None], -w, wi)
    ok = ok | straight
    return ok, wi


def onb(n):
    """Tangent frame (t, b) of normal n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    t_a = torch.stack([nz - ny, nx - nz, ny - nx], dim=-1)
    t_b = torch.stack([nz - ny, nx + nz, -ny - nx], dim=-1)
    use_a = (nx != ny) | (nx != nz)
    t = torch.where(use_a[..., None], t_a, t_b)
    t = t / torch.sqrt(dot(t, t))[..., None]
    b = cross(n, t)
    return t, b


def to_local(t, b, n, w):
    """World -> local (normal at +z), normalized."""
    v = torch.stack([dot(w, t), dot(w, b), dot(w, n)], dim=-1)
    return v / torch.sqrt(dot(v, v))[..., None]


def to_world(t, b, n, w):
    """Local -> world, normalized."""
    v = w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n
    return v / torch.sqrt(dot(v, v))[..., None]


def luminance(c):
    """Rec.709 luma."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def srgb_to_linear_gamma22(c):
    return torch.pow(torch.clamp(c, min=0.0), 2.2)
