"""Texture and environment lookups (counterpart of ``owl_path_tracer_tpu/ops/texture.py``):
nearest filtering (the reference's) or bilinear (a quality mode no parity
render uses), clamp addressing, lat-long environment via ``uv_on_sphere``."""
from __future__ import annotations

import torch

from ..render.metrics import host_copy
from . import math as m


def uv_on_sphere(d):
    """Direction [...,3] -> lat-long uv [...,2]."""
    u = 0.5 + torch.atan2(d[..., 0], d[..., 2]) / (2.0 * m.PI)
    v = 0.5 + torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / m.PI
    return torch.stack([u, v], dim=-1)


def sample_nearest(tex, uv):
    """Nearest-clamp lookup of tex [H,W,C] at uv [...,2] (texel floor(u*W))."""
    h, w = tex.shape[0], tex.shape[1]
    x = torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return tex[y, x]


def sample_bilinear(tex, uv):
    """Bilinear-clamp lookup of tex [H,W,C] at uv [...,2] (texel centres at (i + 0.5) / W)."""
    h, w = tex.shape[0], tex.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    return (tex[y0c, x0c] * (1 - tx) * (1 - ty) + tex[y0c, x1c] * tx * (1 - ty)
            + tex[y1c, x0c] * (1 - tx) * ty + tex[y1c, x1c] * tx * ty)


def sample_environment(env, d, bilinear: bool = False):
    """Environment radiance for miss directions."""
    uv = uv_on_sphere(d)
    return sample_bilinear(env, uv) if bilinear else sample_nearest(env, uv)


def sky_gradient(d):
    """The ``environment_auto`` sky: white to (0.5, 0.7, 1.0) with height."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = torch.ones(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    blue = host_copy("owlpt.sync.sky", [0.5, 0.7, 1.0], dtype=d.dtype, device=d.device).expand(white.shape)
    return m.lerp(white, blue, t[..., None])


def sample_atlas_nearest(atlas, tex_id, uv, tex_hw=None):
    """Stacked-texture lookup: atlas [K,H,W,3], tex_id [...], uv [...,2].

    ``tex_hw`` [K,2] holds each texture's true (h,w) before padding, so uv
    scales by the texture's own size; tex_id < 0 returns zeros."""
    k = torch.clamp(tex_id, min=0).to(torch.int64)
    if tex_hw is None:
        h = torch.full(k.shape, float(atlas.shape[1]), device=atlas.device)
        w = torch.full(k.shape, float(atlas.shape[2]), device=atlas.device)
    else:
        hw = tex_hw[k]
        h, w = hw[..., 0], hw[..., 1]
    x = torch.minimum(torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int64), min=0),
                      (w - 1).to(torch.int64))
    y = torch.minimum(torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int64), min=0),
                      (h - 1).to(torch.int64))
    out = atlas[k, y, x]
    return torch.where((tex_id >= 0)[..., None], out, 0.0)
