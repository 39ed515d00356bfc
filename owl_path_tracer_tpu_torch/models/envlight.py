"""Environment-map importance sampling (lat-long CDF) for NEE + MIS
(counterpart of ``owl_path_tracer_tpu/models/envlight.py``).

A luminance-weighted 2-D CDF over the lat-long map (rows marginal, columns
conditional), exact texel solid angles, and the inverse of
``texture.uv_on_sphere``.  The tables are built on the host with numpy (the
same arithmetic as the JAX package, so the same float32 tables) and land on
the device of the map.

The JAX package finds the column of a sample by gathering the whole CDF row
of every lane ([N,W]) and counting entries below u.  Here one
``torch.searchsorted`` over a flat int64 key table gives the same count with
[N] memory: a key is the entry's row in the high 32 bits and its float32 bit
pattern in the low ones.  Non-negative floats order as their bit patterns,
so the keys ascend over the whole table and compare exactly as the entries
do (a float64 table of entry + row would round entries far below 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import math as m
from ..ops import texture as tex
from ..utils.tensors import TensorBundle


@dataclasses.dataclass
class EnvLight(TensorBundle):
    env_map: torch.Tensor  # [H,W,3] radiance (before intensity)
    row_cdf: torch.Tensor  # [H] inclusive cdf over rows
    col_cdf: torch.Tensor  # [H,W] inclusive cdf per row
    pdf_map: torch.Tensor  # [H,W] solid-angle pdf per texel
    col_keys: torch.Tensor  # [H*W] int64 search keys of col_cdf (row << 32 | float bits)
    intensity: float


def build_env_light(env_map, intensity: float = 1.0) -> EnvLight | None:
    """Tables for a [H,W,3] map (tensor or array); None for a 1-texel
    placeholder map or a non-positive intensity."""
    device = env_map.device if isinstance(env_map, torch.Tensor) else "cpu"
    env = env_map.cpu().numpy() if isinstance(env_map, torch.Tensor) else env_map
    env = np.asarray(env, np.float32)
    if env.ndim != 3 or env.shape[0] <= 1 or intensity <= 0.0:
        return None
    h, w = env.shape[:2]
    lum = 0.2126 * env[..., 0] + 0.7152 * env[..., 1] + 0.0722 * env[..., 2]
    # row v spans elevations [(v0-0.5)pi, (v1-0.5)pi]: exact texel solid angle
    edges = np.linspace(-0.5 * np.pi, 0.5 * np.pi, h + 1)
    d_sin = np.maximum(np.sin(edges[1:]) - np.sin(edges[:-1]), 1e-12)
    texel_omega = (2 * np.pi / w) * d_sin[:, None]
    weight = lum * texel_omega + 1e-20
    row_w = weight.sum(axis=1)
    total = row_w.sum()
    row_cdf = np.cumsum(row_w) / total
    col_cdf = np.cumsum(weight, axis=1) / row_w[:, None]
    pdf_map = (weight / total) / texel_omega
    col_cdf = col_cdf.astype(np.float32)
    col_keys = (np.arange(h, dtype=np.int64)[:, None] << 32) + col_cdf.view(np.int32)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return EnvLight(
        env_map=as_t(env), row_cdf=as_t(row_cdf.astype(np.float32)), col_cdf=as_t(col_cdf),
        pdf_map=as_t(pdf_map.astype(np.float32)), col_keys=as_t(col_keys.reshape(-1)),
        intensity=float(intensity),
    )


def _uv_to_direction(u, v):
    """Inverse of ``texture.uv_on_sphere``."""
    phi = (u - 0.5) * m.TWO_PI
    elev = (v - 0.5) * m.PI
    ce = torch.cos(elev)
    return torch.stack([ce * torch.sin(phi), torch.sin(elev), ce * torch.cos(phi)], dim=-1)


@dataclasses.dataclass
class EnvSample:
    direction: torch.Tensor  # [N,3]
    radiance: torch.Tensor  # [N,3] (intensity applied)
    pdf: torch.Tensor  # [N] solid-angle pdf


def sample_env_texel(env: EnvLight, u2):
    """CDF inversion of u2 [N,2] -> (row, col) int64 texel indices."""
    h, w = env.env_map.shape[0], env.env_map.shape[1]
    row = torch.clamp(torch.searchsorted(env.row_cdf, u2[..., 0].contiguous()), 0, h - 1)
    # the count of row entries below u: a u above the whole row lands on the
    # next row's first key, count w, clamped as the reference clamps it
    key = (row << 32) + u2[..., 1].contiguous().view(torch.int32).to(torch.int64)
    col = torch.clamp(torch.searchsorted(env.col_keys, key) - row * w, 0, w - 1)
    return row, col


def sample_env(env: EnvLight, u2) -> EnvSample:
    """CDF inversion: u2 [N,2] -> direction, radiance and pdf."""
    h, w = env.env_map.shape[0], env.env_map.shape[1]
    row, col = sample_env_texel(env, u2)
    u = (col.to(torch.float32) + 0.5) / w
    v = (row.to(torch.float32) + 0.5) / h
    d = _uv_to_direction(u, v)
    radiance = env.env_map[row, col] * env.intensity
    pdf = env.pdf_map[row, col]
    return EnvSample(direction=d, radiance=radiance, pdf=pdf)


def pdf_env_direction(env: EnvLight, d):
    """Solid-angle pdf the CDF sampler gives direction ``d`` (the MIS
    counterpart for BSDF-sampled rays that escape to the sky)."""
    uv = tex.uv_on_sphere(d)
    h, w = env.pdf_map.shape
    x = torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return env.pdf_map[y, x]


def env_radiance(env: EnvLight, d):
    return tex.sample_environment(env.env_map, d) * env.intensity
