"""Pinhole camera (counterpart of ``owl_path_tracer_tpu/models/camera.py``):
vertical FOV + aspect give the viewport, the focal plane sits at distance 1
along -w, and rays go through ``llc + u*horizontal + v*vertical``."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import math as m
from ..render.metrics import host_copy
from ..utils.parser import CameraDesc
from ..utils.tensors import TensorBundle


@dataclasses.dataclass
class CameraData(TensorBundle):
    origin: torch.Tensor  # [3]
    llc: torch.Tensor  # [3] lower-left corner of the raster plane
    horizontal: torch.Tensor  # [3]
    vertical: torch.Tensor  # [3]


def make_camera(desc: CameraDesc, buffer_size, *, device) -> CameraData:
    """Look-at basis -> raster-plane frame (host math in numpy)."""
    w_px, h_px = buffer_size
    aspect = float(w_px) / float(h_px)
    theta = desc.vertical_fov * np.pi / 180.0
    viewport_h = 2.0 * np.tan(theta / 2.0)
    viewport_w = aspect * viewport_h

    look_from = np.asarray(desc.look_from, np.float32)
    look_at = np.asarray(desc.look_at, np.float32)
    look_up = np.asarray(desc.look_up, np.float32)
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(look_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    v = v / np.linalg.norm(v)
    horizontal = (viewport_w * u).astype(np.float32)
    vertical = (viewport_h * v).astype(np.float32)
    llc = (look_from - horizontal / 2.0 - vertical / 2.0 - w).astype(np.float32)

    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return CameraData(origin=as_t(look_from), llc=as_t(llc),
                      horizontal=as_t(horizontal), vertical=as_t(vertical))


def primary_rays(camera: CameraData, pixel_xy, jitter, fb_size) -> tuple:
    """Jittered primary rays -> (origins [...,3], unit directions [...,3]).

    pixel_xy: [..., 2] integer pixel coords (y=0 is the bottom image row);
    jitter: [..., 2] uniforms."""
    fb = host_copy("owlpt.sync.camera", fb_size, dtype=torch.float32, device=jitter.device)
    screen = (pixel_xy.to(torch.float32) + jitter) / fb
    d = (
        camera.llc
        + screen[..., 0:1] * camera.horizontal
        + screen[..., 1:2] * camera.vertical
        - camera.origin
    )
    d = d / torch.sqrt(m.dot(d, d))[..., None]
    return camera.origin.expand(d.shape), d
