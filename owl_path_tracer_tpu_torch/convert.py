"""Carry scenes and accelerators across from host arrays.

Each function takes a structure as a dict of numpy arrays -- the JAX
package's ``Scene``, ``ClusterBVH`` or ``Fused2BVH`` as
``{field: np.asarray(getattr(x, field))}``, nested structures (materials,
camera, cluster) as nested dicts -- and returns the port's dataclass with its
tensors on ``device``.  Feeding both packages the same arrays is how the
tests give them the same scene and the same clusters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.camera import CameraData
from .models.material import Materials
from .models.scene import Scene
from .ops.cluster import ClusterBVH
from .ops.fused2 import Fused2BVH


def _tensors(cls, d: dict, device, nested: dict | None = None):
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in nested:
            kw[f.name] = nested[f.name](d[f.name], device=device)
        else:
            kw[f.name] = torch.from_numpy(np.array(d[f.name])).to(device)
    return cls(**kw)


def materials_from_numpy(d: dict, *, device) -> Materials:
    return _tensors(Materials, d, device)


def camera_from_numpy(d: dict, *, device) -> CameraData:
    return _tensors(CameraData, d, device)


def scene_from_numpy(d: dict, *, device) -> Scene:
    return _tensors(Scene, d, device, {"materials": materials_from_numpy, "camera": camera_from_numpy})


def cluster_from_numpy(d: dict, *, device) -> ClusterBVH:
    return _tensors(ClusterBVH, d, device)


def fused2_from_numpy(d: dict, *, device) -> Fused2BVH:
    """Component-plane accelerators only ([K,16,C] float32 planes)."""
    planes, attrs = np.asarray(d["planes"]), np.asarray(d["attrs"])
    if planes.shape[2] != attrs.shape[2] or planes.dtype != np.float32:
        raise NotImplementedError(
            "MXU-layout and bf16 planes (fused2-bf16) are not ported yet: ROADMAP queue 2, K1b"
        )
    return _tensors(Fused2BVH, d, device, {"cluster": cluster_from_numpy})
