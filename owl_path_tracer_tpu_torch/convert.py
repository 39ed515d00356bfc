"""Carry scenes and accelerators across from host arrays.

Each function takes a structure as a dict of numpy arrays -- the JAX
package's ``Scene``, ``ClusterBVH``, ``FusedBVH`` or ``Fused2BVH`` as
``{field: np.asarray(getattr(x, field))}``, nested structures (materials,
camera, cluster) as nested dicts -- and returns the port's dataclass with its
tensors on ``device``; ``to_numpy`` brings a dataclass of tensors
(parameters or their gradients) back as a dict of numpy arrays.  Feeding
both packages the same arrays is how the tests give them the same scene,
the same clusters and the same parameters to differentiate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.camera import CameraData
from .models.material import Materials
from .models.scene import Scene
from .ops.cluster import ClusterBVH
from .ops.fused import FusedBVH
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


def to_numpy(bundle) -> dict:
    """A dataclass of tensors (nested ones as nested dicts) -> dict of numpy
    arrays, detached and on the host; other fields as they are."""
    out = {}
    for f in dataclasses.fields(bundle):
        v = getattr(bundle, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif torch.is_tensor(v):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = v
    return out


def scene_from_numpy(d: dict, *, device) -> Scene:
    return _tensors(Scene, d, device, {"materials": materials_from_numpy, "camera": camera_from_numpy})


def cluster_from_numpy(d: dict, *, device) -> ClusterBVH:
    return _tensors(ClusterBVH, d, device)


def fused_from_numpy(d: dict, *, device) -> FusedBVH:
    """Boxes [8,K] and component planes [K,16,C], float32; the group boxes
    (the port's own) are made from the boxes."""
    as_t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return FusedBVH(boxes=as_t(d["boxes"]), planes=as_t(d["planes"]),
                    cluster=cluster_from_numpy(d["cluster"], device=device))


def fused2_from_numpy(d: dict, *, device) -> Fused2BVH:
    """Component ([K,16,C] float32) or MXU ([K,16,4C] float32 or bfloat16)
    planes.  A bfloat16 array (the ``ml_dtypes`` dtype of a JAX bf16 array)
    crosses over as its 16-bit pattern, so no ``ml_dtypes`` import is needed."""
    planes, attrs = np.asarray(d["planes"]), np.asarray(d["attrs"])
    if planes.shape[2] not in (attrs.shape[2], 4 * attrs.shape[2]):
        raise ValueError(f"planes {planes.shape} fit neither layout for attrs {attrs.shape}")
    bf16 = planes.dtype.name == "bfloat16"
    if bf16 and planes.shape[2] != 4 * attrs.shape[2]:
        raise ValueError("bf16 planes require the MXU feature layout")
    if not bf16 and planes.dtype != np.float32:
        raise ValueError(f"planes must be float32 or bfloat16, got {planes.dtype}")
    fb = _tensors(Fused2BVH, {**d, "planes": planes.view(np.int16) if bf16 else planes}, device,
                  {"cluster": cluster_from_numpy})
    if bf16:
        fb.planes = fb.planes.view(torch.bfloat16)
    return fb
