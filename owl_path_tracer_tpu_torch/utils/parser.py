"""Scene JSON parsing: materials and camera.

Counterpart of ``owl_path_tracer_tpu/utils/parser.py``, carrying over what
``compile_scene`` reads.  Pure Python/numpy; the field order of
``MATERIAL_SCALAR_FIELDS`` is the layout of the material table.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List, Optional, Tuple

# Field order matters: it is the column layout of the material table
# (models/material.py, render/integrator.py _material_blob).
MATERIAL_SCALAR_FIELDS = (
    "subsurface",
    "metallic",
    "specular",
    "specular_tint",
    "roughness",
    "anisotropic",
    "sheen",
    "sheen_tint",
    "clearcoat",
    "clearcoat_gloss",
    "ior",
    "specular_transmission",
    "specular_transmission_roughness",
    "emission",
)

MATERIAL_DEFAULTS = {
    "base_color": (0.8, 0.8, 0.8),
    "subsurface": 0.0,
    "metallic": 0.0,
    "specular": 0.5,
    "specular_tint": 1.0,
    "roughness": 0.5,
    "anisotropic": 0.0,
    "sheen": 0.0,
    "sheen_tint": 1.0,
    "clearcoat": 0.0,
    "clearcoat_gloss": 0.03,
    "ior": 1.45,
    "specular_transmission": 0.0,
    "specular_transmission_roughness": 0.0,
    "emission": 0.0,
}


@dataclasses.dataclass
class MaterialDesc:
    name: str
    base_color: Tuple[float, float, float]
    params: dict  # scalar fields, keyed by MATERIAL_SCALAR_FIELDS
    texture: Optional[str] = None  # relative path, or None


@dataclasses.dataclass
class CameraDesc:
    look_from: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    look_up: Tuple[float, float, float]
    vertical_fov: float  # degrees


def _vec3(x) -> Tuple[float, float, float]:
    return (float(x[0]), float(x[1]), float(x[2]))


def parse_materials(scene_json_path) -> List[MaterialDesc]:
    """Materials of a scene JSON. Texture path is ``{name}-textures/{filename}``."""
    cfg = json.loads(pathlib.Path(scene_json_path).read_text())
    out = []
    for mat in cfg["materials"]:
        name = mat["name"]
        texture = None
        base_color = MATERIAL_DEFAULTS["base_color"]
        if mat.get("use_texture", False):
            texture = f"{name}-textures/{mat['filename']}"
        else:
            base_color = _vec3(mat["base_color"])
        params = {
            k: float(mat.get(k, MATERIAL_DEFAULTS[k])) for k in MATERIAL_SCALAR_FIELDS
        }
        out.append(MaterialDesc(name=name, base_color=base_color, params=params, texture=texture))
    return out


def parse_camera(scene_json_path) -> CameraDesc:
    cfg = json.loads(pathlib.Path(scene_json_path).read_text())
    cam = cfg["camera"]
    return CameraDesc(
        look_from=_vec3(cam["look_from"]),
        look_at=_vec3(cam["look_at"]),
        look_up=_vec3(cam["look_up"]),
        vertical_fov=float(cam["vertical_fov"]),
    )
