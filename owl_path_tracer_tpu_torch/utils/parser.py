"""JSON parsing: ``settings.json`` (with its sweep block) and a scene's
materials and camera.

Counterpart of ``owl_path_tracer_tpu/utils/parser.py``: what
``compile_scene`` and the CLI read.  Pure Python; the field order of
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


@dataclasses.dataclass
class TestDesc:
    """The parameter-sweep block of settings.json."""

    name: str
    material_name: str
    attribute_name: str
    material_type: int
    step_size: float
    flt_values: List[float]
    vec_values: List[Tuple[float, float, float]]


@dataclasses.dataclass
class SettingsDesc:
    scene: str
    buffer_size: Tuple[int, int]
    max_samples: int
    max_path_depth: int
    environment_use: bool
    environment_auto: bool
    environment_color: Tuple[float, float, float]
    environment_intensity: float
    test: Optional[TestDesc]


def parse_settings(settings_json_path) -> SettingsDesc:
    """settings.json -> SettingsDesc; ``test`` is None without a sweep block."""
    cfg = json.loads(pathlib.Path(settings_json_path).read_text())
    test = None
    if "test" in cfg:
        t = cfg["test"]
        flt_values, vec_values = [], []
        for v in t.get("values", []):
            if isinstance(v, (list, tuple)):
                vec_values.append(_vec3(v))
            else:
                flt_values.append(float(v))
        test = TestDesc(
            name=t["name"],
            material_name=t["material_name"],
            attribute_name=t["attribute_name"],
            material_type=int(t.get("material_type", 0)),
            step_size=float(t["step_size"]),
            flt_values=flt_values,
            vec_values=vec_values,
        )
    return SettingsDesc(
        scene=cfg["scene"],
        buffer_size=(int(cfg["buffer_size"][0]), int(cfg["buffer_size"][1])),
        max_samples=int(cfg["max_samples"]),
        max_path_depth=int(cfg["max_path_depth"]),
        environment_use=bool(cfg["environment_use"]),
        environment_auto=bool(cfg["environment_auto"]),
        environment_color=_vec3(cfg["environment_color"]),
        environment_intensity=float(cfg["environment_intensity"]),
        test=test,
    )
