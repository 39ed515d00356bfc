"""Scene compilation: JSON + OBJ assets -> a dataclass of tensors
(counterpart of ``owl_path_tracer_tpu/models/scene.py``).

Entity semantics match the JAX package: an OBJ object becomes an entity iff a
material of the same name exists, entities are flattened into one global
triangle soup with per-triangle material and mesh ids, and a material's
texture (if its file exists) overrides base_color by nearest-clamp lookup.
The host work is numpy; the result lands on the caller's ``device``.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import obj as obj_loader
from ..utils import parser
from ..utils.image import load_environment, load_texture_rgba8
from ..utils.tensors import TensorBundle
from . import material as material_mod
from .camera import CameraData, make_camera


@dataclasses.dataclass
class Scene(TensorBundle):
    vertices: torch.Tensor  # [V,3] f32
    normals: torch.Tensor  # [V,3] f32
    texcoords: torch.Tensor  # [V,2] f32
    tri_idx: torch.Tensor  # [T,3] int32 into the global vertex arrays
    tri_mat: torch.Tensor  # [T] int32 material id per triangle
    tri_mesh: torch.Tensor  # [T] int32 entity id per triangle
    shade_blob: torch.Tensor  # [T,24] p0 p1 p2 n0 n1 n2 (3 each), tc0 tc1 tc2 (2 each)
    materials: material_mod.Materials
    mat_tex: torch.Tensor  # [M] int32 index into textures, -1 = none
    textures: torch.Tensor  # [K,TH,TW,3] f32 (stacked, zero-padded); K >= 1
    tex_hw: torch.Tensor  # [K,2] f32 true (h,w) of each texture before padding
    env_map: torch.Tensor  # [EH,EW,3] f32
    emissive_tris: torch.Tensor  # [L] int32 triangle ids with emission > 0 ([-1] if none)
    camera: CameraData

    @property
    def num_tris(self) -> int:
        return self.tri_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration."""

    width: int
    height: int
    max_samples: int
    max_path_depth: int
    environment_use: bool = False
    environment_auto: bool = False
    environment_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    environment_intensity: float = 1.0
    parity: bool = True  # reproduce the reference BSDF's quirks (ops/disney.py)
    use_nee: bool = False  # next-event estimation + MIS (integrator.trace_bounce_nee)
    rr_start_depth: int = 3  # Russian roulette applies when depth > this


def _shade_blob(vertices, normals, texcoords, tri_idx) -> np.ndarray:
    parts = [vertices[tri_idx[:, c]] for c in range(3)]
    parts += [normals[tri_idx[:, c]] for c in range(3)]
    parts += [texcoords[tri_idx[:, c]] for c in range(3)]
    return np.concatenate(parts, axis=1).astype(np.float32)


def _scene(arrays: dict, materials, camera, device) -> Scene:
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return Scene(materials=materials, camera=camera, **{k: as_t(v) for k, v in arrays.items()})


def compile_scene(assets_path, scene_name: str, buffer_size: Tuple[int, int],
                  env_map_path: Optional[str] = "environment.hdr", *, device) -> Scene:
    """Load ``{scene}.json`` + ``{scene}.obj.scene`` and flatten."""
    assets = pathlib.Path(assets_path)
    scene_json = assets / f"{scene_name}.json"
    mat_descs = parser.parse_materials(scene_json)
    cam_desc = parser.parse_camera(scene_json)
    meshes = obj_loader.load_obj(assets / f"{scene_name}.obj.scene")

    mat_names = [d.name for d in mat_descs]
    entities = [(mesh, mat_names.index(name)) for name, mesh in meshes if name in mat_names]

    v_list, n_list, t_list, i_list, m_list, e_list = [], [], [], [], [], []
    base = 0
    for mesh_id, (mesh, mat_id) in enumerate(entities):
        v_list.append(mesh.vertices)
        n_list.append(mesh.normals)
        t_list.append(mesh.texcoords)
        i_list.append(mesh.indices + base)
        m_list.append(np.full(len(mesh.indices), mat_id, np.int32))
        e_list.append(np.full(len(mesh.indices), mesh_id, np.int32))
        base += len(mesh.vertices)
    vertices = np.concatenate(v_list) if v_list else np.zeros((1, 3), np.float32)
    normals = np.concatenate(n_list) if n_list else np.zeros((1, 3), np.float32)
    texcoords = np.concatenate(t_list) if t_list else np.zeros((1, 2), np.float32)
    tri_idx = np.concatenate(i_list) if i_list else np.zeros((1, 3), np.int32)
    tri_mat = np.concatenate(m_list) if m_list else np.zeros((1,), np.int32)
    tri_mesh = np.concatenate(e_list) if e_list else np.zeros((1,), np.int32)

    # textures: every referenced image, stacked and zero-padded to the max extent
    tex_arrays = []
    mat_tex = np.full(len(mat_descs), -1, np.int32)
    for i, d in enumerate(mat_descs):
        if d.texture is not None and (assets / d.texture).exists():
            img = load_texture_rgba8(assets / d.texture)
            mat_tex[i] = len(tex_arrays)
            tex_arrays.append(img[..., :3].astype(np.float32) / 255.0)
    if tex_arrays:
        th = max(a.shape[0] for a in tex_arrays)
        tw = max(a.shape[1] for a in tex_arrays)
        stack = np.zeros((len(tex_arrays), th, tw, 3), np.float32)
        tex_hw = np.zeros((len(tex_arrays), 2), np.float32)
        for k, a in enumerate(tex_arrays):
            stack[k, : a.shape[0], : a.shape[1]] = a
            tex_hw[k] = (a.shape[0], a.shape[1])
    else:
        stack = np.zeros((1, 1, 1, 3), np.float32)
        tex_hw = np.ones((1, 2), np.float32)

    env = np.zeros((1, 1, 3), np.float32)
    if env_map_path is not None:
        env = load_environment(assets / env_map_path)

    emission = np.asarray([d.params["emission"] for d in mat_descs], np.float32)
    emissive = np.nonzero(emission[tri_mat] > 0.0)[0].astype(np.int32)
    if emissive.size == 0:
        emissive = np.asarray([-1], np.int32)

    return _scene(
        dict(
            vertices=vertices, normals=normals, texcoords=texcoords, tri_idx=tri_idx,
            tri_mat=tri_mat, tri_mesh=tri_mesh,
            shade_blob=_shade_blob(vertices, normals, texcoords, tri_idx),
            mat_tex=mat_tex, textures=stack, tex_hw=tex_hw, env_map=env,
            emissive_tris=emissive,
        ),
        material_mod.from_descs(mat_descs, device=device),
        make_camera(cam_desc, buffer_size, device=device),
        device,
    )


def scene_from_arrays(vertices, tri_idx, materials: material_mod.Materials, tri_mat,
                      camera: CameraData, normals=None, env_map=None, *, device) -> Scene:
    """Build a Scene directly from numpy arrays (tests, procedural scenes);
    missing normals become area-weighted vertex normals."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32)
    tri_mat = np.asarray(tri_mat, np.int32)
    if normals is None:
        p0 = vertices[tri_idx[:, 0]]
        fn = np.cross(vertices[tri_idx[:, 1]] - p0, vertices[tri_idx[:, 2]] - p0)
        normals = np.zeros_like(vertices)
        for c in range(3):
            np.add.at(normals, tri_idx[:, c], fn)
        normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    normals = np.asarray(normals, np.float32)
    emission = materials.emission.cpu().numpy()
    em = np.nonzero(emission[tri_mat] > 0.0)[0].astype(np.int32)
    if em.size == 0:
        em = np.asarray([-1], np.int32)
    texcoords = np.zeros((len(vertices), 2), np.float32)
    return _scene(
        dict(
            vertices=vertices, normals=normals, texcoords=texcoords, tri_idx=tri_idx,
            tri_mat=tri_mat, tri_mesh=np.zeros((len(tri_idx),), np.int32),
            shade_blob=_shade_blob(vertices, normals, texcoords, tri_idx),
            mat_tex=np.full((materials.count,), -1, np.int32),
            textures=np.zeros((1, 1, 1, 3), np.float32), tex_hw=np.ones((1, 2), np.float32),
            env_map=env_map if env_map is not None else np.zeros((1, 1, 3), np.float32),
            emissive_tris=em,
        ),
        materials.to(device),
        camera.to(device),
        device,
    )
