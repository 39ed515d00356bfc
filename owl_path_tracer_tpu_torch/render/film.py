"""Accelerator set-up for rendering (counterpart of ``owl_path_tracer_tpu/render/film.py``:
``make_accel`` and ``scene_has_textures``; the scan renderer and its film
come later, ROADMAP queue 1)."""
from __future__ import annotations

import torch

from ..models.scene import Scene
from ..ops.fused2 import Fused2BVH, auto_sort_mode, build_fused2_scene


def make_accel(scene: Scene, kind: str = "fused2", cluster_size: int | None = None,
               plane_dtype=None) -> Fused2BVH:
    """Build the acceleration structure on the scene's device.

    ``fused2`` is the MXU feature layout with float32 planes (``plane_dtype``
    may ask for bfloat16), ``fused2-bf16`` the same with bfloat16 planes, as
    in the JAX package.  Without a ``cluster_size`` C adapts to the scene:
    512 for enclosed scenes (the cid2 sort), and for open scenes halved from
    512 (down to 128) while the scene would have fewer than 64 clusters.
    """
    if kind not in ("fused2", "fused2-bf16"):
        raise NotImplementedError(f"accelerator {kind!r} is not ported yet: ROADMAP queue 1")
    if kind == "fused2-bf16":
        plane_dtype = torch.bfloat16
    if cluster_size is None:
        cluster_size = 512
        if auto_sort_mode(scene) != "cid2":
            n_tris = int(scene.tri_idx.shape[0])
            while cluster_size > 128 and n_tris // cluster_size < 64:
                cluster_size //= 2
    return build_fused2_scene(scene, cluster_size=cluster_size, plane_dtype=plane_dtype or torch.float32)


def scene_has_textures(scene: Scene) -> bool:
    return bool((scene.mat_tex >= 0).any())
