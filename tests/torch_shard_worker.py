"""Rank functions for the port's multi-process sharding tests
(tests/test_torch_sharding.py), run by ``parallel.shard.spawn_ranks`` in
processes that import the port only (no JAX)."""
import numpy as np
import torch

from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import rng as rng_mod
from owl_path_tracer_tpu_torch.parallel import shard
from owl_path_tracer_tpu_torch.utils.parser import CameraDesc

SIZE = 16
SETTINGS = tscene.RenderSettings(width=SIZE, height=SIZE, max_samples=4, max_path_depth=3,
                                 environment_color=(1.0, 0.9, 0.8), environment_intensity=1.0)


def small_scene(sphere, device="cpu"):
    """tests/test_sharding.py::small_scene in the port, from the arrays of
    tests/test_integrator.py::make_sphere_mesh (which imports JAX, so the
    parent passes them)."""
    v, idx, n = sphere
    cam = tcam.make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (SIZE, SIZE), device=device)
    mat = tmat.single(device=device, base_color=(0.7, 0.5, 0.3), roughness=0.8)
    return tscene.scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n, device=device)


def local_pixels(mesh, pixels):
    """This rank's contiguous share of an [N,2] pixel list (N a multiple of the world size)."""
    per = len(pixels) // mesh.size
    return torch.as_tensor(pixels[mesh.rank * per : (mesh.rank + 1) * per])


def run_all(mesh, sphere, grad_pixels, settings=SETTINGS):
    """Every sharded entry point on the small scene -> numpy results."""
    sc = small_scene(sphere)
    out = {"rank": mesh.rank, "size": mesh.size, "scan": shard.render_image_sharded(sc, settings, mesh=mesh).numpy()}
    for split in ("sample", "contiguous"):
        img, rays, stats = shard.render_image_wavefront_sharded(sc, settings, mesh=mesh, lanes_per_chip=256,
                                                                iters_per_launch=4, work_split=split,
                                                                return_stats=True)
        out[split] = (img.numpy(), rays, stats)
    px = local_pixels(mesh, grad_pixels)
    fn = shard.sharded_loss_and_grad(mesh, sc, settings, None, 4)
    loss, grads = fn(sc.materials, px, rng_mod.seed(px[:, 0], px[:, 1]), torch.zeros((len(px), 3)))
    out["loss"] = float(loss)
    out["grads"] = {k: v.numpy() for k, v in vars(grads).items()}
    return out
