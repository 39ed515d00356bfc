"""Differentiable rendering and material recovery (counterpart of
``owl_path_tracer_tpu/render/diff.py``).

The radiance estimate is differentiable with respect to the material table,
the environment-map texels and the camera basis, all substituted into the
scene: reverse-mode gradients flow through BSDF values, MIS weights,
emission and texture / environment lookups, while sampled directions, lobe
choices and Russian-roulette decisions are detached (``ops/disney.py``,
``render/integrator.py``).  The per-pixel LCG streams depend only on the
pixel coordinates, so a same-seed render is a deterministic function of the
parameters and its gradients can be checked against finite differences on
that fixed sample set.

Every accelerator works: the traversal kernels pick winners on detached
rays, and on a ``Fused2BVH`` the winner's t/u/v are derived again from the
live rays (``integrator.make_intersectors(..., differentiable=True)``), so
camera gradients flow through kernel K1b too.  ``accel=None`` is the brute
sweep, the exact oracle.

The ``*_and_grad`` functions return ``(loss, grads)`` with ``grads`` shaped
as the argument they differentiate (a ``Materials``, the environment tensor
or a ``CameraData``); like ``jax.value_and_grad`` they differentiate at the
values given and leave those tensors alone.  ``recover_materials`` runs
``torch.optim.Adam`` (eps 1e-8: the update of optax's ``adam``) on an image
loss.  With ``settings.use_nee`` the light table is built from the
substituted scene and is a constant of the render (its emission is not
differentiated).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.lights import build_light_table
from ..models.material import Materials
from ..models.scene import RenderSettings, Scene
from ..ops import rng as rng_mod
from . import integrator

# material fields that are physically constrained to [0,1]
_UNIT_FIELDS = (
    "subsurface", "metallic", "specular", "specular_tint", "roughness",
    "anisotropic", "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss",
    "specular_transmission", "specular_transmission_roughness",
)


def render_with_params(scene: Scene, materials: Materials, env_map, camera, settings: RenderSettings,
                       pixel_xy, num_samples: int, accel, enable_textures: bool = False):
    """Spp-averaged radiance [N,3] at ``pixel_xy`` [N,2], differentiable with
    respect to ``materials``, ``env_map`` and ``camera`` (substituted into
    the scene)."""
    scene = dataclasses.replace(scene, materials=materials, env_map=env_map, camera=camera)
    lights = build_light_table(scene) if settings.use_nee else None
    intersect_fn, occlude_fn = integrator.make_intersectors(scene, accel, differentiable=True)
    state0 = rng_mod.seed(pixel_xy[..., 0], pixel_xy[..., 1])
    acc, _, _ = integrator.sample_sum(scene, settings, pixel_xy, state0, num_samples, intersect_fn,
                                      enable_textures, lights=lights, occlude_fn=occlude_fn)
    return acc / float(num_samples)


def render_with_materials(scene: Scene, materials: Materials, settings: RenderSettings, pixel_xy,
                          num_samples: int, accel, enable_textures: bool = False):
    """:func:`render_with_params` differentiating with respect to materials only."""
    return render_with_params(scene, materials, scene.env_map, scene.camera, settings, pixel_xy, num_samples,
                              accel, enable_textures)


def image_loss(scene: Scene, materials: Materials, settings: RenderSettings, pixel_xy, target,
               num_samples: int, accel):
    """Mean squared error against ``target`` radiance at the given pixels."""
    img = render_with_materials(scene, materials, settings, pixel_xy, num_samples, accel)
    return torch.mean((img - target) ** 2)


def env_loss(scene: Scene, env_map, settings: RenderSettings, pixel_xy, target, num_samples: int, accel):
    """Mean squared error, differentiable with respect to the environment texels."""
    img = render_with_params(scene, scene.materials, env_map, scene.camera, settings, pixel_xy, num_samples,
                             accel)
    return torch.mean((img - target) ** 2)


def camera_loss(scene: Scene, camera, settings: RenderSettings, pixel_xy, target, num_samples: int, accel):
    """Mean squared error, differentiable with respect to the camera basis.
    Interior gradients only: silhouettes' boundary terms are out of scope."""
    img = render_with_params(scene, scene.materials, scene.env_map, camera, settings, pixel_xy, num_samples,
                             accel)
    return torch.mean((img - target) ** 2)


def _value_and_grad(loss_fn, arg):
    """(loss, d loss / d arg) at ``arg``, a tensor or a dataclass of tensors;
    a field the loss does not depend on gets a zero gradient."""
    fields = None if torch.is_tensor(arg) else [f.name for f in dataclasses.fields(arg)]
    if fields is None:
        leaves = [arg.detach().requires_grad_(True)]
        point = leaves[0]
    else:
        leaves = [getattr(arg, name).detach().requires_grad_(True) for name in fields]
        point = dataclasses.replace(arg, **dict(zip(fields, leaves)))
    with torch.enable_grad():
        loss = loss_fn(point)
        grads = [None] * len(leaves)
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    if fields is None:
        return loss.detach(), grads[0]
    return loss.detach(), dataclasses.replace(arg, **dict(zip(fields, grads)))


def loss_and_grad(scene: Scene, materials: Materials, settings: RenderSettings, pixel_xy, target,
                  num_samples: int, accel):
    """(image_loss, its gradient as a Materials)."""
    return _value_and_grad(
        lambda mats: image_loss(scene, mats, settings, pixel_xy, target, num_samples, accel), materials)


def env_loss_and_grad(scene: Scene, env_map, settings: RenderSettings, pixel_xy, target, num_samples: int,
                      accel):
    """(env_loss, its gradient as an environment tensor)."""
    return _value_and_grad(
        lambda env: env_loss(scene, env, settings, pixel_xy, target, num_samples, accel), env_map)


def camera_loss_and_grad(scene: Scene, camera, settings: RenderSettings, pixel_xy, target, num_samples: int,
                         accel):
    """(camera_loss, its gradient as a CameraData)."""
    return _value_and_grad(
        lambda cam: camera_loss(scene, cam, settings, pixel_xy, target, num_samples, accel), camera)


@dataclasses.dataclass
class RecoveryResult:
    materials: Materials
    losses: np.ndarray  # [steps] the loss before each step


def _project(name: str, v):
    """Clamp a material field to its physical range, in place."""
    if name == "base_color" or name in _UNIT_FIELDS:
        v.clamp_(0.0, 1.0)
    elif name == "ior":
        v.clamp_(1.01, 3.0)
    elif name == "emission":
        v.clamp_(min=0.0)


def recover_materials(scene: Scene, settings: RenderSettings, target, pixel_xy, init_materials: Materials,
                      steps: int = 100, lr: float = 0.05, num_samples: int = 8, accel=None,
                      trainable: Optional[Sequence[str]] = None,
                      grad_mask: Optional[Materials] = None) -> RecoveryResult:
    """Adam loop recovering material parameters from a rendered target.

    ``trainable`` restricts the optimisation to a subset of fields (default
    base_color, roughness, metallic and emission): the others' gradients are
    zeroed.  ``grad_mask`` (a Materials of 0/1) multiplies the gradients, to
    restrict the updates to chosen rows (one material of several: Adam's
    unit-scale steps otherwise move every row on gradient noise).  After
    each step every field is clamped to its physical range.
    """
    trainable = tuple(trainable or ("base_color", "roughness", "metallic", "emission"))
    names = [f.name for f in dataclasses.fields(Materials)]
    params = {name: getattr(init_materials, name).detach().clone().requires_grad_(True) for name in names}
    opt = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8)
    losses = []
    for _ in range(steps):
        loss, grads = loss_and_grad(scene, Materials(**params), settings, pixel_xy, target, num_samples, accel)
        for name in names:
            g = getattr(grads, name) if name in trainable else torch.zeros_like(params[name])
            params[name].grad = g if grad_mask is None else g * getattr(grad_mask, name)
        opt.step()
        with torch.no_grad():
            for name in names:
                _project(name, params[name])
        losses.append(float(loss))
    return RecoveryResult(materials=Materials(**{k: v.detach() for k, v in params.items()}),
                          losses=np.asarray(losses, np.float32))
