"""Debug-mode validation (counterpart of ``owl_path_tracer_tpu/ops/debug.py``):
the reference's device asserts (bounds-checked buffer access, NaN/inf
payload guards) as eager checks.

* ``checked_gather``: ``table[idx]`` with the indices audited in debug mode
  (an out-of-range index raises) and clamped in release mode;
* ``assert_finite`` / ``assert_unit``: raise in debug mode, return their
  argument untouched (and read nothing) otherwise;
* ``validate_scene``: the host-side structural audit, with the JAX
  package's problem strings.

Debug mode is on with ``OWLPT_DEBUG=1`` in the environment when the module
is imported, or ``set_debug(True)``.  The JAX package's checks are
``checkify`` assertions, which PyTorch does not have: here each check reads
its tensor on the host when it runs (a device sync on the card), which
happens only in debug mode; in release mode the checks cost nothing.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_DEBUG = os.environ.get("OWLPT_DEBUG", "0") == "1"


class DebugCheckError(RuntimeError):
    """A debug-mode check failed."""


def set_debug(on: bool):
    global _DEBUG
    _DEBUG = bool(on)


def debug_enabled() -> bool:
    return _DEBUG


def _check(cond, msg: str):
    if not bool(cond):
        raise DebugCheckError(msg)


def checked_gather(table, idx, name: str = "buffer"):
    """Bounds-audited ``table[idx]`` along the first axis: in debug mode an
    index outside [0, len(table)) raises; in release mode it is clamped."""
    n = table.shape[0]
    if _DEBUG:
        _check(((idx >= 0) & (idx < n)).all(), f"index out of bounds in {name} (size {n})")
    return table[torch.clamp(idx, 0, n - 1)]


def assert_finite(x, name: str = "value"):
    if _DEBUG:
        _check(torch.isfinite(x).all(), f"non-finite {name}")
    return x


def assert_unit(v, name: str = "direction", atol: float = 1e-3):
    if _DEBUG:
        n2 = (v * v).sum(-1)
        _check(((n2 - 1.0).abs() < atol).all(), f"{name} not normalized")
    return v


def checked_call(fn, *args):
    """``fn(*args)``, raising DebugCheckError at the first failed check (the
    checks are eager, so they raise where they run)."""
    return fn(*args)


def validate_scene(scene) -> list:
    """Host-side scene audit -> problem strings (empty: none), the JAX
    package's strings for the same scene."""
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    problems = []
    tri = host(scene.tri_idx)
    nv = len(scene.vertices)
    if tri.min() < 0 or tri.max() >= nv:
        problems.append(f"tri_idx out of range [0,{nv}): [{tri.min()},{tri.max()}]")
    tm = host(scene.tri_mat)
    nm = scene.materials.count
    if tm.min() < 0 or tm.max() >= nm:
        problems.append(f"tri_mat out of range [0,{nm})")
    lens = np.linalg.norm(host(scene.normals), axis=-1)
    frac_bad = float((np.abs(lens - 1) > 1e-2).mean())
    if frac_bad > 0.01:
        problems.append(f"{frac_bad:.1%} of normals not unit length")
    for field in ("roughness", "metallic", "specular_transmission"):
        v = host(getattr(scene.materials, field))
        if (v < 0).any() or (v > 1).any():
            problems.append(f"material {field} outside [0,1]")
    if (host(scene.materials.ior) < 1.0).any():
        problems.append("material ior < 1")
    if not np.isfinite(host(scene.env_map)).all():
        problems.append("non-finite environment map")
    return problems
