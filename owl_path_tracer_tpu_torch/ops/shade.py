"""One non-NEE shading bounce in one CUDA kernel (``csrc/shade.cu``).

``render/integrator.py`` ``trace_bounce`` shades a bounce through
:func:`shade_bounce` for CUDA tensors while autograd records nothing: the
miss's environment, the surface (from fused2's attribute blob, else from
the shade blob at the winning triangle), the emission, the tangent frame,
``ops/disney.py``'s sample with only the selected lobe evaluated, the pdf
kill and the retry on a non-finite f, the throughput and the glass-exempt,
uncompensated Russian roulette, one thread per lane.  Its plain version is
``render/integrator.py`` ``_shade_bounce``, which the CPU takes, and so does
the card while autograd records (``render/diff.py``): the kernel has no
backward.  The kernel makes no host copy and no sync; it launches on the
current stream into outputs allocated here.

``LAUNCHES`` counts the kernel's launches (ENTRY) and the plain version's
calls on CUDA tensors (PLAIN_CUDA, the recording route), so that a run can
show how often the kernel engages; :func:`reset_counts` zeroes both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from ..native import build_cuda_library

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "shade.cu"
ENTRY = "owlpt_shade_bounce"
PLAIN_CUDA = "plain_cuda"

# kernel launches (ENTRY) and plain-version calls on CUDA tensors (PLAIN_CUDA)
LAUNCHES = {ENTRY: 0, PLAIN_CUDA: 0}

# the kernel's environment kinds (csrc/shade.cu Env)
ENV_MAP, ENV_AUTO, ENV_COLOR = 0, 1, 2

_cuda_lib = None


def reset_counts():
    """Set the launch and plain-call counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> tuple:
    """Build (if needed) and load the kernel library -> (path, seconds, log)."""
    global _cuda_lib
    path, seconds, log = build_cuda_library("owlpt_shade", [CSRC])
    if _cuda_lib is None:
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn = getattr(lib, ENTRY)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ptr] * 15 + [i32] + [ptr] * 3 + [i32] * 3 + [ptr] + [i32] * 2 + [f32] * 4 + [i32, i64, i64]
                       + [ptr] * 8 + [ptr])
        _cuda_lib = lib
    return path, seconds, log


def material_table(materials):
    """The [M,17] material table (``Materials.rows``), built once per
    Materials and rebuilt only when one of its tensors is replaced or
    written in place."""
    key = tuple((t.data_ptr(), t._version)
                for t in (getattr(materials, f.name) for f in dataclasses.fields(materials)))
    cached = getattr(materials, "_shade_table", None)
    if cached is None or cached[0] != key:
        cached = (key, materials.rows().contiguous())
        materials._shade_table = cached
    return cached[1]


def environment_kind(scene, settings) -> int:
    """The environment a miss sees (here and in render/integrator.py
    ``_environment_radiance``): the map, the auto sky or the colour."""
    if settings.environment_use and scene.env_map.shape[0] > 1:
        return ENV_MAP
    return ENV_AUTO if settings.environment_auto else ENV_COLOR


def _operand(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def shade_bounce(scene, settings, state, hit, blob, enable_textures: bool) -> dict:
    """Shade one bounce of ``state`` (a PathState) at ``hit`` (a HitRecord)
    with the surface from ``blob`` ([N,16] fused2 attributes) or, when it is
    None, from ``scene.shade_blob`` and ``scene.tri_mat`` -> the new state's
    fields but ``prev_pdf``: ray_o, ray_d, result, throughput, rng, alive,
    prev_lobe, depth.  CUDA tensors only (the kernel; no sync)."""
    dev = state.ray_o.device
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the shading kernel needs CUDA tensors on a CUDA device; got {dev}")
    n = state.ray_o.shape[0]
    f32, i64 = torch.float32, torch.int64
    v3 = (n, 3)
    ins = [_operand("ray_o", state.ray_o, v3, f32, dev), _operand("ray_d", state.ray_d, v3, f32, dev),
           _operand("result", state.result, v3, f32, dev), _operand("throughput", state.throughput, v3, f32, dev),
           _operand("rng", state.rng, (n,), i64, dev), _operand("alive", state.alive, (n,), torch.bool, dev),
           _operand("prev_lobe", state.prev_lobe, (n,), i64, dev), _operand("depth", state.depth, (n,), i64, dev),
           _operand("hit.t", hit.t, (n,), f32, dev), _operand("hit.tri", hit.tri, (n,), i64, dev),
           _operand("hit.uv", hit.uv, (n, 2), f32, dev)]
    blob = None if blob is None else _operand("blob", blob, (n, 16), f32, dev)
    t = scene.shade_blob.shape[0]
    shade_blob = _operand("shade_blob", scene.shade_blob, (t, 24), f32, dev)
    tri_mat = _operand("tri_mat", scene.tri_mat, (t,), torch.int32, dev)
    table = material_table(scene.materials)
    m = table.shape[0]
    _operand("materials", table, (m, 17), f32, dev)
    mat_tex = _operand("mat_tex", scene.mat_tex, (m,), torch.int32, dev)
    atlas = _operand("textures", scene.textures, tuple(scene.textures.shape), f32, dev)
    if atlas.dim() != 4 or atlas.shape[3] != 3:
        raise ValueError(f"textures: expected [K,TH,TW,3], got {tuple(atlas.shape)}")
    tex_hw = _operand("tex_hw", scene.tex_hw, (atlas.shape[0], 2), f32, dev)
    env_map = _operand("env_map", scene.env_map, tuple(scene.env_map.shape), f32, dev)
    if env_map.dim() != 3 or env_map.shape[2] != 3:
        raise ValueError(f"env_map: expected [EH,EW,3], got {tuple(env_map.shape)}")
    # three allocations for the eight outputs (each a contiguous view)
    vecs = torch.empty((4, n, 3), dtype=f32, device=dev).unbind(0)
    ints = torch.empty((3, n), dtype=i64, device=dev).unbind(0)
    out = dict(ray_o=vecs[0], ray_d=vecs[1], result=vecs[2], throughput=vecs[3], rng=ints[0],
               alive=torch.empty((n,), dtype=torch.bool, device=dev), prev_lobe=ints[1], depth=ints[2])
    if n == 0:
        return out
    if _cuda_lib is None:
        build_kernels()
    color = [float(c) for c in settings.environment_color]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_cuda_lib, ENTRY)(
            *(x.data_ptr() for x in ins), 0 if blob is None else blob.data_ptr(), shade_blob.data_ptr(),
            tri_mat.data_ptr(), table.data_ptr(), int(bool(enable_textures)), mat_tex.data_ptr(), atlas.data_ptr(),
            tex_hw.data_ptr(), atlas.shape[1], atlas.shape[2], environment_kind(scene, settings), env_map.data_ptr(),
            env_map.shape[0], env_map.shape[1], *color, float(settings.environment_intensity),
            int(not settings.parity), int(settings.rr_start_depth), n,
            *(out[k].data_ptr() for k in ("ray_o", "ray_d", "result", "throughput", "rng", "alive", "prev_lobe",
                                          "depth")), stream)
    if err != 0:
        raise RuntimeError(f"shading kernel {ENTRY} launch failed: CUDA error {err}")
    LAUNCHES[ENTRY] += 1
    return out
