"""A shading bounce in one CUDA kernel (``csrc/shade.cu``).

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

``trace_bounce_nee`` shades a deferred next-event-estimation bounce with
area lights and no environment light through :func:`shade_bounce_nee` on
the same terms: the MIS-weighted emission, the light sample, ``eval_all``
towards it and the pending shadow ray, the BSDF sample with its mixture
pdf and the compensated Russian roulette.  Its plain version is
``_shade_bounce_nee``, which also takes the immediate form and the
environment light.

``LAUNCHES`` counts each kernel's launches (ENTRY, ENTRY_NEE) and each plain
version's calls on CUDA tensors (PLAIN_CUDA, PLAIN_CUDA_NEE), so that a run
can show how often the kernels engage; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from ..native import build_cuda_library

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "shade.cu"
ENTRY = "owlpt_shade_bounce"
ENTRY_NEE = "owlpt_shade_bounce_nee"
PLAIN_CUDA = "plain_cuda"
PLAIN_CUDA_NEE = "plain_cuda_nee"

# kernel launches (ENTRY, ENTRY_NEE) and plain-version calls on CUDA tensors
# (PLAIN_CUDA, PLAIN_CUDA_NEE)
LAUNCHES = {ENTRY: 0, PLAIN_CUDA: 0, ENTRY_NEE: 0, PLAIN_CUDA_NEE: 0}

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
        fn = getattr(lib, ENTRY_NEE)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ptr] * 16 + [i32] + [ptr] * 3 + [i32] * 3 + [ptr] + [i32] * 2 + [f32] * 4 + [ptr] * 9
                       + [i64, ptr, i32, i32, i64, i64] + [ptr] * 14 + [ptr])
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


def _scene_operands(scene, settings, blob, enable_textures: bool, n: int, dev) -> tuple:
    """The scene's arguments of both entries, from ``blob`` to the
    environment's intensity, checked -> (arguments, the checked tensors,
    which the caller holds until the launch)."""
    f32 = torch.float32
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
    return [0 if blob is None else blob.data_ptr(), shade_blob.data_ptr(), tri_mat.data_ptr(), table.data_ptr(),
            int(bool(enable_textures)), mat_tex.data_ptr(), atlas.data_ptr(), tex_hw.data_ptr(), atlas.shape[1],
            atlas.shape[2], environment_kind(scene, settings), env_map.data_ptr(), env_map.shape[0],
            env_map.shape[1], *(float(c) for c in settings.environment_color),
            float(settings.environment_intensity)], (blob, shade_blob, tri_mat, table, mat_tex, atlas, tex_hw, env_map)


def _state_operands(state, hit, dev, prev_pdf: bool) -> list:
    n = state.ray_o.shape[0]
    f32, i64 = torch.float32, torch.int64
    v3 = (n, 3)
    return [_operand("ray_o", state.ray_o, v3, f32, dev), _operand("ray_d", state.ray_d, v3, f32, dev),
            _operand("result", state.result, v3, f32, dev), _operand("throughput", state.throughput, v3, f32, dev),
            _operand("rng", state.rng, (n,), i64, dev), _operand("alive", state.alive, (n,), torch.bool, dev),
            _operand("prev_lobe", state.prev_lobe, (n,), i64, dev), _operand("depth", state.depth, (n,), i64, dev),
            *([_operand("prev_pdf", state.prev_pdf, (n,), f32, dev)] if prev_pdf else []),
            _operand("hit.t", hit.t, (n,), f32, dev), _operand("hit.tri", hit.tri, (n,), i64, dev),
            _operand("hit.uv", hit.uv, (n, 2), f32, dev)]


def _cuda_device(state, what: str):
    dev = state.ray_o.device
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the {what} needs CUDA tensors on a CUDA device; got {dev}")
    return dev


def _launch(entry: str, dev, args: list):
    if _cuda_lib is None:
        build_kernels()
    with torch.cuda.device(dev):
        err = getattr(_cuda_lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"shading kernel {entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def shade_bounce(scene, settings, state, hit, blob, enable_textures: bool) -> dict:
    """Shade one bounce of ``state`` (a PathState) at ``hit`` (a HitRecord)
    with the surface from ``blob`` ([N,16] fused2 attributes) or, when it is
    None, from ``scene.shade_blob`` and ``scene.tri_mat`` -> the new state's
    fields but ``prev_pdf``: ray_o, ray_d, result, throughput, rng, alive,
    prev_lobe, depth.  CUDA tensors only (the kernel; no sync)."""
    dev = _cuda_device(state, "shading kernel")
    n = state.ray_o.shape[0]
    ins = _state_operands(state, hit, dev, prev_pdf=False)
    scene_args, held = _scene_operands(scene, settings, blob, enable_textures, n, dev)
    # three allocations for the eight outputs (each a contiguous view)
    vecs = torch.empty((4, n, 3), dtype=torch.float32, device=dev).unbind(0)
    ints = torch.empty((3, n), dtype=torch.int64, device=dev).unbind(0)
    out = dict(ray_o=vecs[0], ray_d=vecs[1], result=vecs[2], throughput=vecs[3], rng=ints[0],
               alive=torch.empty((n,), dtype=torch.bool, device=dev), prev_lobe=ints[1], depth=ints[2])
    if n == 0:
        return out
    _launch(ENTRY, dev, [*(x.data_ptr() for x in ins), *scene_args, int(not settings.parity),
                         int(settings.rr_start_depth), n,
                         *(out[k].data_ptr() for k in ("ray_o", "ray_d", "result", "throughput", "rng", "alive",
                                                       "prev_lobe", "depth"))])
    return out


# the light table's fields in the NEE entry's order, each [L,3] or [L]
_LIGHT_FIELDS = (("p0", 3), ("p1", 3), ("p2", 3), ("n0", 3), ("n1", 3), ("n2", 3), ("emission", 0), ("area", 0))


def shade_bounce_nee(scene, settings, lights, state, hit, blob, enable_textures: bool, allow_nee=True):
    """Shade one deferred next-event-estimation bounce of ``state`` at
    ``hit``, with the area lights of ``lights`` (a LightTable) and no
    environment light; ``allow_nee`` (bool or [N] bool) switches the light
    sample's contribution off -> (the new state's fields: ray_o, ray_d,
    result, throughput, rng, alive, prev_lobe, depth, prev_pdf; the pending
    shadow ray: origin, direction, distance, contribution, active), as
    ``render/integrator.py`` ``_shade_bounce_nee(..., deferred=True)``
    returns them.  CUDA tensors only (the kernel; no sync)."""
    dev = _cuda_device(state, "NEE shading kernel")
    n = state.ray_o.shape[0]
    f32 = torch.float32
    ins = _state_operands(state, hit, dev, prev_pdf=True)
    scene_args, held = _scene_operands(scene, settings, blob, enable_textures, n, dev)
    count = lights.count
    if count == 0:
        raise ValueError("the NEE shading kernel needs at least one light")
    light = [_operand(f"lights.{k}", getattr(lights, k), (count, 3) if w else (count,), f32, dev)
             for k, w in _LIGHT_FIELDS]
    light.append(_operand("lights.tri_id", lights.tri_id, (count,), torch.int32, dev))
    if isinstance(allow_nee, torch.Tensor):
        allow = _operand("allow_nee", allow_nee, (n,), torch.bool, dev)
        allow_args = [allow.data_ptr(), 0]
    else:
        allow_args = [0, int(bool(allow_nee))]
    # four allocations for the fourteen outputs (each a contiguous view)
    vecs = torch.empty((7, n, 3), dtype=f32, device=dev).unbind(0)
    flts = torch.empty((2, n), dtype=f32, device=dev).unbind(0)
    ints = torch.empty((3, n), dtype=torch.int64, device=dev).unbind(0)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev).unbind(0)
    out = dict(ray_o=vecs[0], ray_d=vecs[1], result=vecs[2], throughput=vecs[3], rng=ints[0], alive=flags[0],
               prev_lobe=ints[1], depth=ints[2], prev_pdf=flts[0])
    pending = (vecs[4], vecs[5], flts[1], vecs[6], flags[1])
    if n == 0:
        return out, pending
    _launch(ENTRY_NEE, dev, [*(x.data_ptr() for x in ins), *scene_args, *(x.data_ptr() for x in light), count,
                             *allow_args, int(not settings.parity), int(settings.rr_start_depth), n,
                             *(out[k].data_ptr() for k in ("ray_o", "ray_d", "result", "throughput", "rng", "alive",
                                                           "prev_lobe", "depth", "prev_pdf")),
                             *(x.data_ptr() for x in pending)])
    return out, pending

