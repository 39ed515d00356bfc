"""Native builds: the SAH BVH builder (g++) and the CUDA kernels (nvcc).

Both are compiled at first use into the package's ``build/`` directory and
bound through ctypes with a plain C interface.

* ``bvh.cpp`` (this directory) is a byte-for-byte copy of the JAX package's
  ``owl_path_tracer_tpu/native/bvh.cpp``, compiled with the flags of that
  package's Makefile, so on one machine both packages build the same SAH tree
  and the same clusters -- what the winner-exact tests rely on.  A failed
  build raises: there is no fallback builder, because a different tree would
  break the comparison silently.
* CUDA sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a``
  (:func:`build_cuda_library`); that happens only where a kernel launches.
  A library is rebuilt when a source or a header it includes
  (``depends``, e.g. ``csrc/tensor_ops.cuh``) is newer than it.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "build"
BVH_SOURCE = PKG_DIR / "native" / "bvh.cpp"
# the JAX package's native/Makefile CXXFLAGS (plus -shared)
BVH_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_bvh_lib = None


class BuildError(RuntimeError):
    pass


class FlatBVH(NamedTuple):
    """Flattened BVH as the native builder returns it (ops/bvh.py FlatBVH)."""

    node_min: np.ndarray  # [NN,3] f32
    node_max: np.ndarray  # [NN,3] f32
    node_a: np.ndarray  # [NN] i32
    node_b: np.ndarray  # [NN] i32 (negative count => leaf)
    tri_order: np.ndarray  # [T] i32


def _compile(cmd_head, sources, out: pathlib.Path, flags, depends=()) -> str:
    """Compile ``sources`` into ``out`` unless it is newer than every source
    and every file in ``depends`` (headers the sources include).

    Writes to a per-process temporary name and renames, so concurrent test
    workers never load a half-written library.  Returns the compiler log.
    """
    inputs = [*sources, *depends]
    if out.exists() and all(out.stat().st_mtime >= pathlib.Path(s).stat().st_mtime for s in inputs):
        return ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*cmd_head, *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise BuildError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _load_bvh():
    global _bvh_lib
    if _bvh_lib is not None:
        return _bvh_lib
    out = BUILD_DIR / "libowlpt_native.so"
    _compile([os.environ.get("CXX", "g++")], [BVH_SOURCE], out, BVH_FLAGS)
    lib = ctypes.CDLL(str(out))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.owlpt_build_bvh.restype = ctypes.c_int64
    lib.owlpt_build_bvh.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p,
    ]
    lib.owlpt_extract_clusters.restype = ctypes.c_int64
    lib.owlpt_extract_clusters.argtypes = [
        f32p, i32p, ctypes.c_int64, f32p, f32p, i32p, i32p, ctypes.c_int64,
        i32p, ctypes.c_int32, f32p, f32p, f32p, i32p,
    ]
    _bvh_lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_build_bvh(vertices: np.ndarray, tri_idx: np.ndarray, max_leaf: int = 4) -> FlatBVH:
    """C++ binned-SAH build."""
    lib = _load_bvh()
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(tri_idx, np.int32)
    n_tris = len(t)
    cap = 2 * n_tris
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    na = np.empty(cap, np.int32)
    nb = np.empty(cap, np.int32)
    order = np.empty(n_tris, np.int32)
    n_nodes = lib.owlpt_build_bvh(
        _fptr(v), len(v), _iptr(t), n_tris, max_leaf,
        _fptr(nmin), _fptr(nmax), _iptr(na), _iptr(nb), _iptr(order),
    )
    if n_nodes < 0:
        raise BuildError("owlpt_build_bvh failed")
    return FlatBVH(
        node_min=nmin[:n_nodes].copy(),
        node_max=nmax[:n_nodes].copy(),
        node_a=na[:n_nodes].copy(),
        node_b=nb[:n_nodes].copy(),
        tri_order=order,
    )


def native_extract_clusters(vertices, tri_idx, bvh: FlatBVH, cluster_size: int):
    """C++ leaf -> cluster extraction: (cmin, cmax, blob [k,9C], tid [k,C])."""
    lib = _load_bvh()
    v = np.ascontiguousarray(vertices, np.float32)
    t = np.ascontiguousarray(tri_idx, np.int32)
    nmin = np.ascontiguousarray(bvh.node_min, np.float32)
    nmax = np.ascontiguousarray(bvh.node_max, np.float32)
    na = np.ascontiguousarray(bvh.node_a, np.int32)
    nb = np.ascontiguousarray(bvh.node_b, np.int32)
    order = np.ascontiguousarray(bvh.tri_order, np.int32)
    k_max = int((nb < 0).sum())
    c = cluster_size
    cmin = np.empty((k_max, 3), np.float32)
    cmax = np.empty((k_max, 3), np.float32)
    blob = np.empty((k_max, 9 * c), np.float32)
    tid = np.empty((k_max, c), np.int32)
    k = lib.owlpt_extract_clusters(
        _fptr(v), _iptr(t), len(t), _fptr(nmin), _fptr(nmax), _iptr(na),
        _iptr(nb), len(na), _iptr(order), c, _fptr(cmin), _fptr(cmax),
        _fptr(blob), _iptr(tid),
    )
    if k < 0:
        raise BuildError("owlpt_extract_clusters failed")
    return cmin[:k], cmax[:k], blob[:k], tid[:k]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "nvcc")


def bind_resources(lib, entry: str, extra: int = 0):
    """Declare ``lib``'s ``<entry>_resources(k, c, block, [extra ints,] int
    out[3])``, the query every kernel source exports next to its entry."""
    fn = getattr(lib, f"{entry}_resources")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * (3 + extra) + [ctypes.POINTER(ctypes.c_int)]


def kernel_resources(lib, entry: str, k: int, c: int, block: int, *extra: int) -> dict:
    """Registers per thread, dynamic shared bytes per block and resident
    blocks per SM of ``entry`` at K clusters of C slots and ``block`` rays
    (and the entry's ``extra`` arguments) on the current CUDA device, as the
    kernel source counts and the CUDA runtime reports them."""
    out = (ctypes.c_int * 3)()
    err = getattr(lib, f"{entry}_resources")(k, c, block, *extra, out)
    if err != 0:
        raise RuntimeError(f"kernel {entry}: resource query failed: CUDA error {err}")
    return {"entry": entry, "registers": out[0], "shared_bytes": out[1], "blocks_per_sm": out[2]}


def build_cuda_library(name: str, sources, depends=()) -> tuple:
    """nvcc ``sources`` (paths under csrc/) into ``build/lib{name}.so``,
    again whenever a source or a header in ``depends`` is newer than it.

    Returns (path, seconds, compiler log); the log carries ``-Xptxas -v``'s
    register and shared-memory report when the library was (re)built.
    """
    out = BUILD_DIR / f"lib{name}.so"
    t0 = time.perf_counter()
    log = _compile([nvcc_path()], [pathlib.Path(s) for s in sources], out, NVCC_FLAGS, depends)
    return out, time.perf_counter() - t0, log
