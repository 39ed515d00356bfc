"""The PyTorch port stands alone: no JAX, no JAX package, no CPU fallback
for CUDA work."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from owl_path_tracer_tpu_torch import native
from owl_path_tracer_tpu_torch.ops import fused as tfu
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.ops import latency_probe as tlp
from owl_path_tracer_tpu_torch.ops import shade

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import owl_path_tracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "owl_path_tracer_tpu"))
assert not bad, bad
assert "jax" not in sys.modules and "owl_path_tracer_tpu" not in sys.modules
print(len(names))
print(*names, file=sys.stderr)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 46  # every sub-package and module was walked
    # the gradient path's modules, and the later slices', among them
    for name in ("render.diff", "render.metrics", "ops.bvh", "ops.traverse", "ops.debug", "parallel",
                 "parallel.shard", "tools.render_gallery", "tools.measure_balance", "tools.bench_scaling",
                 "tools.bench", "tools.comm_model"):
        assert f"owl_path_tracer_tpu_torch.{name}" in proc.stderr.split()


def test_native_sources_lie_inside_the_port(monkeypatch):
    """Every source the port hands to g++ or nvcc, and every header a build
    depends on, is a file of the port's own package: nothing is compiled
    from the JAX package."""
    seen = []

    class Stop(Exception):
        pass

    def record(cmd_head, sources, out, flags, depends=()):
        seen.extend(pathlib.Path(s).resolve() for s in [*sources, *depends])
        raise Stop

    monkeypatch.setattr(native, "_compile", record)
    monkeypatch.setattr(native, "_bvh_lib", None)
    with pytest.raises(Stop):
        native._load_bvh()  # g++: the SAH builder
    with pytest.raises(Stop):
        tf2.build_kernels()  # nvcc: the fused2 traversal kernels
    with pytest.raises(Stop):
        tfu.build_kernels()  # nvcc: the fused traversal kernel
    with pytest.raises(Stop):
        tlp.build_kernels()  # nvcc: the latency probe kernel
    with pytest.raises(Stop):
        shade.build_kernels()  # nvcc: the shading kernel
    port = pathlib.Path(native.PKG_DIR).resolve()
    assert len(seen) >= 5 and tlp.CSRC.resolve() in seen and shade.CSRC.resolve() in seen and tf2.TENSOR_OPS.resolve() in seen
    for src in seen:
        assert port in src.parents and src.is_file(), src


def _tiny_accel(device):
    k, c = 128, 64
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    cluster = tf2.ClusterBVH(cmin=z(k, 3), cmax=z(k, 3), tri_planes=z(k, 9, c),
                             tri_id=torch.zeros((k, c), dtype=torch.int32, device=device))
    return tf2.Fused2BVH(boxes=z(8, k), planes=z(k, 16, c), attrs=z(k, 32, c),
                         attr_table=z(1, 32), bounds=z(2, 3), cluster=cluster)


def test_cuda_dispatch_raises_instead_of_falling_back(monkeypatch):
    """A non-CPU traversal request goes to the kernel path, which raises when
    there is no CUDA device; the plain version is never called for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tf2, "fused2_traverse_packed_plain", no_fallback)
    launches = dict(tf2.LAUNCHES)
    rays = torch.zeros((128, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf2.fused2_traverse_packed(rays, _tiny_accel("meta"), block=128)
    # the kernel path itself refuses CPU tensors too
    with pytest.raises(RuntimeError, match="CUDA"):
        tf2._fused2_traverse_cuda(torch.zeros((128, 8)), _tiny_accel("cpu"), 128, 8)
    assert tf2.LAUNCHES == launches


def test_cpu_tensors_take_the_plain_version():
    rays = torch.zeros((128, 8))
    rays[:, 5] = 1.0
    out = tf2.fused2_traverse_packed(rays, _tiny_accel("cpu"), block=128)
    assert out.shape == (128, 32)
    assert (out[:, 5] == 1.0).all() and (out[:, 3] == -1.0).all()
