"""Port ``ops/fused.py`` (kernel K5's plain version and wrappers) vs the JAX
package's ``ops/fused.py`` with its Pallas kernel in interpret mode, on the
3000-triangle soup of tests/test_fused2.py at C=64.

Tolerances: tri, hit, resolved and steps exact (the plain version runs the
kernel's block algorithm: same entries, same picks, same retirements); t to
rtol 5e-6 / atol 1e-7 and u, v to rtol 5e-6 / atol 1e-6, as in
tests/test_fused2.py::test_matches_cluster_exact (XLA may contract the
Moller-Trumbore sums into FMAs, the port never does).  Column 7 is left
unwritten by the Pallas kernel and is not compared.  The CUDA kernel itself is
held against the plain version on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.ops import cluster as jcl
from owl_path_tracer_tpu.ops import fused as jfu
from owl_path_tracer_tpu_torch import native
from owl_path_tracer_tpu_torch.convert import fused_from_numpy
from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import fused as tfu
from owl_path_tracer_tpu_torch.ops import math as tm
from test_fused2 import _soup
from test_torch_scene import as_numpy, assert_same_arrays

torch.set_num_threads(2)

N = 200  # not a multiple of either block: padding rays in every case


@pytest.fixture(scope="module")
def setup():
    verts, idx, r = _soup()
    jfb = jfu.build_fused(jcl.build_clusters(verts, idx, cluster_size=64))
    tfb = tfu.build_fused(tcl.build_clusters(verts, idx, cluster_size=64, device="cpu"))
    o = r.uniform(-6, 6, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(N) < 0.5, r.uniform(1.0, 8.0, N), 1e10).astype(np.float32)
    return jfb, tfb, o, d, tmax


def _padded(o, d, tmax, block, scalar):
    """The rays as fused_closest_hit pads them: origin 0, direction +z; a
    per-ray t_max pads with T_MIN, a scalar one is kept."""
    pad = (-len(o)) % block
    o_p = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d_p = np.concatenate([d, np.tile(np.float32([0, 0, 1]), (pad, 1))])
    t_p = 1e10 if scalar else np.concatenate([tmax, np.full(pad, tm.T_MIN, np.float32)])
    return o_p, d_p, t_p


def _jax_raw(jfb, o, d, t, block, max_steps=jfu.MAX_STEPS):
    t = jnp.asarray(t, jnp.float32)
    return np.asarray(jfu.fused_traverse(jnp.asarray(o), jnp.asarray(d), t, jfb, interpret=True,
                                         block=block, max_steps=max_steps))


def _port_raw(tfb, o, d, t, block, max_steps=tfu.MAX_STEPS):
    t = torch.as_tensor(t, dtype=torch.float32)
    return tfu.fused_traverse(torch.as_tensor(o), torch.as_tensor(d), t, tfb, block, max_steps).numpy()


def _assert_raw_match(got, want):
    for col, name in ((3, "tri"), (4, "hit"), (5, "resolved"), (6, "steps")):
        np.testing.assert_array_equal(got[:, col], want[:, col], err_msg=name)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=5e-6, atol=1e-7, err_msg="t")
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=5e-6, atol=1e-6, err_msg="uv")
    assert (got[:, 7] == 0).all()


def test_build_fused_matches_jax(setup):
    """Boxes, planes and clusters bit-equal to the JAX package's, built by the
    port and carried across by ``convert.fused_from_numpy``."""
    jfb, tfb, *_ = setup
    assert_same_arrays(tfb, as_numpy(jfb))
    assert_same_arrays(fused_from_numpy(as_numpy(jfb), device="cpu"), as_numpy(jfb))
    assert tfb.num_clusters == jfb.num_clusters and tfb.cluster_size == 64


@pytest.mark.parametrize("scalar", [False, True], ids=["per_ray_tmax", "scalar_tmax"])
@pytest.mark.parametrize("block", [128, 256])
def test_plain_matches_jax_kernel(setup, block, scalar):
    jfb, tfb, o, d, tmax = setup
    o_p, d_p, t_p = _padded(o, d, tmax, block, scalar)
    want = _jax_raw(jfb, o_p, d_p, t_p, block)
    got = _port_raw(tfb, o_p, d_p, t_p, block)
    _assert_raw_match(got, want)
    assert (got[:, 5] == 1).all() and 0 < got[:N, 4].sum() < N
    steps = got[:, 6].reshape(-1, block)
    assert (steps == steps[:, :1]).all() and steps.min() > 1  # one count per block
    if not scalar:
        assert (got[N:, 4] == 0).all()  # padding rays with t_max = T_MIN never hit


def test_plain_unresolved_matches_jax_kernel(setup):
    """A small max_steps leaves rows unresolved; per ray, exactly as in JAX."""
    jfb, tfb, o, d, tmax = setup
    o_p, d_p, t_p = _padded(o, d, tmax, 128, False)
    want = _jax_raw(jfb, o_p, d_p, t_p, 128, max_steps=3)
    got = _port_raw(tfb, o_p, d_p, t_p, 128, max_steps=3)
    _assert_raw_match(got, want)
    assert (got[:, 5] == 0).any() and (got[:, 5] == 1).any()
    assert (got[:, 6] == 3).all()


@pytest.mark.parametrize("max_steps", [tfu.MAX_STEPS, 3], ids=["resolved", "fallback"])
@pytest.mark.parametrize("scalar", [False, True], ids=["per_ray_tmax", "scalar_tmax"])
def test_closest_hit_and_occlusion_match_jax(setup, scalar, max_steps):
    """fused_closest_hit (with the exact cluster query for unresolved rows)
    and fused_occluded equal the JAX package's."""
    jfb, tfb, o, d, tmax = setup
    t = 1e10 if scalar else tmax
    rec = jfu.fused_closest_hit(jnp.asarray(o), jnp.asarray(d), jfb, t_max=jnp.asarray(t, jnp.float32),
                                interpret=True, max_steps=max_steps)
    unresolved = tfu.UNRESOLVED_RAYS
    got = tfu.fused_closest_hit(torch.as_tensor(o), torch.as_tensor(d), tfb,
                                t_max=torch.as_tensor(t, dtype=torch.float32), max_steps=max_steps)
    assert (tfu.UNRESOLVED_RAYS > unresolved) == (max_steps == 3)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(rec.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(rec.t), rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(rec.uv), rtol=5e-6, atol=1e-6)
    assert 0 < int(got.hit.sum()) < N
    if max_steps == tfu.MAX_STEPS:
        occ = tfu.fused_occluded(torch.as_tensor(o), torch.as_tensor(d), tfb,
                                 t_max=torch.as_tensor(t, dtype=torch.float32))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(rec.tri) >= 0)


def test_cuda_request_raises_instead_of_falling_back(setup, monkeypatch):
    """A non-CPU tensor goes to the kernel path, which raises without a CUDA
    device; a failing build raises too.  The plain version is never called
    for them and no launch is counted."""
    _, tfb, o, d, tmax = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tfu, "fused_traverse_plain", no_fallback)
    launches = dict(tfu.LAUNCHES)
    meta = lambda x: torch.zeros(x.shape, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu.fused_closest_hit(meta(o), meta(d), tfb.to("meta"), t_max=meta(tmax))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu._fused_traverse_cuda(tfu.pack_rays(torch.as_tensor(o[:128]), torch.as_tensor(d[:128]), 1e10),
                                 tfb, 128, 8)

    def broken(*a, **k):
        raise native.BuildError("nvcc failed")

    monkeypatch.setattr(native, "_compile", broken)
    monkeypatch.setattr(tfu, "_cuda_lib", None)
    with pytest.raises(native.BuildError):
        tfu.build_kernels()
    assert tfu.LAUNCHES == launches

