"""Port any-hit (K2) and mixed (K3) traversal vs the JAX package's (Pallas
kernel in interpret mode, component planes), on the 3000-triangle soup of
tests/test_fused2.py.

Tolerances are the reference's own: occlusion flags exact
(test_any_hit_occlusion); in the mixed sweep the closest-hit lanes' winning
triangle and attribute blob exact and t to rtol 5e-6 (XLA may contract the
Moller-Trumbore sums into FMAs, the port never does), the shadow lanes'
flags exact.  The CUDA kernels themselves are held against the plain
versions on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from test_fused2 import _soup
from test_torch_no_jax import _tiny_accel

torch.set_num_threads(2)

SORTS = [False, "morton", "cid2"]


@pytest.fixture(scope="module")
def setup():
    verts, idx, r = _soup()
    normals = r.normal(size=verts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    texcoords = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    tri_mat = r.integers(0, 5, len(idx)).astype(np.int32)
    kw = dict(cluster_size=64, normals=normals, texcoords=texcoords, tri_mat=tri_mat)
    jfb = jf2.build_fused2(verts, idx, mxu=False, **kw)
    tfb = tf2.build_fused2(verts, idx, mxu=False, device="cpu", **kw)
    n = 512
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    shadow = r.random(n) < 0.5
    # shadow lanes carry a light distance, bounce lanes T_MAX (the deferred-NEE wave)
    mixed_tmax = np.where(shadow, r.uniform(2.0, 20.0, n), 1e10).astype(np.float32)
    return jfb, tfb, o, d, tmax, shadow, mixed_tmax


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("sort", SORTS)
@pytest.mark.parametrize("per_ray", [False, True])
def test_occluded_matches_jax(setup, per_ray, sort):
    jfb, tfb, o, d, tmax, *_ = setup
    if not per_ray:
        tmax = np.full(len(o), 1e10, np.float32)
    want = np.asarray(jf2.fused2_occluded(jnp.asarray(o), jnp.asarray(d), jfb, t_max=jnp.asarray(tmax),
                                          sort=sort, interpret=True))
    assert 0.1 < want.mean() < 0.9  # both answers occur
    to, td, tt = _t(o, d, tmax)
    got = tf2.fused2_occluded(to, td, tfb, t_max=tt, sort=sort)
    np.testing.assert_array_equal(got.numpy(), want)
    # the flag is exactly the cluster query's "there is a closest hit"
    np.testing.assert_array_equal(got.numpy(), tcl.cluster_occluded(to, td, tfb.cluster, t_max=tt).numpy())


@pytest.mark.parametrize("sort", SORTS)
def test_sweep_mixed_matches_jax(setup, sort):
    jfb, tfb, o, d, _, shadow, tmax = setup
    rec_j, blob_j, occ_j = jf2.fused2_sweep_mixed(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(shadow), jfb,
        sort=sort, interpret=True)
    to, td, tt, ts = _t(o, d, tmax, shadow)
    rec, blob, occ = tf2.fused2_sweep_mixed(to, td, tt, ts, tfb, sort=sort)
    ns, sh = ~shadow, shadow
    tri_j = np.asarray(rec_j.tri)
    assert (tri_j[ns] >= 0).mean() > 0.3 and 0.1 < np.asarray(occ_j)[sh].mean() < 0.9
    np.testing.assert_array_equal(rec.tri.numpy()[ns], tri_j[ns])
    np.testing.assert_allclose(rec.t.numpy()[ns], np.asarray(rec_j.t)[ns], rtol=5e-6)
    np.testing.assert_array_equal(blob.numpy()[ns], np.asarray(blob_j)[ns])
    np.testing.assert_array_equal(occ.numpy()[sh], np.asarray(occ_j)[sh])
    # and the port's own separate sweeps give the same answers
    sep, sep_blob = tf2.fused2_closest_hit(to, td, tfb, t_max=tt)
    np.testing.assert_array_equal(rec.tri.numpy()[ns], sep.tri.numpy()[ns])
    np.testing.assert_array_equal(blob.numpy()[ns], sep_blob.numpy()[ns])
    np.testing.assert_array_equal(occ.numpy()[sh], tf2.fused2_occluded(to, td, tfb, t_max=tt).numpy()[sh])
    # closest-hit lanes that miss report T_MAX
    assert (rec.t.numpy()[ns & (rec.tri.numpy() < 0)] == np.float32(1e10)).all()


def test_plain_any_hit_contract(setup):
    _, tfb, o, d, tmax, *_ = setup
    to, td, tt = _t(o, d, tmax)
    out = tf2.fused2_traverse_packed_plain(tf2.pack_rays(to, td, tt), tfb, mode="any_hit")
    occ = tcl.cluster_occluded(to, td, tfb.cluster, t_max=tt)
    np.testing.assert_array_equal(out[:, 4].numpy(), occ.float().numpy())
    np.testing.assert_array_equal(out[:, 0].numpy(), tmax)  # t is never lowered
    assert (out[:, 3] == -1).all() and (out[:, 7:9] == -1).all() and (out[:, 5] == 1).all()
    assert (out[:, 1:3] == 0).all() and (out[:, 6] == 0).all() and (out[:, 9:32] == 0).all()


def test_plain_mixed_contract(setup):
    """Closest-hit rows for every lane; a shadow lane's col 4 is its flag."""
    _, tfb, o, d, _, shadow, tmax = setup
    to, td, tt, ts = _t(o, d, tmax, shadow)
    rays = tf2.pack_rays(to, td, tt, ts)
    np.testing.assert_array_equal(rays[:, 7].numpy(), shadow.astype(np.float32))
    out = tf2.fused2_traverse_packed_plain(rays, tfb, mode="mixed")
    closest = tf2.fused2_traverse_packed_plain(rays, tfb)
    np.testing.assert_array_equal(out.numpy(), closest.numpy())
    occ = tf2.fused2_traverse_packed_plain(rays, tfb, mode="any_hit")
    np.testing.assert_array_equal(out[ts, 4].numpy(), occ[ts, 4].numpy())
    with pytest.raises(ValueError, match="mode"):
        tf2.fused2_traverse_packed_plain(rays, tfb, mode="nearest")


def test_unresolved_rows_get_the_exact_query(setup, monkeypatch):
    """Rows a kernel block leaves unresolved (col 5 = 0) are answered by the
    exact cluster query, in both new wrappers, and counted."""
    _, tfb, o, d, tmax, shadow, mixed_tmax = setup
    plain = tf2.fused2_traverse_packed_plain

    def overflowing(rays, fb, block=tf2.BLOCK_RAYS, max_steps=tf2.MAX_STEPS, mode="closest",
                    fanout=tf2.FANOUT, with_attrs=True):
        out = plain(rays, fb, mode, with_attrs)
        bad = torch.arange(rays.shape[0]) % 3 == 0
        out[bad, 0:5] = 12345.0  # garbage a real overflow would leave behind
        out[bad, 16:32] = -7.0
        out[bad, 5] = 0.0
        return out

    to, td, tt, ts, tm = _t(o, d, tmax, shadow, mixed_tmax)
    want_occ = tf2.fused2_occluded(to, td, tfb, t_max=tt)
    want_rec, want_blob, want_mixed = tf2.fused2_sweep_mixed(to, td, tm, ts, tfb)
    monkeypatch.setattr(tf2, "fused2_traverse_packed", overflowing)
    before = tf2.UNRESOLVED_RAYS
    np.testing.assert_array_equal(tf2.fused2_occluded(to, td, tfb, t_max=tt).numpy(), want_occ.numpy())
    rec, blob, occ = tf2.fused2_sweep_mixed(to, td, tm, ts, tfb)
    assert tf2.UNRESOLVED_RAYS - before == 2 * int((torch.arange(len(o)) % 3 == 0).sum())
    np.testing.assert_array_equal(occ.numpy(), want_mixed.numpy())
    np.testing.assert_array_equal(rec.tri.numpy(), want_rec.tri.numpy())
    np.testing.assert_array_equal(rec.t.numpy(), want_rec.t.numpy())
    np.testing.assert_array_equal(blob.numpy(), want_blob.numpy())


@pytest.mark.parametrize("mode", ["any_hit", "mixed"])
def test_cuda_dispatch_raises_instead_of_falling_back(monkeypatch, mode):
    """A non-CPU request in either new mode goes to the kernel path, which
    raises when there is no CUDA device; the plain version is never called
    and no launch is counted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tf2, "fused2_traverse_packed_plain", no_fallback)
    counts = dict(tf2.LAUNCHES)
    rays = torch.zeros((128, 8), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf2.fused2_traverse_packed(rays, _tiny_accel("meta"), block=128, mode=mode)
    o = torch.zeros((100, 3), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        if mode == "any_hit":
            tf2.fused2_occluded(o, o, _tiny_accel("meta"), t_max=torch.ones(100, device="meta"))
        else:
            tf2.fused2_sweep_mixed(o, o, torch.ones(100, device="meta"),
                                   torch.zeros(100, dtype=torch.bool, device="meta"), _tiny_accel("meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tf2._fused2_traverse_cuda(torch.zeros((128, 8)), _tiny_accel("cpu"), 128, 8, mode)
    assert tf2.LAUNCHES == counts
