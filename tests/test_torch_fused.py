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
import chip_smoke
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



# ── the kernel's list scans: group boxes and the plain list scan ──────────


@pytest.fixture(scope="module")
def small_clusters():
    """The soup in clusters of C=8 (K in the hundreds: a dozen group boxes)
    and 256 rays, a quarter of them with a short t_max."""
    verts, idx, r = _soup()
    fb = tfu.build_fused(tcl.build_clusters(verts, idx, 8, device="cpu"))
    n = 256
    o = torch.as_tensor(r.uniform(-6, 6, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    tmax = torch.as_tensor(np.where(r.random(n) < 0.25, r.uniform(1.0, 4.0, n), 1e10).astype(np.float32))
    return fb, o, d, tmax


def test_group_boxes_contain_their_members(small_clusters):
    """Each group box is the exact min / max over its GROUP_SIZE members
    (the last group over the clusters left), so it contains every member's
    box; it is made from the boxes on construction and survives .to()."""
    fb = small_clusters[0]
    k, size = fb.num_clusters, tfu.GROUP_SIZE
    kg = -(-k // size)
    assert fb.groups.shape == (8, kg)
    part = tfu.group_boxes(fb.boxes[:, : k - 5])  # a partial last group
    assert part.shape == (8, -(-(k - 5) // size))
    assert torch.equal(part[:, -1], torch.cat([fb.boxes[0:3, (kg - 1) * size : k - 5].amin(1),
                                               fb.boxes[3:6, (kg - 1) * size : k - 5].amax(1), torch.zeros(2)]))
    for gi in range(kg):
        members = fb.boxes[:, gi * size : min(k, (gi + 1) * size)]
        assert torch.equal(fb.groups[0:3, gi], members[0:3].amin(1))
        assert torch.equal(fb.groups[3:6, gi], members[3:6].amax(1))
    assert (fb.groups[0:3].repeat_interleave(size, 1)[:, :k] <= fb.boxes[0:3]).all()
    assert (fb.groups[3:6].repeat_interleave(size, 1)[:, :k] >= fb.boxes[3:6]).all()
    assert torch.equal(fb.to("cpu").groups, fb.groups)
    assert torch.equal(tfu.FusedBVH(boxes=fb.boxes, planes=fb.planes, cluster=fb.cluster).groups, fb.groups)


@pytest.mark.parametrize("retired_share", [0.0, 0.3, 0.9])
def test_group_skips_give_the_full_scans_lists(small_clusters, retired_share):
    """The plain list scan with group skips gives every ray the same KCAND
    (entry, id) pairs as the scan of every box, with clusters retired or
    not, and slab-tests fewer boxes; the lists are the KCAND nearest entries
    in (entry, id) order."""
    fb, o, d, tmax = small_clusters
    k = fb.num_clusters
    retired = torch.as_tensor(np.random.default_rng(5).random(k) < retired_share)
    e_g, i_g, tests_g = tfu.nearest_lists(o, d, tmax, fb, retired, groups=True)
    e_f, i_f, tests_f = tfu.nearest_lists(o, d, tmax, fb, retired, groups=False)
    assert torch.equal(e_g, e_f) and torch.equal(i_g, i_f)
    assert (tests_f == int((~retired).sum())).all()
    assert (tests_g < tests_f).float().mean() > 0.5
    ent = torch.where(~retired, tcl._cluster_entries(o, d, fb.cluster, tm.T_MIN, tmax), torch.inf)
    finite = torch.isfinite(e_f)
    assert torch.equal(e_f[finite], torch.gather(ent, 1, i_f.clamp(max=k - 1))[finite])
    assert (i_f[~finite] == k).all() and finite.any() and (~finite).any()
    order = e_f[:, :-1] < e_f[:, 1:]
    ties = (e_f[:, :-1] == e_f[:, 1:]) & finite[:, 1:]
    assert (order | ties | ~finite[:, 1:]).all() and (i_f[:, :-1][ties] < i_f[:, 1:][ties]).all()
    if retired_share == 0.0:
        assert int(finite.sum(1).max()) == tfu.KCAND


def test_group_entered_with_no_member_entered():
    """chip_smoke.corner_groups: rays that enter group 0's box and none of
    its 32 members; the group-skip scan tests the members (and skips them),
    its lists equal the full scan's (cluster 32, behind), and the plain
    traversal hits cluster 32 at t = 4."""
    fb, o, d = chip_smoke.corner_groups("cpu")
    assert fb.num_clusters == 64 and fb.groups.shape == (8, 2)
    tmax = torch.full((o.shape[0],), 1e10)
    gent = tcl._cluster_entries(o, d, tfu._boxes_as_clusters(fb.groups), tm.T_MIN, tmax)
    ent = tcl._cluster_entries(o, d, fb.cluster, tm.T_MIN, tmax)
    assert torch.isfinite(gent).all()
    assert torch.isinf(ent[:, :32]).all() and (torch.isfinite(ent).sum(1) == 1).all()
    e_g, i_g, tests_g = tfu.nearest_lists(o, d, tmax, fb, groups=True)
    e_f, i_f, _ = tfu.nearest_lists(o, d, tmax, fb, groups=False)
    assert torch.equal(e_g, e_f) and torch.equal(i_g, i_f) and (i_g[:, 0] == 32).all()
    assert (tests_g == 2 + 64).all()  # both groups entered: every member tested
    out = tfu.fused_traverse(o, d, tmax, fb)
    assert (out[:, 4] == 1).all() and (out[:, 0] == 4.0).all() and (out[:, 3] == 32).all()
