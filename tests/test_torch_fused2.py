"""Port fused2 traversal vs the JAX package's (Pallas kernel in interpret
mode, component planes), on the 3000-triangle soup of tests/test_fused2.py.

Tolerances are the reference's own (tests/test_fused2.py): winning triangle
and attribute blob exact; t to rtol 5e-6 / atol 1e-7 and uv to rtol 5e-6 /
atol 1e-6 (XLA may contract the Moller-Trumbore sums into FMAs, the port
never does).  The CUDA kernel itself is held against the plain version on a
card by tests/test_torch_cuda.py.
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu.ops import cluster as jcl
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.ops.intersect import closest_hit_brute as j_brute
from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.ops.intersect import closest_hit_brute as t_brute
from test_fused2 import _soup
from test_torch_scene import as_numpy, assert_same_arrays

torch.set_num_threads(2)


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
    return jfb, tfb, o, d, tmax, verts, idx


def _jax_hits(jfb, o, d, t_max=1e10):
    rec, blob = jf2.fused2_closest_hit(
        jnp.asarray(o), jnp.asarray(d), jfb, t_max=jnp.asarray(t_max), interpret=True)
    return np.asarray(rec.t), np.asarray(rec.tri), np.asarray(rec.uv), np.asarray(blob)


def _port_hits(tfb, o, d, t_max=1e10, **kw):
    rec, blob = tf2.fused2_closest_hit(torch.as_tensor(o), torch.as_tensor(d), tfb,
                                       t_max=torch.as_tensor(t_max), **kw)
    return rec.t.numpy(), rec.tri.numpy(), rec.uv.numpy(), blob.numpy()


def _assert_hits_match(got, want):
    t, tri, uv, blob = got
    t_w, tri_w, uv_w, blob_w = want
    np.testing.assert_array_equal(tri, tri_w)
    np.testing.assert_allclose(t, t_w, rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(uv, uv_w, rtol=5e-6, atol=1e-6)
    np.testing.assert_array_equal(blob, blob_w)


def test_accel_build_equals_jax(setup):
    jfb, tfb, *_ = setup
    assert_same_arrays(tfb, as_numpy(jfb))


@pytest.mark.parametrize("cluster_size", [16, 128])
def test_build_clusters_equals_jax(setup, cluster_size):
    """Same native SAH tree, same leaf packing, same pads."""
    *_, verts, idx = setup
    want = as_numpy(jcl.build_clusters(verts, idx, cluster_size))
    assert_same_arrays(tcl.build_clusters(verts, idx, cluster_size, device="cpu"), want)


def test_closest_hit_matches_jax(setup):
    jfb, tfb, o, d, *_ = setup
    want = _jax_hits(jfb, o, d, np.full(len(o), 1e10, np.float32))
    assert (want[1] >= 0).mean() > 0.3  # the soup is hit often enough to mean something
    _assert_hits_match(_port_hits(tfb, o, d, np.float32(1e10)), want)


def test_per_ray_tmax_matches_jax(setup):
    jfb, tfb, o, d, tmax, *_ = setup
    _assert_hits_match(_port_hits(tfb, o, d, tmax), _jax_hits(jfb, o, d, tmax))


def test_ragged_ray_count_matches_jax(setup):
    """N = 37 is not a multiple of the block: padding rays must not hit."""
    jfb, tfb, o, d, *_ = setup
    o, d = o[:37], d[:37]
    _assert_hits_match(_port_hits(tfb, o, d), _jax_hits(jfb, o, d, np.full(37, 1e10, np.float32)))


@pytest.mark.parametrize("mode", ["morton", "cid2"])
def test_wave_sort_keys_equal_jax(setup, mode):
    jfb, tfb, o, d, tmax, *_ = setup
    keys_fn = jax.jit(jf2.wave_sort_keys, static_argnames="mode")
    want = np.asarray(keys_fn(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jfb, mode=mode))
    got = tf2.wave_sort_keys(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), tfb, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("mode", ["morton", "cid2"])
def test_sorted_equals_unsorted(setup, mode):
    _, tfb, o, d, tmax, *_ = setup
    a = _port_hits(tfb, o, d, tmax, sort=False)
    b = _port_hits(tfb, o, d, tmax, sort=mode)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_unresolved_rows_get_the_exact_cluster_query(setup):
    """Rows a kernel block leaves unresolved (resolved = 0) are answered by
    cluster_closest_hit, with the attribute-table row of its winner (zeros
    for a miss)."""
    _, tfb, o, d, tmax, *_ = setup
    ray_o, ray_d, t_max = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    out = tf2.fused2_traverse_packed_plain(tf2.pack_rays(ray_o, ray_d, t_max), tfb)
    bad = torch.zeros(len(o), dtype=torch.bool)
    bad[::3] = True
    out[bad, 0:5] = 12345.0  # garbage a real overflow would leave behind
    out[bad, 16:32] = -7.0
    out[bad, 5] = 0.0
    before = tf2.UNRESOLVED_RAYS
    rec, blob = tf2._hits_from_output(out, ray_o, ray_d, tfb, 1e-3, t_max)
    assert tf2.UNRESOLVED_RAYS - before == int(bad.sum())
    ref = tcl.cluster_closest_hit(ray_o[bad], ray_d[bad], tfb.cluster, t_max=t_max[bad])
    np.testing.assert_array_equal(rec.tri[bad].numpy(), ref.tri.numpy())
    np.testing.assert_array_equal(rec.t[bad].numpy(), ref.t.numpy())
    np.testing.assert_array_equal(rec.uv[bad].numpy(), ref.uv.numpy())
    want_blob = torch.where(ref.hit[:, None], tfb.attr_table[ref.tri.clamp(min=0)][:, :16], 0.0)
    np.testing.assert_array_equal(blob[bad].numpy(), want_blob.numpy())
    # resolved rows pass through untouched
    good = ~bad
    np.testing.assert_array_equal(blob[good].numpy(), out[good, 16:32].numpy())


def test_plain_version_contract(setup):
    """Winner cluster/slot columns point at the winner's attribute column."""
    _, tfb, o, d, tmax, *_ = setup
    out = tf2.fused2_traverse_packed_plain(
        tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)), tfb)
    hit = out[:, 4] > 0
    cid, slot = out[hit, 7].long(), out[hit, 8].long()
    np.testing.assert_array_equal(tfb.attrs[cid, 16, slot].numpy(), out[hit, 3].numpy())
    assert (out[~hit, 3] == -1).all() and (out[~hit, 7] == -1).all()
    assert (out[:, 5] == 1).all()


def test_brute_oracle_matches_jax_and_fused2(setup):
    """The port's brute-force oracle equals the JAX one, and the port's
    fused2 traversal finds the same winners as the brute sweep."""
    _, tfb, o, d, _, verts, idx = setup
    ref = j_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(idx))
    got = t_brute(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(verts), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(ref.uv), rtol=5e-6, atol=1e-6)
    rec, _ = tf2.fused2_closest_hit(torch.as_tensor(o), torch.as_tensor(d), tfb)
    np.testing.assert_array_equal(rec.tri.numpy(), got.tri.numpy())


@pytest.fixture(scope="module")
def tie_soup():
    """chip_smoke.tie_soup_arrays (exact-t ties between two copies of one
    triangle at slots 29 and 32 of one cluster, C=64) in both packages."""
    (verts, idx, normals, texcoords, tri_mat), (o, d, tmax, shadow) = chip_smoke.tie_soup_arrays()
    kw = dict(cluster_size=64, normals=normals, texcoords=texcoords, tri_mat=tri_mat, mxu=False)
    jfb = jf2.build_fused2(verts, idx, **kw)
    tfb = tf2.build_fused2(verts, idx, device="cpu", **kw)
    return jfb, tfb, o, d, tmax, shadow


def test_tie_soup_copies_straddle_the_slot_halves(tie_soup):
    """The layout the tie-rule test relies on: both copies in one cluster,
    one below and one above C/2."""
    _, tfb, *_ = tie_soup
    tid = tfb.planes[:, 9].long()
    where = torch.nonzero(tid >= 62).tolist()
    c = tfb.cluster_size
    assert len(where) == 2 and where[0][0] == where[1][0]
    assert where[0][1] < c // 2 <= where[1][1]


@pytest.mark.parametrize("mode", ["closest", "mixed"])
def test_exact_tie_inside_a_cluster_goes_to_the_lowest_slot(tie_soup, mode):
    """Closest-hit lanes whose nearest hit is an exact t tie between the two
    copies take the lower slot, in the plain version as in the JAX
    package's kernel (interpret mode): the rule the slot-parallel kernel's
    combine across warps must keep."""
    jfb, tfb, o, d, tmax, shadow = tie_soup
    sh = shadow if mode == "mixed" else None
    rays = tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
                         None if sh is None else torch.as_tensor(sh))
    got = tf2.fused2_traverse_packed_plain(rays, tfb, mode)
    want = np.asarray(jf2.fused2_traverse_packed(
        jf2.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), None if sh is None else jnp.asarray(sh)),
        jfb, interpret=True, block=128, mixed=mode == "mixed"))
    tid = tfb.planes[:, 9].long()
    (cid, lo), (_, hi) = torch.nonzero(tid >= 62).tolist()
    closest = ~torch.as_tensor(shadow) if mode == "mixed" else torch.ones(128, dtype=torch.bool)
    on_copy = (got[:, 7] == cid) & (got[:, 3] >= 62) & closest
    assert int(on_copy[:64].sum()) >= 24  # most tie rays reach the copies
    assert (got[on_copy, 8] == lo).all() and (got[on_copy, 3] == int(tid[cid, lo])).all()
    keep = closest.numpy()
    for col in (3, 4, 7, 8):  # tri, hit, winner cluster, winner slot
        np.testing.assert_array_equal(got[keep, col].numpy(), want[keep, col])
    np.testing.assert_allclose(got[keep, 0].numpy(), want[keep, 0], rtol=5e-6, atol=1e-7)
    np.testing.assert_array_equal(got[keep, 16:32].numpy(), want[keep, 16:32])
    if mode == "mixed":
        np.testing.assert_array_equal(got[~keep, 4].numpy(), want[~keep, 4])


@pytest.mark.parametrize("layout, mode, with_attrs", [
    ("component", "any_hit", False), ("component", "closest", False), ("mxu_f32", "closest", True),
    ("mxu_bf16", "closest", True), ("mxu_f32", "mixed", True),
])
def test_serial_selection_raises_without_a_yardstick(setup, layout, mode, with_attrs):
    """serial=True names the serial body of component closest hit (with
    attributes) and of the mixed sweep; MXU layouts and the modes with no
    serial entry raise, on the CPU as on the card."""
    _, tfb, o, d, tmax, verts, idx = setup
    if layout != "component":
        tfb = tf2.build_fused2(verts, idx, 64, mxu=True, device="cpu",
                               plane_dtype=torch.bfloat16 if layout == "mxu_bf16" else torch.float32)
    rays = tf2.pack_rays(torch.as_tensor(o[:128]), torch.as_tensor(d[:128]), torch.as_tensor(tmax[:128]))
    with pytest.raises(ValueError, match="serial=True"):
        tf2.fused2_traverse_packed(rays, tfb, mode=mode, with_attrs=with_attrs, serial=True)


@pytest.mark.parametrize("mode", ["closest", "mixed"])
def test_serial_selection_on_the_cpu_is_the_plain_version(setup, mode):
    _, tfb, o, d, tmax, *_ = setup
    rays = tf2.pack_rays(torch.as_tensor(o[:128]), torch.as_tensor(d[:128]), torch.as_tensor(tmax[:128]),
                         torch.as_tensor(np.arange(128) % 2 == 1) if mode == "mixed" else None)
    assert tf2._entry(tfb, mode, True, serial=True) == f"owlpt_fused2_serial_{'closest_hit' if mode == 'closest' else 'sweep_mixed'}"
    got = tf2.fused2_traverse_packed(rays, tfb, mode=mode, serial=True)
    assert torch.equal(got, tf2.fused2_traverse_packed_plain(rays, tfb, mode))


# the kernel source's entry declarations: OWLPT_FUSED2_ENTRY (the serial
# body on component planes, the tensor-core body on MXU planes) and
# OWLPT_FUSED2_SLOT_ENTRY (the slot-parallel component body)
_SOURCE_MODES = {"kClosest": "closest", "kAnyHit": "any_hit", "kMixed": "mixed"}
_SOURCE_LAYOUTS = {"kComponent": "component_serial", "kMxuF32": "mxu_f32", "kMxuBf16": "mxu_bf16"}


def _declared_entries():
    """{entry name: (layout, mode, with_attrs)} as csrc/fused2_traverse.cu declares them."""
    src = tf2.CSRC.read_text()
    out = {}
    for name, mode, layout, attrs in re.findall(r"^OWLPT_FUSED2_ENTRY\((\w+), (\w+), (\w+), (true|false)\)$", src,
                                                re.M):
        out[name] = (_SOURCE_LAYOUTS[layout], _SOURCE_MODES[mode], attrs == "true")
    for name, mode, attrs in re.findall(r"^OWLPT_FUSED2_SLOT_ENTRY\((\w+), (\w+), (true|false)\)$", src, re.M):
        out[name] = ("component", _SOURCE_MODES[mode], attrs == "true")
    return out


@pytest.mark.parametrize("key", list(tf2._ENTRY), ids=lambda k: "-".join(map(str, k)))
def test_entry_table_is_the_sources(key):
    """Each key of the entry table names its entry through _entry, the
    kernel source declares that entry with the key's layout, mode and
    attributes (the slot-parallel component entries by their own macro),
    and the source declares no traversal entry the table lacks."""
    layout, mode, attrs = key
    serial = layout == "component_serial"
    fb = types.SimpleNamespace(layout="component" if serial else layout, mxu=layout.startswith("mxu"))
    name = tf2._ENTRY[key]
    assert tf2._entry(fb, mode, attrs, serial=serial) == name
    declared = _declared_entries()
    assert declared[name] == key
    assert set(declared) == set(tf2._ENTRY.values())
    assert (name in tf2._SLOT_ENTRIES) == (layout == "component")


@pytest.fixture(scope="module")
def wide_clusters(setup):
    """The soup's component builds at C = 1024 (more slots than one CTA of
    the slot-parallel body has threads) and C = 2560 (more than a full
    thread block cluster of them), JAX and port, by C."""
    *_, verts, idx = setup
    r = np.random.default_rng(3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    kw = dict(normals=normals, texcoords=r.uniform(0, 1, (len(verts), 2)).astype(np.float32),
              tri_mat=r.integers(0, 5, len(idx)).astype(np.int32), mxu=False)
    return {c: (jf2.build_fused2(verts, idx, cluster_size=c, **kw),
                tf2.build_fused2(verts, idx, cluster_size=c, device="cpu", **kw)) for c in (1024, 2560)}


@pytest.mark.parametrize("mode", ["closest", "any_hit", "mixed"])
@pytest.mark.parametrize("c", [1024, 2560])
def test_wide_clusters_match_jax(setup, wide_clusters, c, mode):
    """At cluster sizes above the slot-parallel body's threads per CTA and
    per thread block cluster, the plain version (what the card entries are
    held to) gives the JAX package's kernel's answers (interpret mode):
    winners, hits and attribute blobs exact, t to the reference's tolerance."""
    _, _, o, d, tmax, *_ = setup
    jfb, tfb = wide_clusters[c]
    n = 128
    o, d, tmax = o[:n], d[:n], tmax[:n]
    shadow = np.arange(n) % 2 == 1 if mode == "mixed" else None
    rays = tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
                         None if shadow is None else torch.as_tensor(shadow))
    got = tf2.fused2_traverse_packed_plain(rays, tfb, mode, with_attrs=mode != "any_hit")
    want = np.asarray(jf2.fused2_traverse_packed(
        jf2.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                      None if shadow is None else jnp.asarray(shadow)),
        jfb, interpret=True, block=n, with_attrs=mode != "any_hit", any_hit=mode == "any_hit",
        mixed=mode == "mixed"))
    assert 0 < int(got[:, 4].sum()) < n  # some rays hit, some miss
    closest = np.zeros(n, bool) if mode == "any_hit" else ~shadow if mode == "mixed" else np.ones(n, bool)
    np.testing.assert_array_equal(got[~closest, 4].numpy(), want[~closest, 4])
    for col in (3, 4, 7, 8):  # tri, hit, winner cluster, winner slot
        np.testing.assert_array_equal(got[closest, col].numpy(), want[closest, col])
    np.testing.assert_allclose(got[closest, 0].numpy(), want[closest, 0], rtol=5e-6, atol=1e-7)
    np.testing.assert_array_equal(got[closest, 16:32].numpy(), want[closest, 16:32])
