"""The MXU feature layout (kernel K1b: f32 and bf16 planes, fanout 2) and the
no-attributes closest hit (K4): the port's plain versions vs the JAX
package's Pallas kernel in interpret mode, on the 3000-triangle soup of
tests/test_fused2.py and small scenes.

Tolerances.  Builds are bit-equal (bf16 planes compared as 16-bit patterns).
Winners follow the near-tie rule: the winning triangle is equal on every ray
except where the matmul-space t (t*det / det) of both winners agree to 1e-5
relative -- the port sums the feature products in ascending row order, XLA
in its own, and the port walks clusters in entry order where the kernel
retires them block by block.  On rows with equal winners the replayed t to
rtol 5e-6 / atol 1e-7 (tests/test_fused2.py's tolerance) and uv to rtol 5e-6
/ atol 3e-6, and the attribute blob exactly: XLA may contract the replay's
sums into FMAs, the port never does, and u = (s . h) / det of a sliver
triangle amplifies that (measured up to 2.3e-6 absolute, bf16 soup; 1.7e-6
f32; tests/test_fused2.py holds uv to atol 1e-6 on the component layout).
K4's loop t/u/v: component layout as K1's; MXU layout t to rtol 1e-5 /
atol 1e-6 and u/v to rtol 1e-5 / atol 5e-5: they are quotients of matmul
sums, u = (u*det) / det, and XLA sums u*det in its own order, so a sum that
cancels to a few ulp of its terms moves u (measured up to 2.3e-5 absolute on
the soup).  Occlusion flags: at least 99.5% equal (the count is printed).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import wavefront as twf
from test_fused2 import _soup
from test_torch_scene import as_numpy, assert_same_arrays
from test_torch_wavefront import SETTINGS, _scenes

torch.set_num_threads(2)

DTYPES = {"f32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def soup():
    verts, idx, r = _soup()
    normals = r.normal(size=verts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    texcoords = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    tri_mat = r.integers(0, 5, len(idx)).astype(np.int32)
    kw = dict(cluster_size=64, normals=normals, texcoords=texcoords, tri_mat=tri_mat)
    accels = {}
    for name, (jdt, tdt) in DTYPES.items():
        accels[name] = (jf2.build_fused2(verts, idx, mxu=True, plane_dtype=jdt, **kw),
                        tf2.build_fused2(verts, idx, plane_dtype=tdt, device="cpu", **kw))
    accels["component"] = (jf2.build_fused2(verts, idx, mxu=False, **kw),
                           tf2.build_fused2(verts, idx, mxu=False, device="cpu", **kw))
    n = 512
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    shadow = np.arange(n) % 2 == 1
    dist = np.where(shadow, r.uniform(2.0, 20.0, n), 1e10).astype(np.float32)
    return accels, o, d, tmax, shadow, dist


def _bits(planes):
    """Planes (a tensor or a numpy array) as the integers of their width, to
    compare bf16 and f32 bit for bit."""
    if isinstance(planes, torch.Tensor):
        return planes.view(torch.int16 if planes.dtype == torch.bfloat16 else torch.int32).numpy()
    return planes.view(np.int16 if planes.dtype.itemsize == 2 else np.int32)


def assert_same_accel(tfb, jfb):
    ref = as_numpy(jfb)
    planes = ref.pop("planes")
    assert_same_arrays(tfb, ref)
    assert tuple(tfb.planes.shape) == planes.shape
    np.testing.assert_array_equal(_bits(tfb.planes), _bits(planes))


def _slots(tfb, tri):
    """(cluster, slot) of each triangle id (-1, -1 for a miss)."""
    tid = tfb.cluster.tri_id.numpy()
    cid = np.full(tid.max() + 2, -1)
    slot = np.full(tid.max() + 2, -1)
    k, s = np.nonzero(tid >= 0)
    cid[tid[k, s]] = k
    slot[tid[k, s]] = s
    return torch.as_tensor(cid[tri]), torch.as_tensor(slot[tri])


def assert_near_tie_winners(tfb, o, d, tri, tri_want):
    """Winners equal except near ties (matmul-space t within 1e-5) -> equal rows."""
    same = tri == tri_want
    if not same.all():
        oo, dd = torch.as_tensor(o[~same]), torch.as_tensor(d[~same])
        t_got = tf2.mxu_slot_test(oo, dd, tfb, *_slots(tfb, tri[~same]), torch.inf)[0].numpy()
        t_want = tf2.mxu_slot_test(oo, dd, tfb, *_slots(tfb, tri_want[~same]), torch.inf)[0].numpy()
        tie = np.isfinite(t_got) & np.isfinite(t_want) & np.isclose(t_got, t_want, rtol=1e-5, atol=0)
        assert tie.all(), (np.nonzero(~same)[0][~tie], tri[~same][~tie], tri_want[~same][~tie])
    print(f"{int((~same).sum())} near-tie rows of {len(tri)}")
    return same


def _jax_closest(jfb, o, d, tmax, **kw):
    rec, blob = jf2.fused2_closest_hit(jnp.asarray(o), jnp.asarray(d), jfb, t_max=jnp.asarray(tmax),
                                       interpret=True, **kw)
    return np.asarray(rec.t), np.asarray(rec.tri), np.asarray(rec.uv), np.asarray(blob)


def _port_closest(tfb, o, d, tmax, **kw):
    rec, blob = tf2.fused2_closest_hit(torch.as_tensor(o), torch.as_tensor(d), tfb, t_max=torch.as_tensor(tmax),
                                       **kw)
    return rec.t.numpy(), rec.tri.numpy(), rec.uv.numpy(), blob.numpy()


def assert_closest_match(tfb, o, d, got, want):
    t, tri, uv, blob = got
    t_w, tri_w, uv_w, blob_w = want
    same = assert_near_tie_winners(tfb, o, d, tri, tri_w)
    np.testing.assert_allclose(t[same], t_w[same], rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(uv[same], uv_w[same], rtol=5e-6, atol=3e-6)
    np.testing.assert_array_equal(blob[same], blob_w[same])


# ── build ─────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mxu_build_equals_jax(soup, dtype):
    accels, *_ = soup
    jfb, tfb = accels[dtype]
    assert tfb.mxu and tfb.layout == ("mxu_f32" if dtype == "f32" else "mxu_bf16")
    assert_same_accel(tfb, jfb)


def test_bf16_needs_the_mxu_layout():
    verts, idx, _ = _soup(n_tris=20)
    with pytest.raises(ValueError, match="MXU"):
        tf2.build_fused2(verts, idx, 64, mxu=False, plane_dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("kind", ["fused2", "fused2-bf16"])
@pytest.mark.parametrize("name", ["sphere", "cornell-box"])
def test_make_accel_equals_jax(kind, name):
    """make_accel builds the JAX package's layout and plane type, and a JAX
    accelerator carried across by convert equals the port's own build."""
    js, ts = _scenes(name)
    jfb = jfilm.make_accel(js, kind)
    tfb = tfilm.make_accel(ts, kind)
    assert tfb.mxu and tfb.planes.dtype == (torch.bfloat16 if kind == "fused2-bf16" else torch.float32)
    assert_same_accel(tfb, jfb)
    carried = convert.fused2_from_numpy(as_numpy(jfb), device="cpu")
    assert carried.planes.dtype == tfb.planes.dtype
    np.testing.assert_array_equal(_bits(carried.planes), _bits(tfb.planes))
    assert_same_arrays(carried, {k: v for k, v in as_numpy(jfb).items() if k != "planes"})


# ── closest hit, any-hit, mixed (K1b) ─────────────────────────────────────


@pytest.mark.parametrize("fanout", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_closest_hit_matches_jax(soup, dtype, fanout):
    """Per-ray t_max on half of the rays; the port's answer does not depend
    on the fanout."""
    accels, o, d, tmax, *_ = soup
    jfb, tfb = accels[dtype]
    want = _jax_closest(jfb, o, d, tmax, fanout=fanout)
    assert (want[1] >= 0).mean() > 0.2
    got = _port_closest(tfb, o, d, tmax, fanout=fanout)
    assert_closest_match(tfb, o, d, got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_ray_count_matches_jax(soup, dtype):
    accels, o, d, *_ = soup
    jfb, tfb = accels[dtype]
    o, d, tmax = o[:37], d[:37], np.full(37, 1e10, np.float32)
    assert_closest_match(tfb, o, d, _port_closest(tfb, o, d, tmax), _jax_closest(jfb, o, d, tmax))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_any_hit_and_mixed_match_jax(soup, dtype):
    accels, o, d, tmax, shadow, dist = soup
    jfb, tfb = accels[dtype]
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    occ_j = np.asarray(jf2.fused2_occluded(jo, jd, jfb, t_max=jnp.asarray(tmax), interpret=True))
    occ = tf2.fused2_occluded(to, td, tfb, t_max=torch.as_tensor(tmax)).numpy()
    print(f"any-hit: {int((occ != occ_j).sum())} of {len(occ)} flags differ")
    assert (occ == occ_j).mean() >= 0.995 and 0 < occ.sum() < len(occ)

    rec_j, blob_j, occ_mj = jf2.fused2_sweep_mixed(jo, jd, jnp.asarray(dist), jnp.asarray(shadow), jfb,
                                                    interpret=True)
    rec, blob, occ_m = tf2.fused2_sweep_mixed(to, td, torch.as_tensor(dist), torch.as_tensor(shadow), tfb)
    occ_m, occ_mj = occ_m.numpy()[shadow], np.asarray(occ_mj)[shadow]
    print(f"mixed: {int((occ_m != occ_mj).sum())} of {len(occ_m)} shadow flags differ")
    assert (occ_m == occ_mj).mean() >= 0.995
    ns = ~shadow
    got = (rec.t.numpy()[ns], rec.tri.numpy()[ns], rec.uv.numpy()[ns], blob.numpy()[ns])
    want = (np.asarray(rec_j.t)[ns], np.asarray(rec_j.tri)[ns], np.asarray(rec_j.uv)[ns], np.asarray(blob_j)[ns])
    assert_closest_match(tfb, o[ns], d[ns], got, want)


# ── no attributes (K4) ───────────────────────────────────────────────────


def test_no_attrs_component_matches_jax(soup):
    accels, o, d, tmax, *_ = soup
    jfb, tfb = accels["component"]
    t_j, tri_j, uv_j, blob_j = _jax_closest(jfb, o, d, tmax, with_attrs=False)
    t, tri, uv, blob = _port_closest(tfb, o, d, tmax, with_attrs=False)
    np.testing.assert_array_equal(tri, tri_j)
    np.testing.assert_allclose(t, t_j, rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(uv, uv_j, rtol=5e-6, atol=1e-6)
    assert (blob == 0).all() and (blob_j == 0).all()


def test_no_attrs_mxu_matches_jax(soup):
    accels, o, d, tmax, *_ = soup
    jfb, tfb = accels["f32"]
    t_j, tri_j, uv_j, blob_j = _jax_closest(jfb, o, d, tmax, with_attrs=False)
    t, tri, uv, blob = _port_closest(tfb, o, d, tmax, with_attrs=False)
    same = assert_near_tie_winners(tfb, o, d, tri, tri_j)
    np.testing.assert_allclose(t[same], t_j[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(uv[same], uv_j[same], rtol=1e-5, atol=5e-5)
    assert (blob == 0).all() and (blob_j == 0).all()
    # the loop t is the matmul-space t of the winner, not the replayed one
    hit = tri >= 0
    loop_t, ok = tf2.mxu_slot_test(torch.as_tensor(o[hit]), torch.as_tensor(d[hit]), tfb, *_slots(tfb, tri[hit]),
                                   torch.as_tensor(tmax[hit]))
    np.testing.assert_array_equal(t[hit], loop_t.numpy())
    assert ok.all()  # every winner passes the window at its own slot


def test_no_attrs_exact_entry_on_the_cpu_is_the_plain_version(soup):
    """exact=True without attributes on f32 MXU planes names K4's CUDA-core
    yardstick (the tensor form's, off every render path); on the CPU it is
    the plain version, which test_no_attrs_mxu_matches_jax holds to JAX.
    bf16 planes and the other modes have no such entry."""
    accels, o, d, tmax, *_ = soup
    tfb = accels["f32"][1]
    assert tf2._entry(tfb, "closest", False, exact=True) == "owlpt_fused2_mxu_exact_closest_hit_noattr"
    assert tf2._entry(tfb, "closest", False) == "owlpt_fused2_mxu_closest_hit_noattr"
    rays = tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    got = tf2.fused2_traverse_packed(rays, tfb, with_attrs=False, exact=True)
    assert torch.equal(got, tf2.fused2_traverse_packed_plain(rays, tfb, with_attrs=False))
    with pytest.raises(ValueError, match="exact=True"):
        tf2.fused2_traverse_packed(rays, accels["component"][1], with_attrs=False, exact=True)
    with pytest.raises(ValueError, match="exact=True"):
        tf2.fused2_traverse_packed(rays, tfb, mode="any_hit", exact=True)
    with pytest.raises(ValueError, match="with_attrs"):
        tf2.fused2_traverse_packed(rays, accels["bf16"][1], with_attrs=False, exact=True)


def test_no_attrs_bf16_raises(soup):
    accels, o, d, tmax, *_ = soup
    _, tfb = accels["bf16"]
    with pytest.raises(ValueError, match="with_attrs"):
        tf2.fused2_closest_hit(torch.as_tensor(o), torch.as_tensor(d), tfb, with_attrs=False)
    rays = tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))
    with pytest.raises(ValueError, match="with_attrs"):
        tf2.fused2_traverse_packed_plain(rays, tfb, with_attrs=False)


# ── the slice as a whole ──────────────────────────────────────────────────


def test_bf16_frame_matches_jax():
    """A cornell-box frame through make_accel("fused2-bf16") on both sides
    (JAX: scatter film), golden rule, ray counts within 0.5%."""
    js, ts = _scenes("cornell-box")
    want, rays_want = jwf.render_image_wavefront(js, SETTINGS, accel=jfilm.make_accel(js, "fused2-bf16"),
                                                 lanes=1024, film_mode="scatter", fused2_sort=True)
    img, rays = twf.render_image_wavefront(ts, SETTINGS, tfilm.make_accel(ts, "fused2-bf16"), lanes=1024,
                                           fused2_sort=True)
    img = img.numpy()
    assert img.shape == want.shape and np.isfinite(img).all() and want.mean() > 0
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want, (rays, rays_want)


# ── the feature sums the card rule reads (chip_smoke.sums_decisions) ──────


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slot_sums_equal_feature_sums(soup, dtype):
    """mxu_slot_sums gives, per ray and (cluster, slot), the plain version's
    own sums bit for bit: those of _feature_sums for that slot and those of
    its whole-cluster form that the plain traversal reads; its absolute sums
    equal a float64 reference of sum_q |f_q p_q| to 10 roundings of 2^-24
    (9 additions, and the products on f32 planes)."""
    accels, o, d, *_ = soup
    _, tfb = accels[dtype]
    r = np.random.default_rng(5)
    n, c = len(o), tfb.cluster_size
    filled = torch.nonzero(tfb.cluster.tri_id >= 0)  # slots that hold a triangle
    cid, slot = filled[torch.as_tensor(r.integers(0, len(filled), n))].unbind(1)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    sums, absolute = tf2.mxu_slot_sums(to, td, tfb, cid, slot)
    feat = tf2._ray_features(to, td, dtype == "bf16")
    rows = torch.arange(n)
    for g, (s, a, ref, whole) in enumerate(zip(sums, absolute, tf2._feature_sums(feat, tfb.planes, cid, slot),
                                               tf2._feature_sums(feat, tfb.planes, cid, slice(0, c)))):
        assert torch.equal(s, ref) and torch.equal(s, whole[rows, slot])
        _, r0, r1 = tf2.MXU_ROWS[g]
        f64 = feat[:, r0:r1].double() * tfb.planes[cid, r0:r1, g * c + slot].double()
        np.testing.assert_allclose(a.numpy(), f64.abs().sum(1).numpy(), rtol=10 * 2.0**-24, atol=0)
        assert (a > 0).all()


def test_slot_sums_clamp_missing_winners(soup):
    """A negative cluster or slot (no winner) reads slot 0 of cluster 0."""
    accels, o, d, *_ = soup
    _, tfb = accels["bf16"]
    to, td = torch.as_tensor(o[:4]), torch.as_tensor(d[:4])
    neg = torch.full((4,), -1)
    zero = torch.zeros(4, dtype=torch.int64)
    got = tf2.mxu_slot_sums(to, td, tfb, neg, neg)
    want = tf2.mxu_slot_sums(to, td, tfb, zero, zero)
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1], want[0] + want[1]))
