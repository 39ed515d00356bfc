"""The port's per-ray-stack BVH (``ops/bvh.py``, ``ops/traverse.py``,
``render/film.py::build_scene_bvh``, ``make_accel("bvh")``) against the JAX
package's and against the port's own exact intersectors.

Tolerances (ROADMAP's port rules): the builds' arrays equal; triangle ids,
t, u and v bit for bit against the JAX traversal run eagerly
(``jax.disable_jit``: every Moller-Trumbore operation on its own, as the
port does; XLA's jitted loop fuses the chain and rounds t/u/v an ulp or two
away, 9.5e-7 absolute on the 50-triangle soup), and bit for bit against the
port's brute sweep and cluster query; occlusion flags exact.  The port's
``bvh`` images equal its ``cluster`` and ``brute`` images bit for bit and
meet the golden rule against the committed goldens: like the port's other
scan images (``tests/test_torch_film.py``) they are not the goldens' bits,
because the BSDF's transcendentals differ between the frameworks in the
last bits.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.ops import bvh as jbvh
from owl_path_tracer_tpu.ops import traverse as jtr
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import bvh as tbvh
from owl_path_tracer_tpu_torch.ops import intersect as tint
from owl_path_tracer_tpu_torch.ops import traverse as ttr
from owl_path_tracer_tpu_torch.ops.cluster import cluster_closest_hit, cluster_occluded
from owl_path_tracer_tpu_torch.render import diff as tdiff
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.utils import obj as tobj
from test_bvh import random_rays, random_tris
from test_golden import CONFIGS
from test_torch_brute import _scene_rays
from test_torch_film import GOLDENS, _port_settings, assert_golden_rule

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


def _cornell():
    v_list, i_list, base = [], [], 0
    for _, mesh in tobj.load_obj(ASSETS / "cornell-box.obj.scene"):
        v_list.append(mesh.vertices)
        i_list.append(mesh.indices + base)
        base += len(mesh.vertices)
    return np.concatenate(v_list), np.concatenate(i_list)


def _soup(name):
    """tests/test_bvh.py's geometries -> (vertices, indices, rays o, d)."""
    if name == "small":
        v, i = random_tris(50)
    elif name == "medium":
        v, i = random_tris(3000, seed=5)
    elif name == "cornell":
        v, i = _cornell()
        r = np.random.default_rng(3)
        d = r.normal(size=(512, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return v, i, np.tile(np.array([1.0, 1.0, 0.0], np.float32), (512, 1)), d
    else:  # a triangle and a degenerate one
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]], np.float32)
        i = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        return v, i, np.array([[0.2, 0.2, 1.0], [2.0, 2.0, 1.0]], np.float32), \
            np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    o, d = random_rays(512, 7)
    return v, i, np.asarray(o), np.asarray(d)


SOUPS = ["small", "medium", "cornell", "single_and_degenerate"]


@pytest.mark.parametrize("name", SOUPS)
def test_build_bvh_equals_jax(name):
    v, i, _, _ = _soup(name)
    want = jbvh.build_bvh(v, i)
    got = tbvh.build_bvh(v, i)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    tbvh.validate_bvh(got, v, i)


def test_validate_bvh_catches_a_broken_tree():
    v, i, _, _ = _soup("medium")
    good = tbvh.build_bvh(v, i)
    order = good.tri_order.copy()
    order[0] = order[1]  # a triangle in two leaves, another in none
    with pytest.raises(AssertionError, match="permutation"):
        tbvh.validate_bvh(good._replace(tri_order=order), v, i)
    nmax = good.node_max.copy()
    nmax[-1] -= 1.0  # a leaf box that no longer bounds its triangles
    with pytest.raises(AssertionError):
        tbvh.validate_bvh(good._replace(node_max=nmax), v, i)


@pytest.mark.parametrize("name", SOUPS)
def test_closest_hit_matches_jax_and_brute(name):
    v, i, o, d = _soup(name)
    with jax.disable_jit():
        want = jtr.bvh_closest_hit(jnp.asarray(o), jnp.asarray(d), jtr.device_bvh(jbvh.build_bvh(v, i), v, i))
    dev_bvh = ttr.device_bvh(tbvh.build_bvh(v, i), v, i, device="cpu")
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = ttr.bvh_closest_hit(to, td, dev_bvh)
    brute = tint.closest_hit_brute(to, td, torch.as_tensor(v), torch.as_tensor(i))
    assert (got.tri >= 0).any()
    for field in ("tri", "t", "uv"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
        assert torch.equal(getattr(got, field), getattr(brute, field)), field


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar", "per_ray"])
def test_any_hit_matches_jax_and_brute(per_ray):
    """tests/test_bvh.py::test_any_hit_matches_brute's soup; per-ray windows too."""
    v, i = random_tris(500, seed=11)
    o, d = (np.asarray(x) for x in random_rays(512, seed=13))
    t_max = np.random.default_rng(2).uniform(0.5, 8.0, 512).astype(np.float32) if per_ray else 5.0
    want = np.asarray(jtr.bvh_occluded(jnp.asarray(o), jnp.asarray(d), jtr.device_bvh(jbvh.build_bvh(v, i), v, i),
                                       t_max=jnp.asarray(t_max)))
    tm = torch.as_tensor(t_max)
    got = ttr.bvh_occluded(torch.as_tensor(o), torch.as_tensor(d),
                           ttr.device_bvh(tbvh.build_bvh(v, i), v, i, device="cpu"), t_max=tm)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got.numpy(), want)
    brute = tint.any_hit_brute(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(v), torch.as_tensor(i),
                               t_max=tm)
    assert torch.equal(got, brute)


def test_overflowing_stack_drops_pushes_as_jax():
    """A stack of depth 2 cannot hold the walk: pushes beyond it are dropped,
    in the JAX package's order, so both lose the same subtrees."""
    v, i, o, d = _soup("medium")
    jb, tb = jbvh.build_bvh(v, i), tbvh.build_bvh(v, i)
    with jax.disable_jit(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "STACK_DEPTH", 2)
        mp.setattr(ttr, "STACK_DEPTH", 2)
        want = jtr.bvh_closest_hit(jnp.asarray(o), jnp.asarray(d), jtr.device_bvh(jb, v, i))
        got = ttr.bvh_closest_hit(torch.as_tensor(o), torch.as_tensor(d), ttr.device_bvh(tb, v, i, device="cpu"))
    full = ttr.bvh_closest_hit(torch.as_tensor(o), torch.as_tensor(d), ttr.device_bvh(tb, v, i, device="cpu"))
    assert (got.tri != full.tri).any()  # the shallow stack did lose hits
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bvh_equals_cluster_and_brute_on_golden_rays(config, tmp_path):
    """Bit for bit (tri, t, u, v) on the golden configs' primary and bounce-like rays."""
    sc, o, d = _scene_rays(config)
    bvh = tfilm.build_scene_bvh(sc, cache_dir=tmp_path)
    got = ttr.bvh_closest_hit(o, d, bvh)
    cb = tfilm.make_accel(sc, "cluster", cluster_size=64)
    assert (got.tri >= 0).sum() > 600
    for want in (cluster_closest_hit(o, d, cb), tint.closest_hit_brute(o, d, sc.vertices, sc.tri_idx)):
        for field in ("tri", "t", "uv"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    t_max = torch.full((o.shape[0],), 2.0)
    assert torch.equal(ttr.bvh_occluded(o, d, bvh, t_max=t_max), cluster_occluded(o, d, cb, t_max=t_max))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bvh_image_equals_cluster_image_and_golden(config):
    """``render_image`` on ``make_accel("bvh")``: the cluster and brute images
    bit for bit, and the golden rule against the committed golden."""
    name, settings = CONFIGS[config]
    s = _port_settings(settings)
    sc = tscene.compile_scene(ASSETS, name, (s.width, s.height), device="cpu")
    accel = tfilm.make_accel(sc, "bvh")
    assert isinstance(accel, ttr.DeviceBVH)
    img = tfilm.render_image(sc, s, pixel_chunk=4096, accel=accel).numpy()
    cluster = tfilm.render_image(sc, s, pixel_chunk=4096, accel=tfilm.make_accel(sc, "cluster", cluster_size=64))
    np.testing.assert_array_equal(img, cluster.numpy())
    assert_golden_rule(img, np.load(GOLDENS / f"{config}.npy"), f"{config} bvh")


def test_cache_roundtrip(tmp_path):
    """tests/test_bvh.py::test_cache_roundtrip in the port's cache: one file
    per geometry, read back equal; a second geometry makes a second file."""
    v, i = random_tris(100, seed=17)
    b1 = tbvh.build_bvh_cached(v, i, cache_dir=tmp_path)
    b2 = tbvh.build_bvh_cached(v, i, cache_dir=tmp_path)
    for field in b1._fields:
        np.testing.assert_array_equal(getattr(b1, field), getattr(b2, field))
    assert len(list(tmp_path.glob("*.npz"))) == 1
    tbvh.validate_bvh(b2, v, i)
    tbvh.build_bvh_cached(*random_tris(100, seed=18), cache_dir=tmp_path)
    assert len(list(tmp_path.glob("*.npz"))) == 2


def test_make_intersectors_dispatches_bvh(tmp_path):
    sc, o, d = _scene_rays("cube")
    bvh = tfilm.build_scene_bvh(sc, cache_dir=tmp_path)
    isect, occlude = integrator.make_intersectors(sc, bvh)
    rec, want = isect(o, d), ttr.bvh_closest_hit(o, d, bvh)
    assert (rec.tri >= 0).any() and torch.equal(rec.tri, want.tri) and torch.equal(rec.t, want.t)
    dist = torch.full((o.shape[0],), 1.5)
    assert torch.equal(occlude(o, d, dist), ttr.bvh_occluded(o, d, bvh, t_max=dist))


@pytest.mark.parametrize("use_nee", [False, True], ids=["bsdf", "nee"])
def test_wavefront_on_bvh_equals_cluster(use_nee, tmp_path):
    s = tscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, use_nee=use_nee,
                              environment_intensity=0.0 if use_nee else 1.0, environment_auto=not use_nee)
    name = "cornell-box" if use_nee else "cube"
    sc = tscene.compile_scene(ASSETS, name, (16, 16), device="cpu")
    img, rays = twf.render_image_wavefront(sc, s, tfilm.build_scene_bvh(sc, cache_dir=tmp_path), lanes=256)
    want, rays_want = twf.render_image_wavefront(sc, s, tfilm.make_accel(sc, "cluster", cluster_size=64),
                                                 lanes=256)
    assert torch.equal(img, want) and rays == rays_want > 0


def test_gradients_through_bvh_equal_brute(tmp_path):
    """Material and camera gradients on the bvh equal the brute sweep's bit
    for bit: both refit the winner's Moller-Trumbore on the live rays."""
    s = tscene.RenderSettings(width=8, height=8, max_samples=2, max_path_depth=2, environment_auto=True)
    sc = tscene.compile_scene(ASSETS, "cornell-box", (8, 8), device="cpu")
    px = tfilm._pixel_grid(8, 8, "cpu")
    target = torch.zeros((64, 3))
    bvh = tfilm.build_scene_bvh(sc, cache_dir=tmp_path)
    for fn, arg in ((tdiff.loss_and_grad, sc.materials), (tdiff.camera_loss_and_grad, sc.camera)):
        loss_b, g_b = fn(sc, arg, s, px, target, 2, bvh)
        loss_w, g_w = fn(sc, arg, s, px, target, 2, None)
        assert torch.equal(loss_b, loss_w)
        for f in type(arg).__dataclass_fields__:
            assert torch.equal(getattr(g_b, f), getattr(g_w, f)), f
    assert float(g_b.origin.abs().sum()) > 0  # the camera gradient is not trivially zero
