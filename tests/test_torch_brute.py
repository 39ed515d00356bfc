"""The port's brute sweep (``ops/intersect.py::closest_hit_brute`` /
``any_hit_brute``, ``integrator.make_intersectors(scene, None)``,
``make_accel("brute")``) against the JAX package's and against the port's
own cluster query.

Tolerances (ROADMAP's port rules): triangle ids and occlusion flags exact,
t/u/v to rtol 5e-6 with tests/test_fused2.py::test_matches_cluster_exact's
floors (atol 1e-7 on t, 1e-6 on u/v), against the JAX sweep run eagerly
(``jax.disable_jit``), which evaluates each Moller-Trumbore operation on its
own as the port does (they agree bit for bit).  XLA's jitted sweep fuses the
chain and rounds it otherwise: on the soup it moves u/v of 2 of 512 rays by
up to 2.8e-5 relative (2.8e-6 absolute), where eager JAX equals the port.  Brute and cluster read the same
float32 vertices through the same ``mt_components``, so against the cluster
query they agree bit for bit, and so do their images (as the JAX package's
brute and cluster images do, ``tests/test_golden.py``); both meet the golden
rule against the committed goldens.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from owl_path_tracer_tpu.ops import intersect as jint
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.models.camera import primary_rays
from owl_path_tracer_tpu_torch.ops import intersect as tint
from owl_path_tracer_tpu_torch.ops.cluster import cluster_closest_hit, cluster_occluded
from owl_path_tracer_tpu_torch.ops.traverse import DeviceBVH
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.utils import cli as tcli
from test_fused2 import _soup
from test_golden import CONFIGS
from test_torch_cli import SWEEP, _assets
from test_torch_film import GOLDENS, _port_settings, assert_golden_rule

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


@pytest.fixture(scope="module")
def soup():
    """3000 random triangles and 512 rays, half of them with a finite per-ray t_max."""
    verts, idx, r = _soup()
    n = 512
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    return verts, idx, o, d, tmax


@pytest.mark.parametrize("tri_chunk", [512, 700])
def test_closest_hit_brute_matches_jax(soup, tri_chunk):
    """700 leaves a short last chunk (the JAX package pads it with masked ids)."""
    verts, idx, o, d, _ = soup
    with jax.disable_jit():
        want = jint.closest_hit_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(idx),
                                      tri_chunk=tri_chunk)
    got = tint.closest_hit_brute(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(verts),
                                 torch.as_tensor(idx), tri_chunk=tri_chunk)
    assert (got.tri >= 0).sum() > 100  # the soup is hit
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), rtol=5e-6, atol=1e-6)


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar", "per_ray"])
def test_any_hit_brute_matches_jax(soup, per_ray):
    verts, idx, o, d, tmax = soup
    t_max = tmax if per_ray else np.float32(3.0)
    with jax.disable_jit():
        want = np.asarray(jint.any_hit_brute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts),
                                             jnp.asarray(idx), t_max=jnp.asarray(t_max) if per_ray else float(t_max)))
    got = tint.any_hit_brute(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(verts), torch.as_tensor(idx),
                             t_max=torch.as_tensor(t_max) if per_ray else float(t_max))
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_closest_hit_brute_per_ray_t_max(soup):
    """A per-ray t_max is the window of each ray: hits beyond it are misses
    with t = t_max, and the flags are any_hit_brute's."""
    verts, idx, o, d, tmax = soup
    args = [torch.as_tensor(a) for a in (o, d, verts, idx)]
    rec = tint.closest_hit_brute(*args, t_max=torch.as_tensor(tmax))
    assert torch.equal(rec.tri >= 0, tint.any_hit_brute(*args, t_max=torch.as_tensor(tmax)))
    miss = rec.tri < 0
    np.testing.assert_array_equal(rec.t[miss].numpy(), tmax[miss.numpy()])
    assert (rec.t[~miss] < torch.as_tensor(tmax)[~miss]).all()


def _scene_rays(config):
    """The config's scene and 4096 rays: the frame's primary rays and, from
    their hit points, rays in random directions (bounce-like rays that start
    on the surfaces)."""
    name, settings = CONFIGS[config]
    sc = tscene.compile_scene(ASSETS, name, (settings.width, settings.height), device="cpu")
    r = np.random.default_rng(1)
    px = torch.as_tensor(r.integers(0, settings.width, (2048, 2)))
    o, d = primary_rays(sc.camera, px, torch.as_tensor(r.random((2048, 2)), dtype=torch.float32),
                        (settings.width, settings.height))
    hit = tint.closest_hit_brute(o, d, sc.vertices, sc.tri_idx)
    o2 = o + hit.t.clamp(max=100.0)[:, None] * d
    d2 = torch.as_tensor(r.normal(size=(2048, 3)), dtype=torch.float32)
    d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    return sc, torch.cat([o, o2]), torch.cat([d, d2])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_brute_equals_cluster_bit_for_bit(config):
    sc, o, d = _scene_rays(config)
    cb = tfilm.make_accel(sc, "cluster", cluster_size=64)
    got = tint.closest_hit_brute(o, d, sc.vertices, sc.tri_idx)
    want = cluster_closest_hit(o, d, cb)
    assert (got.tri >= 0).sum() > 600
    for field in ("tri", "t", "uv"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    t_max = torch.full((o.shape[0],), 2.0)
    assert torch.equal(tint.any_hit_brute(o, d, sc.vertices, sc.tri_idx, t_max=t_max),
                       cluster_occluded(o, d, cb, t_max=t_max))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_brute_image_equals_cluster_image(config):
    """``render_image(intersector="brute")`` (make_accel -> None -> the brute
    sweep) on the golden configs: bit-equal to the cluster image, and the
    golden rule against the committed golden."""
    name, settings = CONFIGS[config]
    s = _port_settings(settings)
    sc = tscene.compile_scene(ASSETS, name, (s.width, s.height), device="cpu")
    brute = tfilm.render_image(sc, s, pixel_chunk=4096, intersector="brute").numpy()
    cluster = tfilm.render_image(sc, s, pixel_chunk=4096, accel=tfilm.make_accel(sc, "cluster", cluster_size=64))
    np.testing.assert_array_equal(brute, cluster.numpy())
    assert_golden_rule(brute, np.load(GOLDENS / f"{config}.npy"), f"{config} brute")


def test_make_accel_brute_is_none():
    """As in the JAX package (``film.py:132-133``); ``bvh`` (ported since)
    gives the per-ray-stack BVH, and an unknown kind raises."""
    sc = tscene.compile_scene(ASSETS, "cube", (8, 8), device="cpu")
    assert tfilm.make_accel(sc, "brute") is None
    assert isinstance(tfilm.make_accel(sc, "bvh"), DeviceBVH)
    with pytest.raises(ValueError, match="unknown intersector kind"):
        tfilm.make_accel(sc, "octree")


def test_make_intersectors_none_is_the_brute_pair():
    sc, o, d = _scene_rays("cube")
    isect, occlude = integrator.make_intersectors(sc, None, tri_chunk=4)
    rec = isect(o, d)
    want = tint.closest_hit_brute(o, d, sc.vertices, sc.tri_idx)
    assert isinstance(rec, tint.HitRecord) and (rec.tri >= 0).any()
    assert torch.equal(rec.tri, want.tri) and torch.equal(rec.t, want.t) and torch.equal(rec.uv, want.uv)
    dist = torch.full((o.shape[0],), 1.5)
    assert torch.equal(occlude(o, d, dist), tint.any_hit_brute(o, d, sc.vertices, sc.tri_idx, t_max=dist))


def test_wavefront_defaults_to_brute():
    """``render_image_wavefront(scene, settings)`` takes the brute sweep, as
    the JAX package's default ``accel=None`` does: the cluster frame bit for bit."""
    s = tscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_auto=True)
    sc = tscene.compile_scene(ASSETS, "cube", (16, 16), device="cpu")
    img, rays = twf.render_image_wavefront(sc, s, lanes=256)
    want, rays_want = twf.render_image_wavefront(sc, s, tfilm.make_accel(sc, "cluster", cluster_size=64), lanes=256)
    assert torch.equal(img, want) and rays == rays_want > 0


def test_cli_renders_with_brute(tmp_path):
    """``--intersector brute`` renders; its PNG is the cluster one."""
    work = _assets(tmp_path, {k: v for k, v in SWEEP.items() if k != "test"})
    pngs = {}
    for kind in ("brute", "cluster"):
        out = tcli.main(["--assets", str(work), "--out", str(tmp_path / kind), "--device", "cpu",
                         "--intersector", kind, "--cluster-size", "64", "--pixel-chunk", "256"])
        pngs[kind] = np.asarray(Image.open(out[0]))
    assert pngs["brute"].shape == (16, 16, 4) and pngs["brute"][..., :3].max() > 0
    np.testing.assert_array_equal(pngs["brute"], pngs["cluster"])

