"""The scan renderer of the port (``render/film.py``, ``integrator.trace_paths``
/ ``sample_sum``) on the ``cluster`` and ``fused`` accelerators, against the
committed goldens and against the JAX package.

Images are held to the golden rule of tests/test_golden.py: more than 99.5%
of pixels isclose(rtol=1e-4, atol=1e-5) and the means within rtol 1e-3.  The
port is not bit-equal to the goldens (which the JAX package's cluster
renderer reproduces bitwise): the BSDF's transcendentals differ between the
frameworks in the last bits, so 136 (cornell-box), 1617 (sphere) and 1361
(cube) of the 6912 values differ, every pixel of sphere and cube and 99.96%
of cornell-box's within the rule.  ``fused`` and ``cluster`` find the same
winners, so their images are equal bit for bit.
"""
import pathlib

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops.cluster import ClusterBVH
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator as tint
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.utils.parser import CameraDesc
from test_golden import CONFIGS
from test_integrator import make_sphere_mesh

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"


def _port_settings(s: jscene.RenderSettings) -> tscene.RenderSettings:
    import dataclasses

    return tscene.RenderSettings(**{f.name: getattr(s, f.name) for f in dataclasses.fields(tscene.RenderSettings)})


def assert_golden_rule(img, want, what=""):
    assert img.shape == want.shape and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"{what}: only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3, err_msg=what)


@pytest.fixture(scope="module")
def golden_renders():
    """Each golden config rendered by the port on cluster and fused (C=64), once."""
    cache = {}

    def render(config, kind):
        if (config, kind) not in cache:
            name, settings = CONFIGS[config]
            s = _port_settings(settings)
            scene = tscene.compile_scene(ASSETS, name, (s.width, s.height), device="cpu")
            accel = tfilm.make_accel(scene, kind, cluster_size=64)
            cache[config, kind] = tfilm.render_image(scene, s, pixel_chunk=4096, accel=accel).numpy()
        return cache[config, kind]

    return render


@pytest.mark.parametrize("kind", ["cluster", "fused"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_golden_image(golden_renders, config, kind):
    assert_golden_rule(golden_renders(config, kind), np.load(GOLDENS / f"{config}.npy"), f"{config} {kind}")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fused_image_equals_cluster_image(golden_renders, config):
    np.testing.assert_array_equal(golden_renders(config, "fused"), golden_renders(config, "cluster"))


def _sphere_scene(size):
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = tcam.make_camera(CameraDesc(look_from=(3, 0, 0), look_at=(0, 0, 0), look_up=(0, 1, 0), vertical_fov=45),
                           (size, size), device="cpu")
    mat = tmat.single(device="cpu", base_color=(0.7, 0.5, 0.3), roughness=0.8)
    return tscene.scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n, device="cpu")


def test_progressive_equals_one_shot():
    """3 + 5 samples through add_samples equal 8 in one shot up to float32
    summation order (tests/test_integrator.py::test_checkpoint_resume_matches_one_shot);
    the carried LCG streams and the ray counts are exact."""
    scene = _sphere_scene(16)
    s = tscene.RenderSettings(width=16, height=16, max_samples=8, max_path_depth=3,
                              environment_color=(1, 1, 1), environment_intensity=0.7)
    accel = tfilm.make_accel(scene, "fused", cluster_size=64)
    one = tfilm.add_samples(scene, s, tfilm.new_film(s, device="cpu"), 8, pixel_chunk=128, accel=accel)
    film = tfilm.new_film(s, device="cpu")
    film = tfilm.add_samples(scene, s, film, 3, pixel_chunk=128, accel=accel)
    film = tfilm.add_samples(scene, s, film, 5, pixel_chunk=128, accel=accel)
    np.testing.assert_allclose(tfilm.finalize(film).numpy(), tfilm.finalize(one).numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(film.rng, one.rng) and film.spp_done == one.spp_done == 8
    assert film.rays_traced == one.rays_traced > 8 * 256


def test_a_short_last_chunk_counts_only_its_pixels():
    """A frame whose last chunk is short (256 pixels in chunks of 96) against
    the same frame in one chunk: the same image, stream and live rays.  (The
    JAX package pads the last chunk with copies of the last pixel and counts
    their rays too.)"""
    scene = _sphere_scene(16)
    s = tscene.RenderSettings(width=16, height=16, max_samples=1, max_path_depth=3,
                              environment_color=(1, 1, 1), environment_intensity=0.7)
    accel = tfilm.make_accel(scene, "fused", cluster_size=64)
    whole = tfilm.add_samples(scene, s, tfilm.new_film(s, device="cpu"), 1, pixel_chunk=256, accel=accel)
    short = tfilm.add_samples(scene, s, tfilm.new_film(s, device="cpu"), 1, pixel_chunk=96, accel=accel)
    assert torch.equal(short.acc, whole.acc) and torch.equal(short.rng, whole.rng)
    assert short.rays_traced == whole.rays_traced > 256


@pytest.fixture(scope="module")
def short_chunk_jax():
    """cornell-box at 16x16 through the JAX package's scan renderer, in one
    chunk and in chunks of 96 (the last one 64 pixels, padded by 32 copies of
    the last pixel)."""
    js = jscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_auto=True)
    jsc = jscene.compile_scene(ASSETS, "cornell-box", (16, 16))
    accel = jfilm.make_accel(jsc, "cluster", cluster_size=64)
    whole = jfilm.add_samples(jsc, js, jfilm.new_film(js), 2, pixel_chunk=256, accel=accel)
    padded = jfilm.add_samples(jsc, js, jfilm.new_film(js), 2, pixel_chunk=96, accel=accel)
    return js, whole, padded


@pytest.mark.parametrize("kind", ["cluster", "fused"])
def test_short_last_chunk_matches_jax(short_chunk_jax, kind):
    """A frame whose last chunk is short (16x16 in chunks of 96), port vs the
    JAX package on the same chunks: the image by the golden rule and the LCG
    streams equal.  The one intended difference is ``rays_traced``: the JAX
    package runs the short chunk padded with 32 copies of the last pixel and
    counts their rays, the port runs it at its own size.  So the port is held
    to the JAX count less the padded lanes' rays (the JAX package's own
    padded-less-whole difference: 32 copies of one path's rays)."""
    js, whole, padded = short_chunk_jax
    pad_rays = padded.rays_traced - whole.rays_traced
    assert pad_rays > 0 and pad_rays % 32 == 0
    s = _port_settings(js)
    sc = tscene.compile_scene(ASSETS, "cornell-box", (16, 16), device="cpu")
    got = tfilm.add_samples(sc, s, tfilm.new_film(s, device="cpu"), 2, pixel_chunk=96,
                            accel=tfilm.make_accel(sc, kind, cluster_size=64))
    assert_golden_rule(tfilm.finalize(got).numpy(), jfilm.finalize(padded), f"short last chunk on {kind}")
    np.testing.assert_array_equal(got.rng.numpy(), padded.rng.astype(np.int64))
    want_rays = padded.rays_traced - pad_rays
    assert abs(got.rays_traced - want_rays) <= 0.005 * want_rays


def test_nee_scan_render_matches_jax():
    """use_nee=True through the scan renderer on cluster (the occlusion path
    of the scan renderer), port vs JAX package."""
    js = jscene.RenderSettings(width=32, height=32, max_samples=2, max_path_depth=3, environment_auto=True,
                               use_nee=True)
    jsc = jscene.compile_scene(ASSETS, "cornell-box", (32, 32), env_map_path=None)
    want = jfilm.add_samples(jsc, js, jfilm.new_film(js), 2, pixel_chunk=1024,
                             accel=jfilm.make_accel(jsc, "cluster", cluster_size=64))
    s = _port_settings(js)
    sc = tscene.compile_scene(ASSETS, "cornell-box", (32, 32), env_map_path=None, device="cpu")
    got = tfilm.add_samples(sc, s, tfilm.new_film(s, device="cpu"), 2, pixel_chunk=1024,
                            accel=tfilm.make_accel(sc, "cluster", cluster_size=64))
    assert_golden_rule(tfilm.finalize(got).numpy(), jfilm.finalize(want), "NEE scan")
    assert abs(got.rays_traced - want.rays_traced) <= 0.005 * want.rays_traced
    np.testing.assert_array_equal(got.rng.numpy(), want.rng.astype(np.int64))


def test_wavefront_on_cluster_matches_jax():
    js = jscene.RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3, environment_auto=True)
    jsc = jscene.compile_scene(ASSETS, "cornell-box", (32, 32))
    want, rays_want = jwf.render_image_wavefront(jsc, js, accel=jfilm.make_accel(jsc, "cluster", cluster_size=64),
                                                 lanes=1024, film_mode="scatter")
    sc = tscene.compile_scene(ASSETS, "cornell-box", (32, 32), device="cpu")
    img, rays = twf.render_image_wavefront(sc, _port_settings(js), tfilm.make_accel(sc, "cluster", cluster_size=64),
                                           lanes=1024)
    assert_golden_rule(img.numpy(), np.asarray(want), "wavefront on cluster")
    assert abs(rays - rays_want) <= 0.005 * rays_want


@pytest.mark.parametrize("kind", ["cluster", "fused"])
def test_render_pixels_matches_jax(kind):
    """``integrator.render_pixels`` on a chunk of the textured cube's pixels
    (the shade-blob fetch with a texture lookup), port vs JAX package on the
    cluster accelerator, by the golden rule."""
    import jax.numpy as jnp

    from owl_path_tracer_tpu.render import integrator as jint

    js = jscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_auto=True)
    jsc = jscene.compile_scene(ASSETS, "cube", (16, 16))
    assert jfilm.scene_has_textures(jsc)
    jisect, _ = jint.make_intersectors(jsc, jfilm.make_accel(jsc, "cluster", cluster_size=64))
    px = jfilm._pixel_grid(16, 16)[64:192]
    want = np.asarray(jint.render_pixels(jsc, js, jnp.asarray(px), jisect, True))
    sc = tscene.compile_scene(ASSETS, "cube", (16, 16), device="cpu")
    tisect, _ = tint.make_intersectors(sc, tfilm.make_accel(sc, kind, cluster_size=64))
    got = tint.render_pixels(sc, _port_settings(js), torch.as_tensor(px, dtype=torch.int64), tisect, True)
    assert got.shape == (128, 3) and float(got.max()) > 0
    assert_golden_rule(got.numpy(), want, f"render_pixels on {kind}")


def test_make_accel_defaults_to_cluster():
    """As in the JAX package (``make_accel(scene, kind="cluster")``)."""
    sc = tscene.compile_scene(ASSETS, "cube", (8, 8), device="cpu")
    accel = tfilm.make_accel(sc)
    assert isinstance(accel, ClusterBVH) and accel.cluster_size == 128


@pytest.mark.parametrize("kind", ["cluster", "fused"])
def test_deferred_nee_without_mixed_kernel_takes_separate_form(kind):
    """make_mixed_sweep_fn returns None for accelerators without a mixed
    kernel, so ``fused_nee=True`` renders exactly the separate form."""
    sc = tscene.compile_scene(ASSETS, "cornell-box", (16, 16), env_map_path=None, device="cpu")
    accel = tfilm.make_accel(sc, kind, cluster_size=64)
    assert tint.make_mixed_sweep_fn(accel) is None
    s = tscene.RenderSettings(width=16, height=16, max_samples=1, max_path_depth=3, environment_auto=True,
                              use_nee=True)
    sep, rays_sep = twf.render_image_wavefront(sc, s, accel, lanes=256, fused_nee=False)
    dfr, rays_dfr = twf.render_image_wavefront(sc, s, accel, lanes=256, fused_nee=True)
    assert torch.equal(sep, dfr) and rays_sep == rays_dfr > 0
