"""The NEE slice as a whole: the port's ``render_image_wavefront(use_nee=True)``
vs the JAX package's (fused2, component planes, Pallas in interpret mode,
scatter film), in both forms -- separate (``fused_nee=False``: closest-hit
then any-hit sweeps) and deferred (``fused_nee=True``: one mixed sweep).

Both packages seed every path from its (pixel, sample) work id, so the images
compare pixel by pixel under the golden rule of tests/test_golden.py (more
than 99.5% of pixels isclose(rtol=1e-4, atol=1e-5), means within rtol 1e-3),
with ray counts within 0.5%.  The port's deferred form must equal its own
separate form (rtol 1e-4 / atol 1e-5, equal ray counts), zombies included.
"""
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import wavefront as twf
from test_nee import box_with_light
from test_torch_integrator import ASSETS
from test_torch_integrator_nee import sun_sphere
from test_torch_scene import as_numpy

torch.set_num_threads(2)

SIZE = 16


def _scenes(name):
    if name == "cornell-box":
        js = jscene.compile_scene(ASSETS, name, (SIZE, SIZE), env_map_path=None)
    else:
        js = {"box_with_light": box_with_light, "sun_sphere": sun_sphere}[name]()
    return js, convert.scene_from_numpy(as_numpy(js), device="cpu")


def _settings(name, **kw):
    base = dict(width=SIZE, height=SIZE, max_samples=4, max_path_depth=3, use_nee=True)
    if name == "sun_sphere":
        return jscene.RenderSettings(**base, environment_use=True, **kw)
    return jscene.RenderSettings(**base, environment_intensity=0.0, environment_color=(0, 0, 0), **kw)


def _golden(img, rays, want, rays_want):
    assert img.shape == want.shape and np.isfinite(img).all()
    assert want.mean() > 0.0
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want, (rays, rays_want)


def check_nee_render(name, fused_nee, sort):
    """Port vs JAX frame for one scene and form (the cornell-box cases run
    from tests/test_torch_wavefront_nee_cornell.py, so that each file stays
    short on one test worker)."""
    js, ts = _scenes(name)
    settings = _settings(name)
    want, rays_want = jwf.render_image_wavefront(
        js, settings, accel=jf2.build_fused2_scene(js, mxu=False), lanes=512,
        film_mode="scatter", fused2_sort=sort, fused_nee=fused_nee,
    )
    img, rays = twf.render_image_wavefront(
        ts, settings, tf2.build_fused2_scene(ts, cluster_size=512, mxu=False), lanes=512,
        fused2_sort=sort, fused_nee=fused_nee,
    )
    _golden(img.numpy(), rays, want, rays_want)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("fused_nee", [False, True])
def test_nee_render_matches_jax(fused_nee, sort):
    check_nee_render("box_with_light", fused_nee, sort)


def test_env_nee_render_matches_jax():
    """Environment NEE (CDF sampling of a sun map) on a sphere; ``fused_nee``
    falls back to the separate form there, as in the JAX package."""
    js, ts = _scenes("sun_sphere")
    settings = _settings("sun_sphere")
    want, rays_want = jwf.render_image_wavefront(
        js, settings, accel=jf2.build_fused2_scene(js, mxu=False), lanes=512, film_mode="scatter",
    )
    accel = tf2.build_fused2_scene(ts, mxu=False)
    img, rays = twf.render_image_wavefront(ts, settings, accel, lanes=512)
    _golden(img.numpy(), rays, want, rays_want)
    img_f, rays_f = twf.render_image_wavefront(ts, settings, accel, lanes=512, fused_nee=True)
    np.testing.assert_array_equal(img_f.numpy(), img.numpy())
    assert rays_f == rays


def test_deferred_equals_separate_with_zombies():
    """Depth 8: Russian roulette (depth > 3) kills paths at a vertex that
    just made a pending shadow ray -- the zombie lanes of the deferred form,
    which bank one step late.  The image equals the separate form's, and the
    frame drains: at the end no lane is alive and no shadow ray is pending."""
    _, ts = _scenes("box_with_light")
    settings = jscene.RenderSettings(width=12, height=12, max_samples=12, max_path_depth=8,
                                     environment_intensity=0.0, environment_color=(0, 0, 0),
                                     use_nee=True)
    accel = tf2.build_fused2_scene(ts, cluster_size=64, mxu=False)
    img_sep, rays_sep = twf.render_image_wavefront(ts, settings, accel, lanes=512, iters_per_launch=4)
    img_fused, rays_fused = twf.render_image_wavefront(ts, settings, accel, lanes=512,
                                                       iters_per_launch=4, fused_nee=True)
    assert rays_sep == rays_fused
    np.testing.assert_allclose(img_fused.numpy(), img_sep.numpy(), rtol=1e-4, atol=1e-5)

    # the same frame launch by launch: zombies occur, and all of them bank
    total = settings.width * settings.height * settings.max_samples
    lights = twf.build_light_table(ts)
    st = twf.new_pool(settings, 512, device="cpu")
    zombies = 0
    for _ in range(200):
        st, status = twf._run_chunk(ts, settings, st, accel, False, total, 1, lights=lights,
                                    fused_nee=True)
        zombies += int((~st.alive & st.sh_active).sum())
        work_done, busy = status.tolist()
        if work_done and not busy:
            break
    assert work_done and not busy and zombies > 0
    assert not st.alive.any() and not st.sh_active.any()
    np.testing.assert_allclose(st.acc.reshape(12, 12, 3).flip(0).numpy() / settings.max_samples,
                               img_sep.numpy(), rtol=1e-4, atol=1e-5)
