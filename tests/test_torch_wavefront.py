"""The slice as a whole: the port's ``render_image_wavefront`` vs the JAX
package's (fused2, component planes, Pallas in interpret mode, scatter film).

Both seed every path from its (pixel, sample) work id, so the images compare
pixel by pixel.  They pass the golden rule of tests/test_golden.py (more than
99.5% of pixels isclose(rtol=1e-4, atol=1e-5), means within rtol 1e-3), and
the ray counts agree within 0.5%.
"""
import pathlib

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.utils.parser import CameraDesc
from test_integrator import make_sphere_mesh, sphere_scene

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
SETTINGS = jscene.RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3,
                                 environment_auto=True)


def _scenes(name):
    if name == "sphere":
        js = sphere_scene(jmat.single())
        v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
        cam = tcam.make_camera(CameraDesc(look_from=(3, 0, 0), look_at=(0, 0, 0), look_up=(0, 1, 0),
                                          vertical_fov=45), (32, 32), device="cpu")
        ts = tscene.scene_from_arrays(v, idx, tmat.single(device="cpu"), np.zeros(len(idx), np.int32),
                                      cam, normals=n, device="cpu")
        return js, ts
    return (jscene.compile_scene(ASSETS, name, (32, 32)),
            tscene.compile_scene(ASSETS, name, (32, 32), device="cpu"))


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("name", ["sphere", "cornell-box"])
def test_render_matches_jax(name, sort):
    js, ts = _scenes(name)
    want, rays_want = jwf.render_image_wavefront(
        js, SETTINGS, accel=jf2.build_fused2_scene(js, mxu=False), lanes=1024,
        film_mode="scatter", fused2_sort=sort,
    )
    img, rays = twf.render_image_wavefront(
        ts, SETTINGS, tf2.build_fused2_scene(ts, cluster_size=512, mxu=False), lanes=1024,
        fused2_sort=sort,
    )
    img = img.numpy()
    assert img.shape == want.shape and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want, (rays, rays_want)
