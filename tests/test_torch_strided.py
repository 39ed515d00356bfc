"""The port's strided wavefront film (``render_image_wavefront(strided=True)``,
``new_pool(strided_pixels=)``) against its queue film and against the JAX
package's ``strided=True``.

tests/test_wavefront.py::test_strided_film_matches_global_queue's rule:
the same work items with the same streams, so the images agree to rtol 1e-5
/ atol 1e-6 (only the film's summation order differs) with equal ray
counts.  Against the JAX package: the golden rule and ray counts within
0.5%, as the port's other wavefront images (tests/test_torch_wavefront.py).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models.camera import make_camera as jcam
from owl_path_tracer_tpu.models.scene import RenderSettings as JSettings
from owl_path_tracer_tpu.models.scene import scene_from_arrays as jscene_from_arrays
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu.utils.parser import CameraDesc as JCameraDesc
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.utils.parser import CameraDesc
from test_integrator import make_sphere_mesh
from test_torch_film import assert_golden_rule

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
KW = dict(width=16, height=16, max_samples=4, max_path_depth=3, environment_color=(1, 0.9, 0.8),
          environment_intensity=1.0)
DESC = ((3, 0, 0), (0, 0, 0), (0, 1, 0), 45)


@pytest.fixture(scope="module")
def scenes():
    """tests/test_wavefront.py::test_strided_film_matches_global_queue's sphere in both packages."""
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    js = jscene_from_arrays(v, idx, jmat.single(base_color=(0.7, 0.5, 0.3), roughness=0.8),
                            np.zeros(len(idx), np.int32), jcam(JCameraDesc(*DESC), (16, 16)), normals=n)
    ts = tscene.scene_from_arrays(v, idx, tmat.single(device="cpu", base_color=(0.7, 0.5, 0.3), roughness=0.8),
                                  np.zeros(len(idx), np.int32),
                                  tcam.make_camera(CameraDesc(*DESC), (16, 16), device="cpu"), normals=n, device="cpu")
    return js, ts


@pytest.mark.parametrize("lanes", [256, 128], ids=["P1", "P2"])
def test_strided_film_matches_queue_and_jax(scenes, lanes):
    """lanes=256 divides 16*16*4 = 1024 work items into one pixel per lane,
    128 into two; lanes=1000 does not divide it: the queue film."""
    js, ts = scenes
    s = tscene.RenderSettings(**KW)
    img, rays = twf.render_image_wavefront(ts, s, lanes=lanes, iters_per_launch=4, strided=True)
    queue, rays_q = twf.render_image_wavefront(ts, s, lanes=1000, iters_per_launch=4)
    np.testing.assert_allclose(img.numpy(), queue.numpy(), rtol=1e-5, atol=1e-6)
    assert rays == rays_q > 16 * 16 * 4
    want, rays_j = jwf.render_image_wavefront(js, JSettings(**KW), lanes=lanes, iters_per_launch=4, strided=True)
    assert_golden_rule(img.numpy(), np.asarray(want), f"strided lanes={lanes} vs JAX")
    assert abs(rays - rays_j) <= 0.005 * rays_j


def test_strided_pool_layout_and_slices():
    """``new_pool(strided_pixels=P)``: acc [P,3,L], lane minor; each lane
    walks exactly its P * spp work items, and the film ends [L*P,3] in
    pixel order."""
    s = tscene.RenderSettings(**KW)
    st = twf.new_pool(s, 128, strided_pixels=2, device="cpu")
    assert st.acc.shape == (2, 3, 128) and st.work_local.shape == (128,)
    assert twf.new_pool(s, 128, device="cpu").acc.shape == (256, 3)


@pytest.mark.parametrize("fused_nee", [False, True], ids=["separate", "deferred"])
def test_strided_nee_matches_queue(fused_nee):
    """NEE in both forms on the cornell box (the deferred form's zombie lanes
    bank one step late, into their own slots), on the MXU fused2 layout's
    plain version."""
    s = tscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, use_nee=True,
                              environment_intensity=0.0, environment_color=(0, 0, 0))
    sc = tscene.compile_scene(ASSETS, "cornell-box", (16, 16), device="cpu")
    accel = tf2.build_fused2_scene(sc, cluster_size=512)
    kw = dict(lanes=256, iters_per_launch=4, fused2_sort=True, fused_nee=fused_nee)
    img, rays = twf.render_image_wavefront(sc, s, accel, strided=True, **kw)
    queue, rays_q = twf.render_image_wavefront(sc, s, accel, **kw)
    np.testing.assert_allclose(img.numpy(), queue.numpy(), rtol=1e-5, atol=1e-6)
    assert rays == rays_q and img.mean() > 0


def test_strided_film_refuses_work_map_and_checkpoints(scenes, tmp_path):
    _, ts = scenes
    s = tscene.RenderSettings(**KW)
    st = twf.new_pool(s, 256, strided_pixels=1, device="cpu")
    isect, _ = integrator.make_intersectors(ts, tfilm.make_accel(ts, "cluster", cluster_size=64))
    for kw in (dict(work_map=lambda ids: ids), dict(local_spp=2)):
        with pytest.raises(ValueError, match="strided film is incompatible"):
            twf.wavefront_step(ts, s, st, isect, False, 1024, **kw)
    with pytest.raises(ValueError, match="requires the queue film"):
        twf.render_image_wavefront(ts, s, lanes=256, strided=True, checkpoint_path=str(tmp_path / "f.ck"))
    # a frame whose work does not divide into the pool takes the queue film, which checkpoints
    img, _ = twf.render_image_wavefront(ts, s, lanes=300, iters_per_launch=2, strided=True,
                                        checkpoint_path=str(tmp_path / "g.ck"), checkpoint_every_s=0.0)
    assert (tmp_path / "g.ck").exists() and img.shape == (16, 16, 3)


def test_work_map_identity_leaves_the_step_unchanged(scenes):
    """The queue film with an identity ``work_map`` (the sharded "sample"
    split at world size 1) steps bit for bit as without one."""
    _, ts = scenes
    s = tscene.RenderSettings(**KW)
    isect, _ = integrator.make_intersectors(ts, tfilm.make_accel(ts, "cluster", cluster_size=64))
    a = twf.new_pool(s, 256, device="cpu")
    b = twf.new_pool(s, 256, device="cpu")
    for _ in range(6):
        a = twf.wavefront_step(ts, s, a, isect, False, 1024)
        b = twf.wavefront_step(ts, s, b, isect, False, 1024, work_map=lambda ids: ids, local_spp=4)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
