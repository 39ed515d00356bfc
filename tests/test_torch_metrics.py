"""The port's observability (``render/metrics.py``) against the JAX package's
(tests/test_metrics.py): live rays per bounce exactly JAX's, gradient norms
within 1e-6, and a ``torch.profiler`` trace holding the renderers' ranges
(the registry of ranges: tests/test_torch_spans.py)."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models.scene import RenderSettings
from owl_path_tracer_tpu.render import diff as jdiff
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import integrator as jint
from owl_path_tracer_tpu.render import metrics as jmetrics
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.render import diff as tdiff
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator as tint
from owl_path_tracer_tpu_torch.render import metrics as tmetrics
from test_diff import SETTINGS
from test_integrator import sphere_scene
from test_torch_diff import pixels, sphere, tpx
from test_torch_film import _port_settings
from test_torch_scene import as_numpy

torch.set_num_threads(2)


@pytest.mark.parametrize("depth", [5, 2])
def test_wavefront_stats_match_jax(depth):
    """tests/test_metrics.py's sphere (roughness 1, a white environment): the
    live rays entering each bounce are JAX's, exactly."""
    js = sphere_scene(jmat.single(roughness=1.0))
    s = RenderSettings(width=16, height=16, max_samples=1, max_path_depth=depth, environment_color=(1, 1, 1),
                       environment_intensity=1.0)
    px = jfilm._pixel_grid(16, 16)
    want = jmetrics.wavefront_stats(js, s, jnp.asarray(px), jint.make_brute_intersector(js))
    ts = convert.scene_from_numpy(as_numpy(js), device="cpu")
    got = tmetrics.wavefront_stats(ts, _port_settings(s), tpx(px), tint.make_brute_intersector(ts))
    np.testing.assert_array_equal(got.live_per_bounce, np.asarray(want.live_per_bounce))
    assert got.live_per_bounce[0] == 256 and got.total_rays == want.total_rays
    np.testing.assert_allclose(got.occupancy, want.occupancy)
    assert got.mean_path_length == pytest.approx(want.mean_path_length)
    assert json.loads(got.to_json()) == json.loads(want.to_json())


def test_grad_norms_match_jax():
    """On tests/test_metrics.py's default material, and on the sphere's
    material gradients (JAX's gradients carried across, so the norms are of
    the same numbers)."""
    norms = tmetrics.grad_norms(tmat.single(device="cpu"))
    assert set(norms) == {f.name for f in dataclasses.fields(tmat.Materials)}
    want = jmetrics.grad_norms(jmat.single())
    assert norms == pytest.approx(want, abs=1e-6) and norms["roughness"] == 0.5

    js, _ = sphere()
    _, g = jdiff.loss_and_grad(js, js.materials, SETTINGS, jnp.asarray(pixels()), jnp.zeros((256, 3)), 2, None)
    got = tmetrics.grad_norms(convert.materials_from_numpy(as_numpy(g), device="cpu"))
    want = jmetrics.grad_norms(g)
    assert got["base_color"] > 0
    for name, value in want.items():
        assert got[name] == pytest.approx(value, abs=1e-6, rel=1e-6), name


def test_profile_trace_records_the_ranges(tmp_path):
    """A Chrome trace with the intersect / shade / film ranges of a scan
    render and a gradient; nothing at all for log_dir=None."""
    _, ts = sphere()
    s = _port_settings(SETTINGS)
    accel = tfilm.make_accel(ts, "cluster", cluster_size=64)
    with tmetrics.profile_trace(str(tmp_path / "trace")) as prof:
        tfilm.render_image(ts, s, spp=1, pixel_chunk=256, accel=accel)
        tdiff.loss_and_grad(ts, ts.materials, s, tpx(pixels()[:64]), torch.zeros((64, 3)), 1, accel)
    names = {e.key for e in prof.key_averages()}
    assert {"owlpt.intersect", "owlpt.shade", "owlpt.film"} <= names
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "owlpt.shade" in traces[0].read_text()

    with tmetrics.profile_trace(None) as prof:
        tfilm.render_image(ts, s, spp=1, pixel_chunk=256, accel=accel)
    assert prof is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trace"]  # only the first block's trace


def test_nee_shadow_tests_are_profiled(tmp_path):
    """With use_nee the shadow tests carry ``owlpt.occlude``."""
    _, ts = sphere(emission=0.0)
    s = dataclasses.replace(_port_settings(SETTINGS), use_nee=True)
    emissive = dataclasses.replace(ts.materials, emission=torch.tensor([1.0]))
    ts = dataclasses.replace(ts, materials=emissive, emissive_tris=torch.arange(4, dtype=torch.int32))
    with tmetrics.profile_trace(str(tmp_path)) as prof:
        tdiff.render_with_materials(ts, ts.materials, s, tpx(pixels()[:64]), 1, None)
    assert "owlpt.occlude" in {e.key for e in prof.key_averages()}
