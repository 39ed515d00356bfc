"""One port ``trace_bounce`` step vs the JAX package's, from the same
PathState, through the fused2 accelerator.

alive, depth, rng and prev_lobe must be exact.  result and ray_o agree to
rtol 1e-5 (atol 1e-6 for components near zero): hit distances agree to a few
ulp.  throughput and ray_d carry the sampled BSDF value and direction, whose
transcendentals (tan near its poles in the reference's NDF phi formula)
differ between the frameworks in the last bits and amplify that: measured up
to 1.2e-5 relative and 6e-6 absolute, so they are held to rtol 1e-4 / atol
1e-5 (tests/test_disney.py allows 2e-3 for the same quantities).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import integrator as jint
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator as tint

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
N = 1024


def _state(scene_np, r):
    """Half camera rays, half rays from random points inside the scene box."""
    v = scene_np["vertices"]
    lo, hi = v.min(0), v.max(0)
    cam = np.broadcast_to(scene_np["origin"], (N // 2, 3))
    inner = r.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (N - N // 2, 3))
    d = r.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        ray_o=np.concatenate([cam, inner]).astype(np.float32),
        ray_d=d.astype(np.float32),
        result=r.uniform(0, 0.1, (N, 3)).astype(np.float32),
        throughput=r.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
        rng=r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
        alive=r.random(N) < 0.9,
        prev_lobe=r.choice([-1, 0, 1, 2, 3], N).astype(np.int32),
        depth=r.integers(0, 6, N).astype(np.int32),
        prev_pdf=np.zeros(N, np.float32),
    )


@pytest.mark.parametrize("name", ["cornell-box", "cube"])
def test_trace_bounce_matches_jax(name):
    """cornell-box: auto sky; cube: textures and the environment map."""
    settings = jscene.RenderSettings(width=32, height=32, max_samples=4, max_path_depth=8,
                                     environment_auto=True, environment_use=name == "cube")
    js = jscene.compile_scene(ASSETS, name, (32, 32))
    ts = tscene.compile_scene(ASSETS, name, (32, 32), device="cpu")
    textures = jfilm.scene_has_textures(js)
    assert textures == tfilm.scene_has_textures(ts) and textures == (name == "cube")
    st = _state({"vertices": np.asarray(js.vertices), "origin": np.asarray(js.camera.origin)},
                np.random.default_rng(5))

    isect = jf2.make_fused2_intersector(jf2.build_fused2_scene(js, mxu=False), interpret=True)
    step = jax.jit(lambda s: jint.trace_bounce(js, settings, s, isect, textures))
    ref = step(jint.PathState(**{k: jnp.asarray(v) for k, v in st.items()}))

    t_isect, _ = tint.make_intersectors(ts, tf2.build_fused2_scene(ts, cluster_size=512, mxu=False))
    conv = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu" else v) for k, v in st.items()}
    got = tint.trace_bounce(ts, settings, tint.PathState(**conv), t_isect, textures)

    for f in ("alive", "depth", "rng", "prev_lobe"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f, rtol, atol in (("result", 1e-5, 1e-6), ("ray_o", 1e-5, 1e-6),
                          ("throughput", 1e-4, 1e-5), ("ray_d", 1e-4, 1e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    alive0 = st["alive"]
    # the step did real work: some lanes died, some bounced, some hit a light or the sky
    assert (~got.alive.numpy() & alive0).any() and (got.depth.numpy() > st["depth"]).any()
