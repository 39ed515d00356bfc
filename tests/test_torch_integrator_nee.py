"""One port ``trace_bounce_nee`` step vs the JAX package's, from the same
PathState, through the fused2 accelerator (closest hit K1, occlusion K2).

Scenes: cornell-box and box_with_light (area lights), and a sphere under a
sun environment map (environment NEE).  alive, depth, rng and prev_lobe must
be exact; result, throughput and ray_d agree to rtol 1e-4 / atol 1e-5,
tests/test_torch_integrator.py's tolerance for the sampled BSDF quantities
(the frameworks' transcendentals differ in their last bits).  A ray_d lane
whose direction was resampled from a GTR2 NDF half vector (metallic or glass
lobe) also gets the effect of a few ulps of its own cos_t on that direction
(tests/test_torch_ndf_rounding.py: for a narrow lobe sin_t = sqrt(1 -
cos_t^2) cancels, and XLA's CPU 1/sqrt rounds cos_t differently from torch,
and differently from host to host); every other lane keeps the fixed
tolerance.  prev_pdf is the
mixture pdf evaluated at the sampled direction, whose few-ulp difference a
narrow glossy lobe amplifies: it is held to rtol 1e-3 (measured 1.5e-4).  The
deferred form's pending shadow ray (origin, direction, distance,
contribution) is held to the same tolerance and its flag exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import envlight as jenv
from owl_path_tracer_tpu.models import lights as jlights
from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.models.camera import make_camera
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import integrator as jint
from owl_path_tracer_tpu.utils.parser import CameraDesc
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import envlight as tenv
from owl_path_tracer_tpu_torch.models import lights as tlights
from owl_path_tracer_tpu_torch.ops import disney as tdisney
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import integrator as tint
from test_envlight import sun_env
from test_integrator import make_sphere_mesh
from test_nee import box_with_light
from test_torch_ndf_rounding import ndf_direction_allowance
from test_torch_integrator import ASSETS, N, _state
from test_torch_scene import as_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)


def sun_sphere():
    """Diffuse sphere under tests/test_envlight.py's sun map (no area lights)."""
    mat = jmat.single(base_color=(0.8, 0.8, 0.8), roughness=1.0, specular=0.0)
    v, idx, n = make_sphere_mesh(np.zeros(3), 1.0)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (16, 16))
    return jscene.scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n,
                                    env_map=sun_env(sun_value=50.0))


def _case(name):
    base = dict(width=16, height=16, max_samples=4, max_path_depth=6, use_nee=True)
    if name == "cornell-box":
        js = jscene.compile_scene(ASSETS, name, (16, 16), env_map_path=None)
        settings = jscene.RenderSettings(**base, environment_auto=True)
    elif name == "box_with_light":
        js = box_with_light()
        settings = jscene.RenderSettings(**base, environment_intensity=0.0, environment_color=(0, 0, 0))
    else:
        js = sun_sphere()
        settings = jscene.RenderSettings(**base, environment_use=True)
    return js, convert.scene_from_numpy(as_numpy(js), device="cpu"), settings


def _lights(js, ts, settings):
    jl, tl = jlights.build_light_table(js), tlights.build_light_table(ts)
    je = te = None
    if settings.environment_use:
        je = jenv.build_env_light(np.asarray(js.env_map), settings.environment_intensity)
        te = tenv.build_env_light(ts.env_map, settings.environment_intensity)
    return jl, tl, je, te


@pytest.fixture
def ndf_cos_t(monkeypatch):
    """Records, per port BSDF sample, the lobe each lane drew and the cos_t
    of each GTR2 NDF half vector, by the lobe sampler that drew it
    ("metallic": one [N]; "glass": its TIR and reflection draws)."""
    rec = {"lobe": [], "metallic": [], "glass": []}
    caller = []
    ndf, specular, glass, sample = (tdisney.sample_gtr2_ndf, tdisney.sample_specular_brdf,
                                    tdisney.sample_glass, tdisney.sample)

    def record_ndf(*args):
        wh = ndf(*args)
        rec[caller[-1]].append(wh[..., 2].numpy().copy())  # unit wh: z = cos_t
        return wh

    def tagged(name, fn):
        def call(*args, **kw):
            caller.append(name)
            try:
                return fn(*args, **kw)
            finally:
                caller.pop()
        return call

    def record_sample(*args, **kw):
        bs = sample(*args, **kw)
        rec["lobe"].append(bs.lobe.numpy().copy())
        return bs

    monkeypatch.setattr(tdisney, "sample_gtr2_ndf", record_ndf)
    monkeypatch.setattr(tdisney, "sample_specular_brdf", tagged("metallic", specular))
    monkeypatch.setattr(tdisney, "sample_glass", tagged("glass", glass))
    monkeypatch.setattr(tdisney, "sample", record_sample)
    return rec


def _ray_d_allowance(rec, got, st):
    """[N] what a few ulps of cos_t may move each resampled ray_d lane by:
    the metallic draw's half vector on metallic lanes, the larger of the two
    glass draws on glass lanes, 0 on every other lane and wherever ray_d was
    not resampled (it is the input direction on both sides)."""
    assert len(rec["lobe"]) == 1, "one BSDF sample per step"
    lobe = rec["lobe"][0]
    extra = np.zeros(lobe.shape, np.float64)
    if rec["metallic"]:
        (c_m,) = rec["metallic"]
        extra = np.where(lobe == tdisney.LOBE_METALLIC, ndf_direction_allowance(c_m), extra)
    if rec["glass"]:
        c_g = np.maximum.reduce([ndf_direction_allowance(c) for c in rec["glass"]])
        extra = np.where(lobe == tdisney.LOBE_GLASS, c_g, extra)
    resampled = (got.ray_d.numpy() != st["ray_d"]).any(-1)
    return np.where(resampled, extra, 0.0)


def _assert_state_matches(got, ref, st, rec):
    for f in ("alive", "depth", "rng", "prev_lobe"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("result", "throughput"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **TOL)
    have, want = got.ray_d.numpy(), np.asarray(ref.ray_d)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + _ray_d_allowance(rec, got, st)[:, None]
    # as assert_allclose: equal values (infinities) and NaN against NaN pass
    off = ~((np.abs(have - want) <= bound) | (have == want) | (np.isnan(have) & np.isnan(want)))
    assert not off.any(), (f"ray_d: {int(off.any(-1).sum())} lanes beyond rtol 1e-4 / atol 1e-5 and their "
                           f"cos_t allowance, rows {np.nonzero(off.any(-1))[0][:8].tolist()}")
    np.testing.assert_allclose(got.prev_pdf.numpy(), np.asarray(ref.prev_pdf), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.ray_o.numpy(), np.asarray(ref.ray_o), rtol=1e-5, atol=1e-6)
    # the step did real work: light was gathered, some lanes died, some bounced
    assert (got.result.numpy() > st["result"] + 1e-6).any()
    assert (~got.alive.numpy() & st["alive"]).any() and (got.depth.numpy() > st["depth"]).any()


# deferred NEE is for area lights only, as in the JAX package
@pytest.mark.parametrize("name,deferred", [
    ("cornell-box", False), ("cornell-box", True), ("box_with_light", False),
    ("box_with_light", True), ("sun_sphere", False),
])
def test_trace_bounce_nee_matches_jax(name, deferred, ndf_cos_t):
    js, ts, settings = _case(name)
    jl, tl, je, te = _lights(js, ts, settings)
    assert (jl is None) == (name == "sun_sphere") and (je is None) == (name != "sun_sphere")
    r = np.random.default_rng(7)
    st = _state({"vertices": np.asarray(js.vertices), "origin": np.asarray(js.camera.origin)}, r)
    # MIS weights: most lanes come from a BSDF sample with a known pdf
    st["prev_pdf"] = np.where(r.random(N) < 0.7, r.uniform(0.05, 3.0, N), 0.0).astype(np.float32)
    allow = st["depth"] < settings.max_path_depth - 1

    jfb = jf2.build_fused2_scene(js, mxu=False)
    isect, occlude = jint.make_intersectors(js, jfb)
    step = jax.jit(lambda s, a: jint.trace_bounce_nee(
        js, settings, jl, s, isect, occlude, False, allow_nee=a, env_light=je, deferred=deferred))
    ref = step(jint.PathState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(allow))

    t_isect, t_occlude = tint.make_intersectors(ts, tf2.build_fused2_scene(ts, cluster_size=512, mxu=False))
    conv = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu" else v) for k, v in st.items()}
    got = tint.trace_bounce_nee(ts, settings, tl, tint.PathState(**conv), t_isect, t_occlude, False,
                                allow_nee=torch.as_tensor(allow), env_light=te, deferred=deferred)
    if not deferred:
        _assert_state_matches(got, ref, st, ndf_cos_t)
        return
    (got, pend), (ref, pend_ref) = got, ref
    _assert_state_matches(got, ref, st, ndf_cos_t)
    on = pend[4].numpy()
    np.testing.assert_array_equal(on, np.asarray(pend_ref[4]))
    assert on.mean() > 0.2
    for i, what in enumerate(("origin", "direction", "distance", "contribution")):
        np.testing.assert_allclose(pend[i].numpy()[on], np.asarray(pend_ref[i])[on], err_msg=what, **TOL)
    np.testing.assert_array_equal(pend[3].numpy()[~on], 0.0)


def test_deferred_equals_immediate_when_nothing_is_occluded():
    """Same draws and contributions: with an occluder that never blocks, the
    immediate form's result is the deferred form's result plus its pending
    contributions."""
    js, ts, settings = _case("box_with_light")
    _, tl, _, _ = _lights(js, ts, settings)
    st = _state({"vertices": np.asarray(js.vertices), "origin": np.asarray(js.camera.origin)},
                np.random.default_rng(8))
    conv = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu" else v) for k, v in st.items()}
    isect, _ = tint.make_intersectors(ts, tf2.build_fused2_scene(ts, cluster_size=512, mxu=False))

    def never(pos, direction, dist):
        return torch.zeros(pos.shape[0], dtype=torch.bool)

    imm = tint.trace_bounce_nee(ts, settings, tl, tint.PathState(**conv), isect, never, False)
    dfr, pend = tint.trace_bounce_nee(ts, settings, tl, tint.PathState(**conv), isect, None, False,
                                      deferred=True)
    for f in ("rng", "alive", "depth", "throughput", "ray_d", "prev_pdf"):
        np.testing.assert_array_equal(getattr(dfr, f).numpy(), getattr(imm, f).numpy(), err_msg=f)
    np.testing.assert_allclose((dfr.result + pend[3]).numpy(), imm.result.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="area lights"):
        tint.trace_bounce_nee(ts, settings, tl, tint.PathState(**conv), isect, never, False,
                              env_light=object(), deferred=True)
