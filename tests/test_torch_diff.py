"""The port's gradient path (``render/diff.py``) against the JAX package's, on
the scenes of tests/test_diff.py, the same seeded inputs on both sides (the
port's scenes are the JAX scenes' arrays, ``convert.scene_from_numpy``).

* Material gradients through ``brute``, ``cluster`` and ``fused2`` (MXU f32
  planes, ``differentiable=True``: its plain version here), env-map
  gradients, camera gradients (brute, cluster, the fused2 refit) and
  cornell-box NEE material gradients, against ``jax.value_and_grad`` of the
  JAX losses on the brute sweep (cluster for cornell-box).
* Forward images meet the golden rule of tests/test_golden.py (>99.5% of
  pixels isclose(rtol=1e-4, atol=1e-5), means within rtol 1e-3).
* Gradients, per field: allclose(rtol=1e-3, atol=1e-5 * max|g_jax|), over
  the pixels whose forward radiance agrees by that rule.  A pixel outside
  it has traced another path, so its gradient is another quantity: on the
  16x16 sphere one pixel, (5, 10), differs (radiance 0.698 against 0.676).
  Its second sample's bounce ray leaves the sphere at a grazing angle (0.03
  from the tangent plane), and XLA's jitted render puts the hit point one
  ulp from where eager JAX and the port put it (eager JAX's bounces equal
  the port's there), so the ray re-enters a facet of the tessellated sphere
  in one and escapes in the other.  Counting that pixel, base_color's
  gradient differs by 3.5e-3 of itself.  Without it the worst ratio of
  |g_port - g_jax| to the tolerance is 4.4e-4 for materials on brute and
  cluster, 5.7e-4 on fused2, 2.2e-4 for the env map, 1.9e-3 for the camera
  (all three accelerators) and 1.9e-2 for cornell NEE beside its explained
  elements (test_nee_material_gradients_match_jax).  The golden rule bounds
  such pixels to 0.5%.
* The port's own finite-difference checks with tests/test_diff.py's
  tolerances (rtol 0.08 base_color and camera, 0.15 roughness, 0.05
  emission, env map and through fused2).
* Recovery: the sphere's true color within 0.05 and the last loss under 5%
  of the first; the first 5 losses equal JAX's ``recover_materials`` within
  rtol 1e-3.  The car and mitsuba recovery smokes of tests/test_diff.py and
  tests/test_scenes_all.py.

With ``use_nee`` the JAX ``render_with_params`` cannot run: it builds its
light table with numpy inside ``jax.jit`` (a TracerArrayConversionError), so
the NEE reference is the same computation composed from the JAX package's
parts, the light table built outside the trace.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu.models import lights as jlights
from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models.camera import make_camera
from owl_path_tracer_tpu.models.scene import RenderSettings, compile_scene, scene_from_arrays
from owl_path_tracer_tpu.ops import rng as jrng
from owl_path_tracer_tpu.render import diff as jdiff
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import integrator as jint
from owl_path_tracer_tpu.utils.parser import CameraDesc
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.models.material import Materials
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import diff as tdiff
from owl_path_tracer_tpu_torch.render import film as tfilm
from test_diff import SETTINGS
from test_integrator import make_sphere_mesh
from test_torch_film import _port_settings, assert_golden_rule
from test_torch_scene import as_numpy

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
RTOL = 1e-3
ATOL_OF_MAX = 1e-5


def sphere(base_color=(0.6, 0.4, 0.3), roughness=0.7, radius=1.0, **extra):
    """tests/test_diff.py's diffuse sphere (16x16, camera at (3, 0, 0)) -> (JAX scene, port scene)."""
    mat = jmat.single(base_color=base_color, roughness=roughness, specular=0.0, **extra)
    v, idx, n = make_sphere_mesh(np.zeros(3), radius)
    cam = make_camera(CameraDesc((3, 0, 0), (0, 0, 0), (0, 1, 0), 45), (16, 16))
    js = scene_from_arrays(v, idx, mat, np.zeros(len(idx), np.int32), cam, normals=n)
    return js, convert.scene_from_numpy(as_numpy(js), device="cpu")


def env_sphere():
    """tests/test_diff.py's env_sphere_scene: a 4x8 environment map."""
    js, _ = sphere()
    env = np.zeros((4, 8, 3), np.float32)
    env[:, :, 0] = 0.8
    env[2, 3] = [0.1, 0.9, 0.2]
    js = js._replace(env_map=jnp.asarray(env))
    settings = dataclasses.replace(SETTINGS, environment_use=True, environment_color=(0, 0, 0))
    return js, convert.scene_from_numpy(as_numpy(js), device="cpu"), settings


def pixels(size=16):
    x, y = np.meshgrid(np.arange(size, dtype=np.int32), np.arange(size, dtype=np.int32))
    return np.stack([x.ravel(), y.ravel()], -1)


def port_accel(ts, kind):
    """brute -> None; cluster C=64; fused2: MXU f32 planes, C=64 (tests/test_diff.py's)."""
    if kind == "brute":
        return None
    if kind == "cluster":
        return tfilm.make_accel(ts, "cluster", cluster_size=64)
    host = lambda x: x.numpy()  # noqa: E731
    return tf2.build_fused2(host(ts.vertices), host(ts.tri_idx), 64, normals=host(ts.normals),
                            texcoords=host(ts.texcoords), tri_mat=host(ts.tri_mat), device="cpu")


def tpx(px):
    return torch.as_tensor(px, dtype=torch.int64)


def agreeing(jax_img, port_img, what):
    """The golden rule over the image, and the mask of pixels whose three
    channels agree by it."""
    assert_golden_rule(port_img, jax_img, what)
    return np.isclose(port_img, jax_img, rtol=1e-4, atol=1e-5).all(-1)


def assert_grads_close(got: dict, want: dict, what, exact: dict | None = None):
    """Per field allclose(rtol=1e-3, atol=1e-5 max|g_jax|) -> the worst ratio
    of |got - want| to that tolerance.

    With ``exact`` (the port's own code run in float64), an element outside
    the tolerance passes only where the port's float32 value lies within it
    of the float64 one and JAX's does not (a non-finite JAX value is held to
    the float64 value's own tolerance); returns (worst ratio, such finite
    elements, such non-finite elements)."""
    worst, finite, nonfinite = 0.0, 0, 0
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name]
        assert g.shape == w.shape and np.isfinite(g).all(), f"{what} {name}"
        tol = RTOL * np.abs(w) + ATOL_OF_MAX * np.nanmax(np.abs(w))
        off = ~(np.abs(g - w) <= tol)
        if exact is not None and off.any():
            e = exact[name]
            tol = np.where(np.isfinite(w), tol, RTOL * np.abs(e) + ATOL_OF_MAX * np.abs(e).max())
            assert (np.abs(g - e)[off] <= tol[off]).all() and not (np.abs(w - e)[off] <= tol[off]).any(), (
                f"{what} {name}: {g[off]} (port) vs {w[off]} (JAX), float64 {e[off]}")
            finite += int((off & np.isfinite(w)).sum())
            nonfinite += int((off & ~np.isfinite(w)).sum())
            g = np.where(off, w, g)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_OF_MAX * np.nanmax(np.abs(w)), err_msg=f"{what} {name}")
        if np.nanmax(tol) > 0:
            worst = max(worst, float(np.nanmax(np.abs(g - w) / np.where(tol > 0, tol, 1.0))))
    return worst if exact is None else (worst, finite, nonfinite)


@pytest.fixture(scope="module")
def mat_reference():
    """JAX image and (loss, material gradients) over a pixel subset, cached."""
    js, ts = sphere()
    px = pixels()
    img = np.asarray(jdiff.render_with_materials(js, js.materials, SETTINGS, jnp.asarray(px), 4, None))
    cache = {}

    def grads(keep):
        key = keep.tobytes()
        if key not in cache:
            loss, g = jdiff.loss_and_grad(js, js.materials, SETTINGS, jnp.asarray(px[keep]),
                                          jnp.zeros((int(keep.sum()), 3)), 4, None)
            cache[key] = float(loss), as_numpy(g)
        return cache[key]

    return js, ts, px, img, grads


@pytest.mark.parametrize("kind", ["brute", "cluster", "fused2"])
def test_material_gradients_match_jax(mat_reference, kind):
    js, ts, px, jimg, jgrads = mat_reference
    s = _port_settings(SETTINGS)
    accel = port_accel(ts, kind)
    img = tdiff.render_with_materials(ts, ts.materials, s, tpx(px), 4, accel).numpy()
    keep = agreeing(jimg, img, f"sphere image, {kind}")
    loss, g = tdiff.loss_and_grad(ts, ts.materials, s, tpx(px[keep]), torch.zeros((int(keep.sum()), 3)), 4, accel)
    want_loss, want = jgrads(keep)
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
    assert assert_grads_close(convert.to_numpy(g), want, f"materials via {kind}") <= 1.0
    assert np.abs(convert.to_numpy(g)["base_color"]).max() > 0


def test_env_gradients_match_jax():
    js, ts, settings = env_sphere()
    s = _port_settings(settings)
    px = pixels()
    jimg = np.asarray(jdiff.render_with_params(js, js.materials, js.env_map, js.camera, settings, jnp.asarray(px),
                                               4, None))
    img = tdiff.render_with_params(ts, ts.materials, ts.env_map, ts.camera, s, tpx(px), 4, None).numpy()
    keep = agreeing(jimg, img, "env sphere image")
    zeros = np.zeros((int(keep.sum()), 3), np.float32)
    want_loss, want = jdiff.env_loss_and_grad(js, js.env_map, settings, jnp.asarray(px[keep]), jnp.asarray(zeros),
                                              4, None)
    loss, g = tdiff.env_loss_and_grad(ts, ts.env_map, s, tpx(px[keep]), torch.as_tensor(zeros), 4, None)
    assert g.shape == ts.env_map.shape and float(g.abs().max()) > 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    assert assert_grads_close({"env": g.numpy()}, {"env": want}, "env map") <= 1.0


@pytest.fixture(scope="module")
def camera_reference():
    """tests/test_diff.py's camera view: a radius-2 sphere covers every pixel."""
    js, ts = sphere(radius=2.0)
    settings = dataclasses.replace(SETTINGS, environment_auto=True)
    px = pixels()
    img = np.asarray(jdiff.render_with_params(js, js.materials, js.env_map, js.camera, settings, jnp.asarray(px),
                                              4, None))
    cache = {}

    def grads(keep):
        if keep.tobytes() not in cache:
            loss, g = jdiff.camera_loss_and_grad(js, js.camera, settings, jnp.asarray(px[keep]),
                                                 jnp.zeros((int(keep.sum()), 3)), 4, None)
            cache[keep.tobytes()] = float(loss), as_numpy(g)
        return cache[keep.tobytes()]

    return ts, settings, px, img, grads


@pytest.mark.parametrize("kind", ["brute", "cluster", "fused2"])
def test_camera_gradients_match_jax(camera_reference, kind):
    ts, settings, px, jimg, jgrads = camera_reference
    s = _port_settings(settings)
    accel = port_accel(ts, kind)
    img = tdiff.render_with_params(ts, ts.materials, ts.env_map, ts.camera, s, tpx(px), 4, accel).numpy()
    keep = agreeing(jimg, img, f"camera image, {kind}")
    loss, g = tdiff.camera_loss_and_grad(ts, ts.camera, s, tpx(px[keep]), torch.zeros((int(keep.sum()), 3)), 4,
                                         accel)
    want_loss, want = jgrads(keep)
    got = convert.to_numpy(g)
    assert np.abs(got["horizontal"]).max() > 0 and np.abs(got["origin"]).max() > 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
    assert assert_grads_close(got, want, f"camera via {kind}") <= 1.0


def test_nee_material_gradients_match_jax():
    """cornell-box 16x16 with use_nee on the cluster query; the JAX side is
    render_with_params composed by hand (module docstring).

    One element is ill-conditioned in float32: the anisotropic gradient of
    the metal "sphere" (4.4e-5, against 7.2e-3 for the field's largest), a
    sum whose pixel (11, 2) takes its bounce from a narrow metal lobe
    (roughness 0.2) with cos_t near 1 (tests/test_torch_ndf_rounding.py's
    cancellation): that lane's d f / d anisotropic is 0.09167 in float64,
    0.09280 in the port's float32 and 0.09044 in JAX's.  Summed, the port
    (4.42978e-5) lies 2.8e-8 from the float64 evaluation of its code
    (4.42701e-5; on the brute sweep, the same winners) and JAX (4.40310e-5)
    2.4e-7, over the 1.2e-7 tolerance.  And JAX's ior gradient is NaN for
    every material: no cornell-box material is glass, so ior changes nothing
    and its gradient is 0 (the port's, in float32 and in float64); each JAX
    bounce alone gives 0, so its NaN comes from the cotangents carried from
    bounce to bounce, where a zero meets a non-finite partial.  Such elements
    are held to the float64 value instead (``assert_grads_close(...,
    exact=)``): at most 2 finite ones, and the ior row."""
    settings = RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_auto=True,
                              use_nee=True)
    js = compile_scene(ASSETS, "cornell-box", (16, 16), env_map_path=None)
    ts = convert.scene_from_numpy(as_numpy(js), device="cpu")
    jaccel = jfilm.make_accel(js, "cluster", cluster_size=64)
    lights = jlights.build_light_table(js)
    isect, occlude = jint.make_intersectors(js, jaccel)
    px = pixels()

    def jrender(mats, px):
        sc = js._replace(materials=mats)
        acc, _, _ = jint.sample_sum(sc, settings, px, jrng.seed(px[..., 0], px[..., 1]), 2, isect, False,
                                    lights=lights, occlude_fn=occlude)
        return acc / 2.0

    jimg = np.asarray(jrender(js.materials, jnp.asarray(px)))
    s = _port_settings(settings)
    accel = tfilm.make_accel(ts, "cluster", cluster_size=64)
    img = tdiff.render_with_materials(ts, ts.materials, s, tpx(px), 2, accel).numpy()
    keep = agreeing(jimg, img, "cornell NEE image")
    want_loss, want = jax.value_and_grad(lambda mats: jnp.mean(jrender(mats, jnp.asarray(px[keep])) ** 2))(
        js.materials)
    zeros = torch.zeros((int(keep.sum()), 3))
    loss, g = tdiff.loss_and_grad(ts, ts.materials, s, tpx(px[keep]), zeros, 2, accel)
    ts64 = chip_smoke.float64(ts)
    _, g64 = tdiff.loss_and_grad(ts64, ts64.materials, s, tpx(px[keep]), zeros, 2, None)
    got = convert.to_numpy(g)
    assert np.abs(got["base_color"]).max() > 0 and np.abs(got["emission"]).max() > 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    worst, finite, nonfinite = assert_grads_close(got, as_numpy(want), "cornell NEE materials",
                                                  exact=convert.to_numpy(g64))
    assert worst <= 1.0 and finite <= 2 and nonfinite <= ts.materials.count


# ── the port's own finite-difference checks (tests/test_diff.py's) ──


def _fd(loss_of, arg, bump, eps):
    """Central difference of ``loss_of`` at ``arg`` along ``bump(arg, delta)``."""
    return (float(loss_of(bump(arg, +eps))) - float(loss_of(bump(arg, -eps)))) / (2 * eps)


def _bumped(tensor, index, delta):
    out = tensor.clone()
    out[index] += delta
    return out


@pytest.mark.parametrize("field,index,rtol", [("base_color", (0, 1), 0.08), ("roughness", (0,), 0.15)])
def test_material_fd(field, index, rtol):
    _, ts = sphere()
    s = _port_settings(SETTINGS)
    px, target = tpx(pixels()), torch.zeros((256, 3))

    def loss_of(mats):
        return tdiff.image_loss(ts, mats, s, px, target, 4, None)

    _, g = tdiff.loss_and_grad(ts, ts.materials, s, px, target, 4, None)
    fd = _fd(loss_of, ts.materials,
             lambda mats, d: dataclasses.replace(mats, **{field: _bumped(getattr(mats, field), index, d)}), 1e-3)
    ad = float(getattr(g, field)[index])
    assert fd != 0.0 or abs(ad) < 1e-7
    np.testing.assert_allclose(ad, fd, rtol=rtol, atol=1e-5)


def test_emission_fd():
    _, ts = sphere(base_color=(1, 1, 1), emission=2.0)
    s = _port_settings(SETTINGS)
    px, target = tpx(pixels()), torch.zeros((256, 3))

    def loss_of(mats):
        return tdiff.image_loss(ts, mats, s, px, target, 2, None)

    _, g = tdiff.loss_and_grad(ts, ts.materials, s, px, target, 2, None)
    fd = _fd(loss_of, ts.materials, lambda mats, d: dataclasses.replace(mats, emission=mats.emission + d), 1e-3)
    np.testing.assert_allclose(float(g.emission[0]), fd, rtol=0.05)


def test_env_map_fd():
    _, ts, settings = env_sphere()
    s = _port_settings(settings)
    px, target = tpx(pixels()), torch.zeros((256, 3))
    _, g = tdiff.env_loss_and_grad(ts, ts.env_map, s, px, target, 4, None)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    at = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    fd = _fd(lambda env: tdiff.env_loss(ts, env, s, px, target, 4, None), ts.env_map,
             lambda env, d: _bumped(env, at, d), 1e-2)
    np.testing.assert_allclose(float(g[at]), fd, rtol=0.05)


@pytest.mark.parametrize("kind,rtol", [("brute", 0.08), ("fused2", 0.08)])
def test_camera_fd(kind, rtol):
    """Through the brute sweep and through the fused2 refit (tests/test_diff.py's two camera checks)."""
    _, ts = sphere(radius=2.0)
    s = _port_settings(dataclasses.replace(SETTINGS, environment_auto=True))
    px, target = tpx(pixels()), torch.zeros((256, 3))
    accel = port_accel(ts, kind)
    _, g = tdiff.camera_loss_and_grad(ts, ts.camera, s, px, target, 4, accel)
    assert torch.isfinite(g.horizontal).all() and float(g.origin.abs().max()) > 0
    comp = int(g.horizontal.abs().argmax())
    fd = _fd(lambda cam: tdiff.camera_loss(ts, cam, s, px, target, 4, accel), ts.camera,
             lambda cam, d: dataclasses.replace(cam, horizontal=_bumped(cam.horizontal, comp, d)), 1e-3)
    np.testing.assert_allclose(float(g.horizontal[comp]), fd, rtol=rtol)


def test_fused2_material_fd():
    """FD through the same fused2 forward (rtol 0.05), and within 0.05 of the
    brute gradient (tests/test_diff.py::test_grad_materials_through_fused2)."""
    _, ts = sphere()
    s = _port_settings(SETTINGS)
    px, target = tpx(pixels()), torch.zeros((256, 3))
    accel = port_accel(ts, "fused2")
    _, g = tdiff.loss_and_grad(ts, ts.materials, s, px, target, 4, accel)
    g0 = float(g.base_color[0, 0])
    assert np.isfinite(g0) and abs(g0) > 0
    fd = _fd(lambda mats: tdiff.image_loss(ts, mats, s, px, target, 4, accel), ts.materials,
             lambda mats, d: dataclasses.replace(mats, base_color=_bumped(mats.base_color, (0, 0), d)), 1e-3)
    np.testing.assert_allclose(g0, fd, rtol=0.05)
    _, g_br = tdiff.loss_and_grad(ts, ts.materials, s, px, target, 4, None)
    np.testing.assert_allclose(g.base_color.numpy(), g_br.base_color.numpy(), rtol=0.05, atol=1e-6)


def test_loss_and_grad_leaves_its_argument_alone():
    """Like jax.value_and_grad: the parameters are not made leaves or changed."""
    _, ts = sphere()
    before = convert.to_numpy(ts.materials)
    tdiff.loss_and_grad(ts, ts.materials, _port_settings(SETTINGS), tpx(pixels()[:32]), torch.zeros((32, 3)), 1,
                        None)
    assert not any(getattr(ts.materials, f.name).requires_grad for f in dataclasses.fields(Materials))
    for name, want in before.items():
        np.testing.assert_array_equal(getattr(ts.materials, name).numpy(), want)


# ── recovery ──


def test_material_recovery_base_color():
    """tests/test_diff.py's recovery on the port; its first 5 losses against JAX's."""
    true_color = (0.8, 0.3, 0.2)
    s = _port_settings(SETTINGS)
    px = pixels()
    _, ts_true = sphere(base_color=true_color)
    target = tdiff.render_with_materials(ts_true, ts_true.materials, s, tpx(px), 8, None)
    js0, ts0 = sphere(base_color=(0.5, 0.5, 0.5))
    res = tdiff.recover_materials(ts0, s, target, tpx(px), ts0.materials, steps=60, lr=0.08, num_samples=8,
                                  accel=None, trainable=("base_color",))
    np.testing.assert_allclose(res.materials.base_color[0].numpy(), true_color, atol=0.05)
    assert res.losses[-1] < res.losses[0] * 0.05
    assert res.losses.shape == (60,)
    # the first 5 steps on both sides, over the pixels whose target radiance
    # agrees (module docstring: a diverged pixel's error stays fixed while
    # the loss falls)
    js_true, _ = sphere(base_color=true_color)
    jtarget = jdiff.render_with_materials(js_true, js_true.materials, SETTINGS, jnp.asarray(px), 8, None)
    keep = agreeing(np.asarray(jtarget), target.numpy(), "recovery target")
    want = jdiff.recover_materials(js0, SETTINGS, jtarget[keep], jnp.asarray(px[keep]), js0.materials,
                                   steps=5, lr=0.08, num_samples=8, accel=None, trainable=("base_color",))
    got = tdiff.recover_materials(ts0, s, target[torch.as_tensor(keep)], tpx(px[keep]), ts0.materials, steps=5,
                                  lr=0.08, num_samples=8, accel=None, trainable=("base_color",))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)


def _recovery_smoke(name, size, settings, mutate, grad_rows=None, steps=10, lr=0.08):
    """Render a target on ``cluster`` (C=128), perturb the materials, recover
    base_color -> losses."""
    sc = tscene.compile_scene(ASSETS, name, (size, size), device="cpu")
    accel = tfilm.make_accel(sc, "cluster", cluster_size=128)
    px = tpx(pixels(size))
    target = tdiff.render_with_materials(sc, sc.materials, settings, px, settings.max_samples, accel)
    init, mask = mutate(sc.materials)
    res = tdiff.recover_materials(sc, settings, target, px, init, steps=steps, lr=lr,
                                  num_samples=settings.max_samples, accel=accel, trainable=("base_color",),
                                  grad_mask=mask)
    assert np.isfinite(res.losses).all()
    return res.losses


def test_car_recovery_smoke():
    """BASELINE config 5's car: the window glass's base color, one row by grad_mask."""
    s = tscene.RenderSettings(width=24, height=24, max_samples=2, max_path_depth=3, environment_auto=True,
                              environment_intensity=1.0)

    def glass(mats):
        gi = int(torch.nonzero(mats.specular_transmission >= 0.99)[0])
        init = dataclasses.replace(mats, base_color=_bumped(mats.base_color, gi, 0.0))
        init.base_color[gi] = torch.tensor([0.2, 0.2, 0.2])
        mask = Materials(**{f.name: torch.zeros_like(getattr(mats, f.name)) for f in dataclasses.fields(Materials)})
        mask.base_color[gi] = 1.0
        return init, mask

    losses = _recovery_smoke("car", 24, s, glass)
    assert losses[-1] < losses[0] * 0.7, losses


def test_mitsuba_recovery_smoke():
    """tests/test_scenes_all.py's mitsuba recovery: the 'outside' albedo."""
    s = tscene.RenderSettings(width=12, height=12, max_samples=2, max_path_depth=2, environment_auto=True,
                              environment_intensity=1.0)

    def outside(mats):
        init = dataclasses.replace(mats, base_color=mats.base_color.clone())
        init.base_color[0] = torch.tensor([0.5, 0.5, 0.5])
        return init, None

    losses = _recovery_smoke("mitsuba", 12, s, outside, lr=0.1)
    assert losses[-1] < losses[0], losses
