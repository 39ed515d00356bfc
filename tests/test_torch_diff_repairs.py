"""The repairs the gradient path needed in code that existed before it, one
test each (each fails on the tree before the repair):

* the traversal kernels' inputs are detached (``fused2.pack_rays``,
  ``fused2_traverse_packed``, the wrappers), so their outputs carry no
  ``grad_fn`` on the CPU either, as on the card, where a kernel has no
  backward pass;
* rows a kernel block leaves unresolved take the exact cluster query on
  detached rays, as the JAX package stops their gradient;
* ``disney.sample`` runs each lobe on benign inputs in the lanes it did not
  select while autograd records, so an unselected lobe's non-finite partial
  no longer poisons a material gradient (the JAX package's double where);
* the forward values are bit-equal with and without autograd recording;
* the Russian-roulette survival probability of the NEE bounce is detached,
  as in the JAX package (``trace_bounce_nee``); the BSDF-only bounce's is
  not, in either package;
* the attribute-blob
  surface fetch puts a miss lane at its ray origin while autograd records,
  so NEE material gradients through fused2 are finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.ops import disney as jd
from owl_path_tracer_tpu.render import integrator as jint
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import disney as td
from owl_path_tracer_tpu_torch.ops import fused as tfu
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import diff as tdiff
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator as tint
from test_diff import SETTINGS
from test_fused2 import _soup
from test_torch_diff import ASSETS, pixels, sphere, tpx
from test_torch_film import _port_settings
from test_torch_scene import as_numpy

torch.set_num_threads(2)

# the LCG (ops/rng.py): state' = A state + C mod 2^32
_A, _C, _M = 16807, 1013904223, 2**32


def _state_before(state: int, draws: int) -> int:
    """The LCG state ``draws`` steps before ``state``."""
    a_inv = pow(_A, -1, _M)
    for _ in range(draws):
        state = (a_inv * (state - _C)) % _M
    return state


@pytest.fixture(scope="module")
def soup():
    """The soup (3000 triangles) on the component and MXU f32 layouts and
    as C=64 clusters; 512 live rays (requires_grad) with per-ray t_max."""
    verts, idx, r = _soup()
    n = 512
    o = torch.as_tensor(r.uniform(-6, 6, (n, 3)), dtype=torch.float32)
    d = torch.as_tensor(r.normal(size=(n, 3)), dtype=torch.float32)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tmax = torch.as_tensor(np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10), dtype=torch.float32)
    accels = {mxu: tf2.build_fused2(verts, idx, 64, mxu=mxu, device="cpu") for mxu in (False, True)}
    cb = tcl.build_clusters(verts, idx, 64, device="cpu")
    live = [x.clone().requires_grad_(True) for x in (o, d, tmax)]
    return accels, cb, live


def leaves(bundle):
    """A copy of a dataclass of tensors whose fields are autograd leaves."""
    return dataclasses.replace(bundle, **{f.name: getattr(bundle, f.name).detach().clone().requires_grad_(True)
                                          for f in dataclasses.fields(bundle)})


def _no_grad(*xs):
    return all(x.grad_fn is None and not x.requires_grad for x in xs)


@pytest.mark.parametrize("mxu", [False, True], ids=["component", "mxu_f32"])
def test_kernel_outputs_have_no_grad_fn(soup, mxu):
    accels, cb, (o, d, tmax) = soup
    fb = accels[mxu]
    assert _no_grad(tf2.pack_rays(o, d, tmax, shadow=tmax > 5.0))
    rays = torch.cat([o, d, tmax[:, None], torch.zeros_like(tmax)[:, None]], 1)  # live [N,8]
    assert rays.requires_grad
    for mode in ("closest", "any_hit", "mixed"):
        assert _no_grad(tf2.fused2_traverse_packed(rays, fb, mode=mode))
    for sort in (False, "morton"):
        rec, blob = tf2.fused2_closest_hit(o, d, fb, t_max=tmax, sort=sort)
        assert (rec.tri >= 0).sum() > 50 and _no_grad(rec.t, rec.uv, blob)
        rec, blob, occ = tf2.fused2_sweep_mixed(o, d, tmax, tmax > 5.0, fb, sort=sort)
        assert _no_grad(rec.t, rec.uv, blob)
    # K5's plain version (the fused kernel) takes the same packing
    assert _no_grad(tfu.fused_traverse(o, d, tmax, tfu.build_fused(cb)))


def test_unresolved_rows_are_detached(soup, monkeypatch):
    """Rows a block leaves unresolved (column 5 = 0; the plain version
    resolves every row, so a wrapped traversal marks every other row so,
    as an overflowing kernel block would) take the exact cluster query, on
    detached rays."""
    accels, _, (o, d, tmax) = soup
    fb = accels[True]
    traverse = tf2.fused2_traverse_packed

    def overflowing(*args, **kw):
        out = traverse(*args, **kw).clone()
        out[::2, 5] = 0.0
        return out

    monkeypatch.setattr(tf2, "fused2_traverse_packed", overflowing)
    before = tf2.UNRESOLVED_RAYS
    rec, blob = tf2.fused2_closest_hit(o, d, fb, t_max=tmax)
    rec_m, blob_m, _ = tf2.fused2_sweep_mixed(o, d, tmax, tmax > 5.0, fb)
    occ = tf2.fused2_occluded(o, d, fb, t_max=tmax)
    assert tf2.UNRESOLVED_RAYS - before == 3 * 256
    assert _no_grad(rec.t, rec.uv, blob, rec_m.t, rec_m.uv, blob_m)
    want = tcl.cluster_closest_hit(o.detach(), d.detach(), fb.cluster, t_max=tmax.detach())
    assert torch.equal(rec.tri, want.tri) and torch.equal(rec.t, want.t) and torch.equal(occ, want.tri >= 0)


def _poisoned_lane():
    """A diffuse material (metal never selected) whose metal lobe draws
    u = 1000 / 2^32: its sampled NDF half vector has cos_t = 1, sin_t = 0,
    and d sin_t / d roughness is infinite."""
    mat = jmat.single(base_color=(0.6, 0.4, 0.3), roughness=0.5, specular=0.0)
    mat = jax.tree.map(lambda v: jnp.concatenate([v, v]), mat)
    wo = np.asarray([[0.3, 0.2, 0.9], [0.3, 0.2, 0.9]], np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    state = np.asarray([_state_before(1000, 2), 12345], np.uint32)  # u[1] of lane 0 is 1000 / 2^32
    return mat, wo, state, np.asarray([-1, -1], np.int32)


def test_unselected_lobe_does_not_poison_roughness_gradient():
    mat, wo, state, prev = _poisoned_lane()
    want = jax.grad(lambda r: jnp.sum(jd.sample(mat._replace(roughness=r), jnp.asarray(wo), jnp.asarray(state),
                                                jnp.asarray(prev)).f))(mat.roughness)
    tm = leaves(convert.materials_from_numpy(as_numpy(mat), device="cpu"))
    bs = td.sample(tm, torch.as_tensor(wo), torch.as_tensor(state.astype(np.int64)), torch.as_tensor(prev).long())
    assert bs.lobe.tolist() == [td.LOBE_DIFFUSE] * 2
    (got,) = torch.autograd.grad(bs.f.sum(), [tm.roughness])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert not bs.wi.requires_grad and not bs.pdf.requires_grad  # the sample is detached


def test_forward_is_bit_equal_with_and_without_recording():
    """disney.sample on lanes of every lobe (the poisoned one too), and the
    gradient path's render, with and without autograd recording."""
    r = np.random.default_rng(3)
    n = 4096
    mat, wo0, state0, _ = _poisoned_lane()
    base = convert.materials_from_numpy(as_numpy(jax.tree.map(lambda v: v[:1], mat)), device="cpu")
    fields = {f.name: getattr(base, f.name).expand((n,) + getattr(base, f.name).shape[1:]).clone()
              for f in dataclasses.fields(base)}
    for name in ("metallic", "clearcoat", "specular_transmission", "roughness", "anisotropic", "sheen"):
        fields[name] = torch.as_tensor(r.choice([0.0, 0.3, 1.0], n), dtype=torch.float32)
    wo = torch.as_tensor(r.normal(size=(n, 3)), dtype=torch.float32)
    wo = wo / torch.linalg.norm(wo, dim=-1, keepdim=True)
    wo[0] = torch.as_tensor(wo0[0])
    state = torch.as_tensor(r.integers(0, 2**32, n))
    state[0] = int(state0[0])
    prev = torch.as_tensor(r.choice([-1, td.LOBE_GLASS], n))
    with torch.no_grad():
        plain = td.sample(convert.materials_from_numpy(fields, device="cpu"), wo, state, prev)
    rec = td.sample(leaves(convert.materials_from_numpy(fields, device="cpu")), wo, state, prev)
    assert rec.f.requires_grad and len(set(plain.lobe.tolist())) == 4
    for f in dataclasses.fields(plain):
        assert torch.equal(getattr(rec, f.name), getattr(plain, f.name)), f.name

    _, sph = sphere()
    cornell = tscene.compile_scene(ASSETS, "cornell-box", (16, 16), env_map_path=None, device="cpu")
    nee = dataclasses.replace(_port_settings(SETTINGS), use_nee=True, environment_auto=True)
    for ts, s, kind in ((sph, _port_settings(SETTINGS), "brute"), (cornell, nee, "fused2")):
        accel = None if kind == "brute" else tfilm.make_accel(ts, "fused2")
        with torch.no_grad():
            img = tdiff.render_with_materials(ts, ts.materials, s, tpx(pixels()), 2, accel)
        img_rec = tdiff.render_with_materials(ts, leaves(ts.materials), s, tpx(pixels()), 2, accel)
        assert img_rec.requires_grad and torch.equal(img_rec.detach(), img), kind


def test_nee_gradients_on_fused2_are_finite():
    """NEE through the attribute-blob surface fetch (fused2): a miss lane's
    hit position o + T_MAX d made the masked light samples' factors inf, and
    zero cotangents turned them into NaN material gradients; while autograd
    records, a miss lane's position is its ray origin."""
    cornell = tscene.compile_scene(ASSETS, "cornell-box", (16, 16), env_map_path=None, device="cpu")
    s = dataclasses.replace(_port_settings(SETTINGS), use_nee=True, environment_auto=True, max_samples=2)
    loss, g = tdiff.loss_and_grad(cornell, cornell.materials, s, tpx(pixels()), torch.zeros((256, 3)), 2,
                                  tfilm.make_accel(cornell, "fused2"))
    grads = convert.to_numpy(g)
    assert float(loss) > 0 and np.abs(grads["base_color"]).max() > 0
    for name, value in grads.items():
        assert np.isfinite(value).all(), name


def test_nee_russian_roulette_probability_is_detached():
    """One NEE bounce at depth 4 (> rr_start_depth): the gradient of the
    surviving lanes' compensated throughput (throughput / q) with respect to
    base_color is JAX's, which holds q constant."""
    js, ts = sphere()
    n = 64
    r = np.random.default_rng(5)
    ang = r.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    d = np.stack([-np.ones(n, np.float32), ang[:, 0], ang[:, 1]], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.asarray([[3.0, 0.0, 0.0]], np.float32), (n, 1))
    thr = np.full((n, 3), 0.5, np.float32)
    rng = r.integers(0, 2**32, n).astype(np.uint32)
    settings = dataclasses.replace(SETTINGS, use_nee=True)
    jisect, jocc = jint.make_intersectors(js, None)
    jps = jint.PathState(jnp.asarray(o), jnp.asarray(d), jnp.zeros((n, 3)), jnp.asarray(thr), jnp.asarray(rng),
                         jnp.ones((n,), bool), jnp.full((n,), -1, jnp.int32), jnp.full((n,), 4, jnp.int32),
                         jnp.zeros((n,)))

    def jloss(bc):
        out = jint.trace_bounce_nee(js._replace(materials=js.materials._replace(base_color=bc)), settings, None,
                                    jps, jisect, jocc, False)
        return jnp.sum(jnp.where(out.alive[:, None], out.throughput, 0.0)), out.alive

    (want_loss, alive), want = jax.value_and_grad(jloss, has_aux=True)(js.materials.base_color)
    tisect, tocc = tint.make_intersectors(ts, None)
    tps = tint.PathState(ray_o=torch.as_tensor(o), ray_d=torch.as_tensor(d), result=torch.zeros((n, 3)),
                         throughput=torch.as_tensor(thr), rng=torch.as_tensor(rng.astype(np.int64)),
                         alive=torch.ones((n,), dtype=torch.bool), prev_lobe=torch.full((n,), -1),
                         depth=torch.full((n,), 4), prev_pdf=torch.zeros((n,)))
    bc = ts.materials.base_color.clone().requires_grad_(True)
    out = tint.trace_bounce_nee(dataclasses.replace(ts, materials=dataclasses.replace(ts.materials, base_color=bc)),
                                _port_settings(settings), None, tps, tisect, tocc, False)
    assert out.alive.numpy().tolist() == np.asarray(alive).tolist() and 0 < int(out.alive.sum()) < n
    loss = torch.where(out.alive[:, None], out.throughput, 0.0).sum()
    (got,) = torch.autograd.grad(loss, [bc])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
