"""Port light sampling vs the JAX package's: the area-light table and its
sampler (models/lights.py), the environment CDF sampler (models/envlight.py)
and the full-BSDF eval for NEE/MIS (disney.eval_all).

Tables are built with the same numpy arithmetic and must be bit-equal.  The
samplers agree at the same uniforms: light and texel indices exactly, values
to rtol 1e-6 -- except two that inherit a cancellation: the light direction
is (pos - target) / |pos - target|, where XLA's FMA-contracted sum for pos
differs in its last bit, so it is held to atol 2e-6 (unit vectors; measured
8.7e-7), and both light pdfs (sample_lights, pdf_hit_light) divide by a |cos|
that may be as small as the grazing cut-off 1e-4, which scales such last-bit
differences up, so they are held to rtol 5e-4 (measured 1.3e-4).
eval_all is compared on the domain of tests/test_disney.py at
tests/test_torch_disney.py's tolerances for disney.sample (rtol 5e-3 / atol
1e-4 for f and pdf, on lanes where both sides are finite).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import envlight as jenv
from owl_path_tracer_tpu.models import lights as jlights
from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.ops import disney as jd
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import envlight as tenv
from owl_path_tracer_tpu_torch.models import lights as tlights
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import disney as td
from test_disney import rand_dir_upper, random_material, to_jax_mat
from test_envlight import sun_env
from test_nee import box_with_light
from test_torch_disney import to_port_mat
from test_torch_scene import as_numpy, assert_same_arrays

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
N = 4096


def _scenes(name):
    if name == "box_with_light":
        js = box_with_light()
        return js, convert.scene_from_numpy(as_numpy(js), device="cpu")
    return (jscene.compile_scene(ASSETS, name, (16, 16)),
            tscene.compile_scene(ASSETS, name, (16, 16), device="cpu"))


@pytest.mark.parametrize("name", ["cornell-box", "box_with_light"])
def test_light_table_and_sampler_match_jax(name):
    js, ts = _scenes(name)
    want = jlights.build_light_table(js)
    got = tlights.build_light_table(ts)
    assert got.count == want.count == 2
    assert_same_arrays(got, as_numpy(want))

    r = np.random.default_rng(3)
    v = np.asarray(js.vertices)
    target = r.uniform(v.min(0), v.max(0), (N, 3)).astype(np.float32)
    u3 = r.random((N, 3), dtype=np.float32)
    u3[:8, 0] = [0.0, 0.5, 0.49999997, 0.99999994, 1.0, 0.25, 0.75, 1e-9]  # light-pick edges
    # JAX gets its own copies of the inputs and finishes before the port
    # runs: no XLA thread is at work on a buffer torch reads
    ref = jax.jit(jlights.sample_lights)(want, jnp.asarray(target.copy()), jnp.asarray(u3.copy()))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    ls = tlights.sample_lights(got, torch.as_tensor(target), torch.as_tensor(u3))
    again = tlights.sample_lights(got, torch.as_tensor(target.copy()), torch.as_tensor(u3.copy()))
    for f in ("distance", "direction", "pdf", "normal", "tri_id", "emission"):
        assert torch.equal(getattr(ls, f), getattr(again, f)), f"the port's {f} differs between two runs"
    np.testing.assert_array_equal(ls.tri_id.numpy(), np.asarray(ref.tri_id))
    np.testing.assert_array_equal(ls.emission.numpy(), np.asarray(ref.emission))
    for f, rtol, atol in (("distance", 1e-6, 0), ("normal", 1e-6, 1e-7),
                          ("direction", 0, 2e-6), ("pdf", 5e-4, 0)):
        np.testing.assert_allclose(getattr(ls, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)

    # MIS counterpart: light triangles and other triangles, random hit normals
    tri = r.integers(0, int(js.tri_idx.shape[0]), N).astype(np.int32)
    tri[::4] = np.asarray(want.tri_id)[r.integers(0, want.count, N // 4)]
    ray_d = r.normal(size=(N, 3)).astype(np.float32)
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    light_n = r.normal(size=(N, 3)).astype(np.float32)
    light_n /= np.linalg.norm(light_n, axis=-1, keepdims=True)
    t = r.uniform(0.1, 5.0, N).astype(np.float32)
    ref_pdf = np.asarray(jax.jit(jlights.pdf_hit_light)(
        want, jnp.asarray(tri), jnp.asarray(ray_d), jnp.asarray(t), jnp.asarray(light_n)))
    pdf = tlights.pdf_hit_light(got, torch.as_tensor(tri).long(), *map(torch.as_tensor, (ray_d, t, light_n)))
    assert (ref_pdf > 0).any() and (ref_pdf == 0).any()
    np.testing.assert_allclose(pdf.numpy(), ref_pdf, rtol=5e-4)


def test_no_emitters_gives_no_light_table():
    js, ts = _scenes("box_with_light")
    mats = ts.materials
    dark = type(mats)(**{f: (torch.zeros_like(getattr(mats, f)) if f == "emission" else getattr(mats, f))
                         for f in mats.__dataclass_fields__})
    dark_scene = tscene.scene_from_arrays(
        ts.vertices.numpy(), ts.tri_idx.numpy(), dark, ts.tri_mat.numpy(), ts.camera, device="cpu")
    assert tlights.build_light_table(dark_scene) is None


def test_power_heuristic_matches_jax():
    r = np.random.default_rng(4)
    a = np.concatenate([r.uniform(0, 10, 1000), [0.0, 0.0, 3.0]]).astype(np.float32)
    b = np.concatenate([r.uniform(0, 10, 1000), [0.0, 2.0, 0.0]]).astype(np.float32)
    want = np.asarray(jlights.power_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b)))
    got = tlights.power_heuristic(1.0, torch.as_tensor(a), 1.0, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-3] == 0.0 and got[-2] == 0.0 and got[-1] == 1.0


@pytest.fixture(scope="module")
def env_lights():
    env = sun_env()
    env[5:9, 100:110] = 0.0  # a black patch: flat runs in the column CDFs
    return env, jenv.build_env_light(env, 2.0), tenv.build_env_light(torch.as_tensor(env), 2.0)


def test_env_light_tables_equal_jax(env_lights):
    _, want, got = env_lights
    for f in ("env_map", "row_cdf", "col_cdf", "pdf_map"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.intensity == want.intensity == 2.0
    assert tenv.build_env_light(torch.zeros((1, 1, 3)), 1.0) is None
    assert tenv.build_env_light(torch.ones((4, 8, 3)), 0.0) is None


def test_sample_env_matches_jax(env_lights):
    """Row and column indices exact, including u near 0 and 1 and u equal
    to CDF entries; direction, radiance and pdf follow from them."""
    _, want, got = env_lights
    r = np.random.default_rng(5)
    u2 = r.random((N, 2), dtype=np.float32)
    u2[:6] = [[0.0, 0.0], [1.0, 1.0], [1e-9, 0.99999994], [0.99999994, 1e-9], [0.5, 0.5], [1.0, 0.0]]
    cdf_rows = np.asarray(want.col_cdf)
    pick = r.integers(0, cdf_rows.shape[0], 64), r.integers(0, cdf_rows.shape[1], 64)
    u2[6:70, 0] = np.asarray(want.row_cdf)[pick[0]]  # exact ties with the row CDF
    u2[6:70, 1] = cdf_rows[pick]  # and with column CDF entries
    h, w = cdf_rows.shape
    row_j = np.clip(np.asarray(jnp.searchsorted(want.row_cdf, jnp.asarray(u2[:, 0]))), 0, h - 1)
    col_j = np.clip(np.asarray(jenv.jax_searchsorted_rows(want.col_cdf[row_j], jnp.asarray(u2[:, 1]))), 0, w - 1)
    row, col = tenv.sample_env_texel(got, torch.as_tensor(u2))
    np.testing.assert_array_equal(row.numpy(), row_j)
    np.testing.assert_array_equal(col.numpy(), col_j)
    # the reference's own count, in numpy
    np.testing.assert_array_equal(col.numpy(), np.clip((cdf_rows[row_j] < u2[:, 1:2]).sum(-1), 0, w - 1))

    ref = jax.jit(jenv.sample_env)(want, jnp.asarray(u2))
    es = tenv.sample_env(got, torch.as_tensor(u2))
    np.testing.assert_array_equal(es.radiance.numpy(), np.asarray(ref.radiance))
    np.testing.assert_array_equal(es.pdf.numpy(), np.asarray(ref.pdf))
    np.testing.assert_allclose(es.direction.numpy(), np.asarray(ref.direction), rtol=1e-6, atol=1e-7)

    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for dirs in (d, es.direction.numpy()):
        pdf_j = np.asarray(jax.jit(jenv.pdf_env_direction)(want, jnp.asarray(dirs)))
        np.testing.assert_array_equal(tenv.pdf_env_direction(got, torch.as_tensor(dirs)).numpy(), pdf_j)
    rad_j = np.asarray(jax.jit(jenv.env_radiance)(want, jnp.asarray(d)))
    np.testing.assert_array_equal(tenv.env_radiance(got, torch.as_tensor(d)).numpy(), rad_j)


def test_eval_all_matches_jax():
    """wo above the surface (tests/test_disney.py's domain), wi on both sides
    so that glass transmission is evaluated too."""
    r = np.random.default_rng(12)
    n = 2000
    vals = [random_material(r) for _ in range(n)]
    wo = rand_dir_upper(r, n)
    wi = r.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    f_j, pdf_j = jax.jit(jd.eval_all)(to_jax_mat(vals), jnp.asarray(wo), jnp.asarray(wi))
    f_t, pdf_t = td.eval_all(to_port_mat(vals), torch.as_tensor(wo), torch.as_tensor(wi))
    f_j, pdf_j, f_t, pdf_t = np.asarray(f_j), np.asarray(pdf_j), f_t.numpy(), pdf_t.numpy()
    fin = np.isfinite(f_j).all(-1) & np.isfinite(f_t).all(-1) & np.isfinite(pdf_j) & np.isfinite(pdf_t)
    assert fin.mean() > 0.99 and (wi[:, 2] < 0).mean() > 0.4 and (pdf_j[wi[:, 2] < 0] > 0).any()
    np.testing.assert_array_equal(np.isfinite(f_t).all(-1), np.isfinite(f_j).all(-1))
    np.testing.assert_allclose(f_t[fin], f_j[fin], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(pdf_t[fin], pdf_j[fin], rtol=5e-3, atol=1e-4)
