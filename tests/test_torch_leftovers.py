"""The small modules ported last, against the JAX package's: ``save_obj``
and ``write_hdr`` write the same bytes, ``sample_bilinear`` and
``sample_environment(bilinear=True)`` the same texels, ``fused2_traverse``
(the unpacked-ray wrapper) the same rows as JAX's on the 3000-triangle soup
(tests/test_torch_fused2.py's tolerances), and the tools
``render_gallery``, ``measure_balance`` and ``bench_scaling`` the same
images and counts as the JAX package's tools at a toy size (the JAX tools on
a 2-device mesh of the conftest's virtual CPU devices, the port's on two
gloo processes)."""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from owl_path_tracer_tpu.models.scene import RenderSettings as JSettings
from owl_path_tracer_tpu.models.scene import compile_scene as jcompile
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.ops import texture as jtex
from owl_path_tracer_tpu.parallel import shard as jshard
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.utils import image as jimage
from owl_path_tracer_tpu.utils import obj as jobj
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.ops import texture as ttex
from owl_path_tracer_tpu_torch.tools import bench_scaling, measure_balance, render_gallery
from owl_path_tracer_tpu_torch.utils import image as timage
from owl_path_tracer_tpu_torch.utils import obj as tobj
from test_torch_fused2 import _assert_hits_match, setup  # noqa: F401  (setup: the soup fixture)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
ASSETS = REPO / "assets"


def test_save_obj_writes_the_jax_bytes(tmp_path):
    """Two objects (the cornell box's first two meshes, re-indexed locally)."""
    meshes = tobj.load_obj(ASSETS / "cornell-box.obj.scene")[:2]
    jmeshes = jobj.load_obj(ASSETS / "cornell-box.obj.scene")[:2]
    tobj.save_obj(tmp_path / "port.obj", meshes)
    jobj.save_obj(tmp_path / "jax.obj", jmeshes)
    data = (tmp_path / "port.obj").read_bytes()
    assert data == (tmp_path / "jax.obj").read_bytes() and data.count(b"\nf ") > 2
    again = tobj.load_obj(tmp_path / "port.obj", cache=False)
    np.testing.assert_allclose(again[1][1].vertices, meshes[1][1].vertices, atol=1e-6)


def test_write_hdr_writes_the_jax_bytes(tmp_path):
    r = np.random.default_rng(0)
    img = (r.lognormal(0, 3, (5, 7, 3)) * (r.random((5, 7, 1)) > 0.2)).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 1e-35  # below the RGBE floor: written as zero
    img[1, 1] = 3e5
    np.testing.assert_array_equal(timage._float_to_rgbe(img), jimage._float_to_rgbe(img))
    timage.write_hdr(tmp_path / "port.hdr", img)
    jimage.write_hdr(tmp_path / "jax.hdr", img)
    assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()
    back = timage.read_hdr(tmp_path / "port.hdr")  # RGBE: 8 bits of mantissa below each pixel's largest channel
    assert (np.abs(back - img) <= img.max(-1, keepdims=True) * 2.0 ** -7 + 1e-32).all()


def test_sample_bilinear_matches_jax():
    r = np.random.default_rng(1)
    tex = r.random((6, 9, 3)).astype(np.float32)
    uv = r.uniform(-0.2, 1.2, (257, 2)).astype(np.float32)  # clamp addressing outside [0,1]
    got = ttex.sample_bilinear(torch.as_tensor(tex), torch.as_tensor(uv)).numpy()
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    corners = ttex.sample_bilinear(torch.as_tensor(tex), torch.tensor([[0.5 / 9, 0.5 / 6]]))
    np.testing.assert_allclose(corners.numpy()[0], tex[0, 0], rtol=1e-6)  # a texel centre is the texel


@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_environment_matches_jax(bilinear):
    r = np.random.default_rng(2)
    env = r.random((8, 16, 3)).astype(np.float32)
    d = r.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = ttex.sample_environment(torch.as_tensor(env), torch.as_tensor(d), bilinear=bilinear).numpy()
    want = np.asarray(jtex.sample_environment(jnp.asarray(env), jnp.asarray(d), bilinear=bilinear))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_fused2_traverse_matches_jax(setup, any_hit):  # noqa: F811
    jfb, tfb, o, d, tmax, _, _ = setup
    got = tf2.fused2_traverse(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax), tfb, block=128,
                              any_hit=any_hit)
    packed = tf2.fused2_traverse_packed(tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)),
                                        tfb, block=128, mode="any_hit" if any_hit else "closest")
    assert torch.equal(got, packed)
    want = np.asarray(jf2.fused2_traverse(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jfb, interpret=True,
                                          block=128, any_hit=any_hit))
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 4], want[:, 4])  # hit / occlusion flags
    assert 0 < got[:, 4].sum() < len(got)
    if not any_hit:
        hit = got[:, 4] > 0
        _assert_hits_match((got[:, 0], got[:, 3], got[:, 1:3], got[:, 16:32]),
                           (want[:, 0], want[:, 3], want[:, 1:3], want[:, 16:32]))
        assert hit.any()


def test_render_gallery_writes_the_jax_frame(tmp_path):
    """The small set's cube (scan renderer, cluster C=128) into a temporary
    directory, nothing under docs/gallery/; its PNG is the quantized JAX
    frame to 1 of 255 (the port's scan images meet the golden rule, not the
    bits: tests/test_torch_film.py)."""
    gallery = REPO / "docs" / "gallery"
    before = sorted(p.name for p in gallery.glob("*")) if gallery.exists() else []
    out = render_gallery.main(["--device", "cpu", "--scenes", "cube", "--size", "16", "--spp", "2", "--depth", "3",
                               "--out-dir", str(tmp_path)])
    assert out == [tmp_path / "cube.png"]
    assert (sorted(p.name for p in gallery.glob("*")) if gallery.exists() else []) == before
    got = np.asarray(Image.open(out[0])).astype(np.int32)
    s = JSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_auto=True,
                  environment_intensity=1.0)
    scene = jcompile(ASSETS, "cube", (16, 16))
    img = jfilm.render_image(scene, s, pixel_chunk=256, accel=jfilm.make_accel(scene, "cluster", cluster_size=128))
    want = jimage.quantize_rgba8(np.clip(img, 0, 1)).astype(np.int32)
    assert np.abs(got - want).max() <= 1 and (got == want).mean() > 0.99 and got[..., :3].max() > 0


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _jax_tool(module, argv, monkeypatch, capsys):
    """Run the JAX package's tools/<module>.py main() on a 2-device mesh -> its JSON lines."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    monkeypatch.chdir(REPO)
    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(jshard, "make_pixel_mesh", lambda devs=None: jshard.Mesh(np.asarray(devs or devices), ("px",)))
    monkeypatch.setattr(sys, "argv", [module, *argv])
    tool = __import__(module)
    capsys.readouterr()
    tool.main()
    return _json_lines(capsys.readouterr().out)


def test_measure_balance_counts_equal_jax(monkeypatch, capsys):
    argv = ["--sub", "2", "--size", "16", "--spp", "4", "--depth", "3", "--lanes-per-chip", "256"]
    want = _jax_tool("measure_balance", argv, monkeypatch, capsys)
    got = measure_balance.main([*argv, "--device", "cpu", "--ranks", "2"])
    assert [g["split"] for g in got] == [w["split"] for w in want] == ["contiguous", "sample"]
    for g, w in zip(got, want):
        assert g["devices"] == w["devices"] == 2 and g["scene"] == w["scene"] == "dragon"
        for a, b in zip(g["per_chip_rays"], w["per_chip_rays"]):
            assert abs(a - b) <= 0.005 * b, (g, w)
        assert abs(g["load_balance"] - w["load_balance"]) <= 0.01
    assert _json_lines(capsys.readouterr().out) == got


def test_bench_scaling_counts_equal_jax(monkeypatch, capsys):
    argv = ["--scene", "cornell-box", "--size", "16", "--spp", "2", "--depth", "3", "--lanes-per-chip", "256"]
    want = _jax_tool("bench_scaling", argv, monkeypatch, capsys)
    got = bench_scaling.main([*argv, "--device", "cpu", "--max-ranks", "2"])
    assert [g["devices"] for g in got] == [w["devices"] for w in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["image_mean"], w["image_mean"], rtol=1e-3)
        for a, b in zip(g["per_chip_rays"], w["per_chip_rays"]):
            assert abs(a - b) <= 0.005 * b, (g, w)
        assert g["efficiency_vs_1dev"] > 0 and g["device"] == "cpu"
