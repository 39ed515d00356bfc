"""The port's CLI (``utils/cli.py``), settings parser and PNG writers against
the JAX package's: sweep values, ``{:.1f}`` naming, settings.json parsing, a
material change that leaves its input alone, an end-to-end sweep on the CPU
through the fused kernel's plain version, the refusals raising, and the
``bvh`` intersector (once unported) rendering the cluster frame."""
import argparse
import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from owl_path_tracer_tpu.utils import cli as jcli
from owl_path_tracer_tpu.utils import image as jimage
from owl_path_tracer_tpu.utils import parser as jparser
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models.scene import scene_from_arrays
from owl_path_tracer_tpu_torch.ops import fused as tfu
from owl_path_tracer_tpu_torch.utils import cli as tcli
from owl_path_tracer_tpu_torch.utils import image as timage
from owl_path_tracer_tpu_torch.utils import parser as tparser

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
SWEEP = {
    "scene": "sphere", "buffer_size": [16, 16], "max_samples": 1, "max_path_depth": 2,
    "environment_use": False, "environment_auto": True, "environment_color": [1, 1, 1],
    "environment_intensity": 1.0,
    "test": {"name": "Roughness", "material_name": "sphere", "attribute_name": "roughness",
             "material_type": 2, "values": [0.0, 1.0], "step_size": 0.5},
}


@pytest.mark.parametrize("values,step", [([0.0, 1.0], 0.25), ([(0, 0, 0), (1, 2, 3)], 0.5), ([0.2, 0.9], 0.3)])
def test_sweep_values_match_jax(values, step):
    assert tcli.sweep_values(values, step) == jcli.sweep_values(values, step)


@pytest.mark.parametrize("value", [0.25, 0.0, 1.0, 0.75, (1.0, 0.5, 0.0), (0.33, 0.66, 0.99)])
def test_format_value_matches_jax(value):
    assert tcli.format_value(value) == jcli.format_value(value)


def test_parse_settings_matches_jax():
    got = tparser.parse_settings(ASSETS / "settings.json")
    want = jparser.parse_settings(ASSETS / "settings.json")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.test.attribute_name == "subsurface" and got.buffer_size == (1080, 1440)


def test_set_material_attribute_leaves_its_input_alone():
    cam = tcam.make_camera(tparser.CameraDesc((0, 0, 3), (0, 0, 0), (0, 1, 0), 45), (8, 8), device="cpu")
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    scene = scene_from_arrays(v, np.asarray([[0, 1, 2]], np.int32), tmat.single(device="cpu"),
                              np.zeros(1, np.int32), cam, device="cpu")
    rough, base = scene.materials.roughness.clone(), scene.materials.base_color.clone()
    s2 = tcli.set_material_attribute(scene, 0, "roughness", 0.123)
    s3 = tcli.set_material_attribute(scene, 0, "base_color", (0.1, 0.2, 0.3))
    assert float(s2.materials.roughness[0]) == pytest.approx(0.123)
    np.testing.assert_allclose(s3.materials.base_color[0].numpy(), (0.1, 0.2, 0.3), rtol=1e-7)
    assert torch.equal(scene.materials.roughness, rough) and torch.equal(scene.materials.base_color, base)
    assert s2.vertices is scene.vertices  # everything else is shared, not copied
    with pytest.raises(ValueError):
        tcli.set_material_attribute(scene, 0, "nonsense", 1.0)


def test_png_writer_stores_what_pil_stores(tmp_path):
    rgba = np.random.default_rng(0).integers(0, 256, (9, 13, 4), dtype=np.uint8)
    timage.write_png_rgba8(tmp_path / "port.png", rgba)
    jimage.write_png_rgba8(tmp_path / "pil.png", rgba)
    port, pil = (Image.open(tmp_path / f"{n}.png") for n in ("port", "pil"))
    assert port.mode == pil.mode == "RGBA" and port.size == pil.size == (13, 9)
    np.testing.assert_array_equal(np.asarray(port), np.asarray(pil))
    rgb = np.random.default_rng(1).uniform(-0.5, 1.5, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.quantize_rgba8(rgb), jimage.quantize_rgba8(rgb))
    timage.write_png_rgb(tmp_path / "port_rgb.png", rgb)
    jimage.write_png_rgb(tmp_path / "jax_rgb.png", rgb)
    np.testing.assert_array_equal(timage.read_png(tmp_path / "port_rgb.png"), timage.quantize_rgba8(rgb))
    np.testing.assert_array_equal(timage.read_png(tmp_path / "port_rgb.png"), jimage.read_png(tmp_path / "jax_rgb.png"))


def _assets(tmp_path, settings):
    work = tmp_path / "assets"
    work.mkdir()
    for f in ("sphere.json", "sphere.obj.scene"):
        shutil.copy(ASSETS / f, work / f)
    (work / "settings.json").write_text(json.dumps(settings))
    return work


def _args(assets, out, **kw):
    base = dict(assets=str(assets), scene=None, out=str(out), spp=None, depth=None, size=None,
                intersector="cluster", cluster_size=64, pixel_chunk=256, nee=False, no_sweep=False,
                renderer="scan", lanes=1024, fused2_block=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_cli_sweep_end_to_end(tmp_path, monkeypatch):
    """The sweep through the port's fused kernel (plain version on the CPU):
    the JAX package's file names, and PNGs that decode to quantize_rgba8 of
    the rendered images."""
    work = _assets(tmp_path, SWEEP)
    want = jcli.run_sweep(_args(work, tmp_path / "jax"))
    frames = []
    render = tcli._render
    monkeypatch.setattr(tcli, "_render", lambda *a: frames.append(render(*a)) or frames[-1])
    launches = tfu.LAUNCHES[tfu.ENTRY]
    got = tcli.run_sweep(_args(work, tmp_path / "port", intersector="fused", device="cpu"))
    assert [p.name for p in got] == [p.name for p in want] == [
        "sphere_Roughness_roughness(0.0).png", "sphere_Roughness_roughness(0.5).png",
        "sphere_Roughness_roughness(1.0).png",
    ]
    assert len(frames) == 3 and tfu.LAUNCHES[tfu.ENTRY] == launches  # CPU: the plain version, no launch
    for path, img in zip(got, frames):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), timage.quantize_rgba8(img))
    assert frames[0].max() > 0 and not np.array_equal(frames[0], frames[2])  # roughness changed the image


@pytest.mark.parametrize("renderer", ["scan", "wavefront"])
def test_cli_main_single_frame(tmp_path, renderer):
    work = _assets(tmp_path, {k: v for k, v in SWEEP.items() if k != "test"})
    out = tcli.main(["--assets", str(work), "--out", str(tmp_path / "out"), "--device", "cpu",
                     "--intersector", "fused", "--cluster-size", "64", "--pixel-chunk", "256",
                     "--renderer", renderer, "--lanes", "256"])
    assert [p.name for p in out] == ["sphere.png"]
    img = np.asarray(Image.open(out[0]))
    assert img.shape == (16, 16, 4) and img[..., :3].max() > 0


@pytest.mark.parametrize("extra,error,match", [
    (["--checkpoint", "film.ck"], ValueError, "needs --renderer wavefront"),  # the scan renderer has none
    # bvh is ported: it renders, and its PNG is the cluster one
    (["--intersector", "bvh", "--cluster-size", "64", "--pixel-chunk", "256"], None, None),
    # brute is ported: it gets past make_accel to the scan renderer's refusal
    (["--intersector", "brute", "--checkpoint", "film.ck"], ValueError, "needs --renderer wavefront"),
], ids=["checkpoint", "bvh", "brute"])
def test_unported_parts_raise(tmp_path, extra, error, match):
    """Refusals raise before any PNG is written; the once-unported ``bvh``
    case now renders the cluster frame's PNG."""
    work = _assets(tmp_path, SWEEP)
    if error is None:
        outs = {}
        for kind, args in (("bvh", extra), ("cluster", ["--intersector", "cluster", *extra[2:]])):
            outs[kind] = [np.asarray(Image.open(p)) for p in tcli.main(
                ["--assets", str(work), "--out", str(tmp_path / kind), "--device", "cpu", *args])]
        assert len(outs["bvh"]) == 3 and outs["bvh"][0][..., :3].max() > 0
        for got, want in zip(outs["bvh"], outs["cluster"]):
            np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(error, match=match):
        tcli.main(["--assets", str(work), "--out", str(tmp_path / "out"), "--device", "cpu", *extra])
    assert not list((tmp_path / "out").glob("*.png"))


def test_default_device_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli.main(["--assets", str(_assets(tmp_path, SWEEP)), "--out", str(tmp_path / "out")])
