"""The frozen scene generators against ``assets/generate.py`` (imported in
this test process only: it imports the JAX package), the scene files the
program reads, and a harness that loads no JAX."""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import drive, scenes

ROOT = drive.ROOT


@pytest.fixture(scope="module")
def generate():
    spec = importlib.util.spec_from_file_location("assets_generate", ROOT / "assets" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(frozen, original):
    assert [n for n, _ in frozen] == [n for n, _ in original]
    for (_, (v, idx, n)), (_, md) in zip(frozen, original):
        np.testing.assert_array_equal(v, md.vertices)
        np.testing.assert_array_equal(idx, md.indices)
        np.testing.assert_array_equal(n, md.normals)


@pytest.mark.parametrize("sub", [5, 7])
def test_dragon_meshes_equal_the_generator(generate, sub, tmp_path):
    frozen = scenes.dragon_meshes(sub)
    obj = tmp_path / "dragon.obj.scene"
    generate.gen_dragon_scene(obj, sub)
    text = obj.read_text()
    assert scenes.obj_text(frozen) == text
    if sub == 5:
        _same(frozen, [
            ("dragon", generate.bumpy_blob(np.array([0, 1.0, 0.0]), 0.9, sub, "dragon")),
            ("ground", generate.quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6], "ground")),
            ("areaLight", generate.quad([-1.5, 4, -1.5], [-1.5, 4, 1.5], [1.5, 4, 1.5], [1.5, 4, -1.5],
                                        "areaLight"))])


@pytest.mark.parametrize("sub", [1, 3])
def test_reference_soup_is_what_the_program_loads(sub, tmp_path):
    """The reference's triangles equal, value for value, those the program's
    scene compiler makes of the written files."""
    from owl_path_tracer_tpu_torch.models.scene import compile_scene

    cfg = json.loads((drive.HERE / "configs" / "dragon7.json").read_text())
    cfg["scene"]["subdivision"] = sub
    out = scenes.materialize(cfg, tmp_path)
    with np.load(out / "reference.npz") as z:
        tri_p, tri_n, tri_mat = z["tri_p"], z["tri_n"], z["tri_mat"]
    sc = compile_scene(out, cfg["scene"]["name"], (16, 12), env_map_path=None, device="cpu")
    idx = sc.tri_idx.long()
    np.testing.assert_array_equal(sc.vertices[idx].numpy(), tri_p)
    np.testing.assert_array_equal(sc.normals[idx].numpy(), tri_n)
    np.testing.assert_array_equal(sc.tri_mat.numpy(), tri_mat)
    assert tri_p.shape[0] == 20 * 4**sub + 4


def test_the_harness_loads_no_jax():
    """A run's modules (a tiny CPU run of every cell, in a fresh process)
    hold no module whose top-level name is JAX's or the JAX package's."""
    code = (
        "import sys\n"
        "from benchmark import run, control, drive\n"
        "from benchmark.conftest import run_tiny, tiny_cell\n"
        "for c in ('dragon7.wavefront', 'dragon7.scan'):\n"
        "    assert run_tiny(tiny_cell(c), trace=True)['correct']\n"
        "print(run.forbidden_modules())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    for name in ("owl_path_tracer_tpu_torch.fake", "jaxlike", "owl_path_tracer_tpu.fake", "jax.fake"):
        monkeypatch.setitem(sys.modules, name, object())
    got = run.forbidden_modules()
    assert "owl_path_tracer_tpu.fake" in got and "jax.fake" in got
    assert "owl_path_tracer_tpu_torch.fake" not in got and "jaxlike" not in got
