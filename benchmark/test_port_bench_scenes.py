"""The frozen scene generators against ``assets/generate.py`` (imported in
this test process only: it imports the JAX package), the scene files the
program reads, a scene file pinned by its hash, and a harness that loads no
JAX."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import drive, scenes
from benchmark.conftest import CORNELL_OBJ, cornell_config, tiny_cell

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


def _program_soup(scene_dir, name):
    from owl_path_tracer_tpu_torch.models.scene import compile_scene

    sc = compile_scene(scene_dir, name, (16, 12), env_map_path=None, device="cpu")
    idx = sc.tri_idx.long()
    return sc.vertices[idx].numpy(), sc.normals[idx].numpy(), sc.tri_mat.numpy()


def _same_soup(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_a_file_scene_is_copied_verbatim_and_read_as_the_program_reads_it(tmp_path):
    """Upstream's Cornell box: the bytes are copied as they are, and the
    reference's soup equals, value for value, the one the program's scene
    compiler makes of them (two corners take another face's normal there)."""
    out = scenes.materialize(cornell_config(), tmp_path)
    assert (out / "cornell.obj.scene").read_bytes() == (ROOT / CORNELL_OBJ).read_bytes()
    with np.load(out / "reference.npz") as z:
        soup = z["tri_p"], z["tri_n"], z["tri_mat"]
    _same_soup(soup, _program_soup(out, "cornell"))
    assert soup[0].shape == (17974, 3, 3) and len(set(soup[2].tolist())) == 6


OBJ_FORMS = """# faces of both forms, a fan, a group, an object without a material
o a
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0.5
vn 0 0 1
vn 0 0.6 0.8
vn 0.6 0 0.8
vt 0 0
s 1
f 1/1/1 2/1/2 3/1/3
f 3//3 2//1 4//2
g quad
v 0 0 2
v 1 0 2
v 1 1 2
v 0 1 2
f 5//3 6//2 7//1 8//3
o unlit
f 1//1 2//1 3//1
o a
f 3//2 1//1 2//3
"""


def test_read_obj_reads_as_the_program_reads_it(tmp_path):
    """Each form the reader takes, against the program's scene compiler."""
    mats = [{"name": "quad", "base_color": [0.5, 0.5, 0.5]}, {"name": "a", "base_color": [1, 1, 1], "emission": 2.0}]
    (tmp_path / "forms.json").write_text(json.dumps({"camera": cornell_config()["scene"]["camera"],
                                                     "materials": mats}))
    (tmp_path / "forms.obj.scene").write_text(OBJ_FORMS)
    soup = scenes.read_obj(OBJ_FORMS.encode(), mats)
    _same_soup(soup, _program_soup(tmp_path, "forms"))
    assert soup[2].tolist() == [1, 1, 0, 0, 1]
    # within an object a vertex keeps the normal of its first corner; the next object starts anew
    np.testing.assert_array_equal(soup[1][1, 1], np.float32([0, 0.6, 0.8]))
    np.testing.assert_array_equal(soup[1][4, 2], np.float32([0.6, 0, 0.8]))


@pytest.mark.parametrize("face", ["f 1 2 3", "f 1/1 2/1 3/1", "f -1//1 2//1 3//1"])
def test_read_obj_refuses_faces_it_cannot_read(face):
    text = "o a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\n" + face + "\n"
    with pytest.raises(ValueError, match="OBJ"):
        scenes.read_obj(text.encode(), [{"name": "a"}])


def test_a_wrong_pin_is_refused(tmp_path):
    cfg = cornell_config()
    cfg["scene"]["obj_sha256"] = "0" * 64
    with pytest.raises(ValueError) as err:
        scenes.materialize(cfg, tmp_path)
    msg = str(err.value)
    assert CORNELL_OBJ in msg and "0" * 64 in msg
    assert hashlib.sha256((ROOT / CORNELL_OBJ).read_bytes()).hexdigest() in msg
    assert not any(tmp_path.iterdir())


def test_a_changed_scene_file_fails_its_cached_scene(tmp_path, monkeypatch):
    """The hash is checked in every call, also once the scene is cached."""
    root = tmp_path / "repo"
    (root / "assets").mkdir(parents=True)
    shutil.copy(ROOT / CORNELL_OBJ, root / CORNELL_OBJ)
    monkeypatch.setattr(scenes, "ROOT", root)
    cfg = cornell_config()
    out = scenes.materialize(cfg, tmp_path / "cache")
    assert scenes.materialize(cfg, tmp_path / "cache") == out
    with open(root / CORNELL_OBJ, "a") as f:
        f.write("v 0 0 0\n")
    with pytest.raises(ValueError, match="sha256"):
        scenes.materialize(cfg, tmp_path / "cache")
    cfg["scene"]["obj"] = "../outside.obj"
    with pytest.raises(ValueError, match="outside"):
        scenes.materialize(cfg, tmp_path / "cache")


# the dragon7 scene files as the harness before the file scenes wrote them
DRAGON7_FILES = {
    "dragon7-a14d010392c4": {  # conftest.TINY
        "dragon7.obj.scene": "4aa8e7ace02b42815354fd7c8a877d5df6399d93cf242909866386728561e6eb",
        "reference.npz": "f3f1f8e2df3037bee618271e8a428198f3e32e443df294080769690ee6c80ce8"},
    "dragon7-490c7095dffc": {  # the cells' own size
        "dragon7.obj.scene": "6d0d7f11a9e96dd54e009cd8fe7feac3fff1c18e2efc0b75d1f255ef8233cc44",
        "reference.npz": "a5c3d66c5ff401d79f22f6603d4436bca7cc3892643f9bd49ad968a672ad5410"},
}


@pytest.mark.parametrize("tiny", [True, False])
def test_dragon7_scene_files_are_unchanged(tiny, tmp_path):
    cfg = tiny_cell("dragon7.wavefront").config if tiny else drive.load_cell("dragon7.wavefront").config
    out = scenes.materialize(cfg, tmp_path)
    want = DRAGON7_FILES[out.name]
    assert {f: hashlib.sha256((out / f).read_bytes()).hexdigest() for f in want} == want


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
