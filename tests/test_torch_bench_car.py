"""The benchmark's car cell (``car.scan``: upstream's ``settings.json`` car,
depth 16, on the scan renderer and K5) on the CPU at small sizes: the
program against the plain reference, planted faults of the glass and
clearcoat lobes that the comparison has to catch, the configuration against
the upstream files it copies, the settings' sweep as one frame, and what the
configuration's one cut (the Ground texture) changes."""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, drive, scenes
from benchmark.conftest import run_tiny, tiny_cell
from benchmark.reference.traversal import closest_hit
from owl_path_tracer_tpu_torch.models.scene import compile_scene
from owl_path_tracer_tpu_torch.ops import disney
from owl_path_tracer_tpu_torch.render import film
from owl_path_tracer_tpu_torch.utils import cli

torch.set_num_threads(2)

CELL = "car.scan"
ASSETS = drive.ROOT / "assets"
# 48x64 in chunks of 1,280 pixels (the last one 512): the glass, clearcoat
# and anisotropic-metal spheres each cover pixels
SIZE = dict(width=48, height=64, pixel_chunk=1280)
SEED = 2**31 + 77


def _cell(**over) -> drive.Cell:
    return tiny_cell(CELL, **{**SIZE, **over})


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The harness's scene files of the car (the size is no part of them)."""
    return scenes.materialize(_cell().config, tmp_path_factory.mktemp("scenes"))


def test_program_agrees_with_reference():
    res = run_tiny(_cell(), seed=SEED)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0


def test_tiny_frame_sees_the_lobes_it_checks(scene_dir):
    """The primary rays of the test's frame meet the glass, the clearcoat
    body in view (``BodyMat_BK``) and the anisotropic metal."""
    cell = _cell()
    ref = drive.reference(cell.config)
    rs = ref.load_scene(cell.config, scene_dir, cell.traffic["cluster_size"], "cpu")
    w, h = SIZE["width"], SIZE["height"]
    origin, llc, horizontal, vertical = rs.camera
    lin = torch.arange(w * h)
    xy = (torch.stack([lin % w, lin // w], -1).float() + 0.5) / torch.tensor([w, h]).float()
    d = llc + xy[:, :1] * horizontal + xy[:, 1:] * vertical - origin
    d = d / d.norm(dim=-1, keepdim=True)
    _, tri, *_ = closest_hit(origin.expand(d.shape), d, rs.clusters)
    seen = {cell.config["scene"]["materials"][int(k)]["name"]: int((rs.tri_mat[tri[tri >= 0]] == k).sum())
            for k in rs.tri_mat[tri[tri >= 0]].unique()}
    for name in ("WindowGlassMat", "BodyMat_BK", "CarbonBlack"):
        assert seen.get(name, 0) >= 20, seen


# ── planted faults: each must turn ``correct`` false ──────────────────────


def fault_glass_reflects(monkeypatch):
    """The glass lobe reflects wherever it could refract (its choice draw
    read as 0)."""
    inner = disney.sample_glass
    monkeypatch.setattr(disney, "sample_glass",
                        lambda mat, wo, u_wh, u_choice, *a: inner(mat, wo, u_wh, torch.zeros_like(u_choice), *a))


def fault_clearcoat_dropped(monkeypatch):
    """The clearcoat lobe is never chosen (its weight read as 0)."""
    inner = disney.lobe_probabilities
    monkeypatch.setattr(disney, "lobe_probabilities",
                        lambda mat: inner(dataclasses.replace(mat, clearcoat=torch.zeros_like(mat.clearcoat))))


def _checks(cell, scene_dir, seed: int) -> tuple:
    """One pass of the program on the plain cluster query (bit-equal to K5's
    plain version; no fault here is in the traversal) against the
    reference's pass, by the harness's comparison -> (correct, checks)."""
    prog = drive.Program(cell, scene_dir, seed, "cpu", "cluster")
    img, rays = prog.run_pass(0)
    ref = drive.reference(cell.config)
    rs = ref.load_scene(cell.config, scene_dir, cell.traffic["cluster_size"], "cpu")
    ref_img, ref_rays, *_ = ref.render_pass(rs, prog.sample_base(0), *ref.MODES[cell.traffic["renderer"]])
    return check.judge(check.compare(prog.pass_radiance([img], 0), ref_img.numpy(), rays, ref_rays), cell.limits)


def test_sound_pass_on_the_cluster_query_is_correct(scene_dir):
    correct, checks = _checks(_cell(), scene_dir, SEED)
    assert correct, checks


def test_glass_reflecting_is_not_correct(monkeypatch, scene_dir):
    fault_glass_reflects(monkeypatch)
    correct, checks = _checks(_cell(), scene_dir, SEED)
    assert not correct, checks


def test_clearcoat_dropped_is_not_correct(monkeypatch, scene_dir):
    """At 135x180: a clearcoat fault shows only in the paths that leave a
    clearcoat body for the light, and the frame is dark elsewhere, so the
    image mean sees it (``mean_gap_pct``), once the frame holds enough such
    paths; 48x64 holds too few to see it on every sample base."""
    fault_clearcoat_dropped(monkeypatch)
    correct, checks = _checks(_cell(width=135, height=180, pixel_chunk=135 * 180), scene_dir, SEED)
    assert not correct, checks
    assert checks["mean_gap_pct"]["value"] > checks["mean_gap_pct"]["limit"], checks


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys\nimport benchmark.reference.render\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'owl_path_tracer_tpu', 'owl_path_tracer_tpu_torch'))\n"
            "assert not bad, bad\nprint('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=drive.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "clean", proc.stderr


# ── the configuration against upstream's files ────────────────────────────


def test_configuration_is_upstreams_settings_but_for_its_cut():
    """``configs/car.json`` holds ``assets/car.json``'s camera and every
    material field in its order, and ``assets/settings.json``'s size, depth
    and environment; the one difference is ``Ground``'s texture, which
    ``reduced`` names, here and in ``BENCHMARK.json``."""
    cfg = drive.load_cell(CELL).config
    car = json.loads((ASSETS / "car.json").read_text())
    settings = json.loads((ASSETS / "settings.json").read_text())
    sc, r = cfg["scene"], cfg["render"]
    assert settings["scene"] == sc["name"] == cfg["name"] == "car"
    assert sc["camera"] == car["camera"]
    want = copy.deepcopy(car["materials"])
    ground = next(m for m in want if m["name"] == "Ground")
    assert ground["use_texture"] is True
    ground["use_texture"] = False
    assert [list(m) for m in sc["materials"]] == [list(m) for m in car["materials"]]
    assert sc["materials"] == want
    assert [r["width"], r["height"]] == settings["buffer_size"]
    assert r["max_path_depth"] == settings["max_path_depth"]
    for key in ("environment_use", "environment_auto", "environment_color", "environment_intensity"):
        assert r[key] == settings[key], key
    assert r["use_nee"] is False and "reference" not in cfg
    entry = next(c for c in json.loads((drive.ROOT / "BENCHMARK.json").read_text())["configs"] if c["name"] == "car")
    assert entry["reduced"] == cfg["reduced"] == ["Ground.use_texture"]
    assert entry["file"] == "benchmark/configs/car.json"
    assert scenes.pinned_obj(sc)  # the committed stand-in, as its hash pins it


# ── the sweep is one frame ────────────────────────────────────────────────


def _ensure_texture():
    if not (ASSETS / "Ground-textures" / "uv-texture.png").exists():
        from owl_path_tracer_tpu_torch.tools import probe_common

        probe_common.ensure_texture("Ground-textures/uv-texture.png")


def test_cli_sweep_writes_five_equal_images(tmp_path):
    """``settings.json``'s test block sweeps Light's ``subsurface`` over
    five values; no shading reads it, so the CLI writes five byte-equal
    PNGs."""
    _ensure_texture()
    paths = cli.main(["--assets", str(ASSETS), "--out", str(tmp_path), "--size", "8", "--spp", "1",
                      "--intersector", "fused", "--device", "cpu"])
    assert [p.name for p in paths] == [f"car_Light_subsurface({v}).png" for v in
                                       (cli.format_value(x) for x in (0.0, 0.25, 0.5, 0.75, 1.0))]
    data = [p.read_bytes() for p in paths]
    assert all(d == data[0] for d in data[1:])


def _scan_pass(prog, scene=None, accel=None):
    """The harness's pass 0 on a fresh film, on ``scene`` and ``accel`` where
    given -> (image, live rays)."""
    prog.scene = scene or prog.scene
    prog.accel = accel or prog.accel
    prog.film_state, prog.rays_before = film.new_film(prog.settings, device="cpu"), 0
    return prog.run_pass(0)


@pytest.fixture(scope="module")
def small(scene_dir):
    """The cell's program at 24x32 on the harness's scene files, on the plain
    cluster query (what these tests hold is in the scene and the shading,
    not in the traversal)."""
    return drive.Program(_cell(width=24, height=32, pixel_chunk=24 * 32), scene_dir, SEED, "cpu", "cluster")


def test_harness_sweep_is_one_frame(small):
    """The harness's pass with Light's ``subsurface`` at each swept value:
    the same image bit for bit and the same live rays."""
    base = small.scene
    light = [m["name"] for m in small.cell.config["scene"]["materials"]].index("Light")
    got = [_scan_pass(small, cli.set_material_attribute(base, light, "subsurface", v))
           for v in cli.sweep_values([0.0, 1.0], 0.25)]
    small.scene = base
    assert len(got) == 5 and got[0][1] > 0
    for img, rays in got[1:]:
        assert np.array_equal(img, got[0][0]) and rays == got[0][1]


def test_ground_texture_changes_no_pixel(small):
    """``assets/`` with the Ground texture (``use_texture`` true) against the
    harness's scene without it: the stand-in's Ground quad faces down, so a
    path that meets it from above scatters below it and leaves the scene,
    and the texture changes no pixel and no ray count of this frame."""
    _ensure_texture()
    textured = compile_scene(ASSETS, "car", (24, 32), env_map_path=None, device="cpu")
    assert film.scene_has_textures(textured) and not film.scene_has_textures(small.scene)
    want = _scan_pass(small)
    accel = film.make_accel(textured, "cluster", cluster_size=small.cell.traffic["cluster_size"])
    base_scene, base_accel = small.scene, small.accel
    try:
        img, rays = _scan_pass(small, textured, accel)
    finally:
        small.scene, small.accel = base_scene, base_accel
    assert rays == want[1] > 0 and np.array_equal(img, want[0])
