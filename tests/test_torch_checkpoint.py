"""Checkpoint and resume in the port: the wavefront's drained checkpoints
(render/wavefront.py), the film's checkpoint files (render/film.py), the
CLI's ``--checkpoint`` and ``tools/render_production.py``'s segments.

A frame stopped after a few launches (``max_launches``) with a checkpoint
written after each, then resumed from it, traces exactly the uninterrupted
frame's rays: every work item seeds its stream from its id alone and the
plain traversal answers each ray on its own.  Its image passes the golden
rule of tests/test_golden.py against the uninterrupted frame and against the
JAX package's checkpointed frame (rays within 0.5%, as
tests/test_torch_wavefront.py holds the uninterrupted frames).
"""
import dataclasses
import functools
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.ops import fused2 as jf2
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import wavefront as twf
from owl_path_tracer_tpu_torch.tools import render_production
from owl_path_tracer_tpu_torch.utils import cli as tcli
from owl_path_tracer_tpu_torch.utils.image import read_png

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
SIZE, LANES = 16, 128


def golden(img, want, rays, rays_want):
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want, (rays, rays_want)


@functools.lru_cache(maxsize=None)
def cornell(use_nee: bool):
    scene = compile_scene(ASSETS, "cornell-box", (SIZE, SIZE), env_map_path=None if use_nee else "environment.hdr",
                          device="cpu")
    settings = RenderSettings(width=SIZE, height=SIZE, max_samples=2, max_path_depth=4, environment_auto=True,
                              use_nee=use_nee)
    return scene, settings, tfilm.make_accel(scene, "fused2")


def render(scene, settings, accel, **kw):
    kw = dict(lanes=LANES, fused2_sort=True, iters_per_launch=2) | kw
    img, rays = twf.render_image_wavefront(scene, settings, accel, **kw)
    return img.numpy(), rays


def stop_and_resume(path, scene, settings, accel, **kw):
    """Two launches with a checkpoint after each, then a rerun from it."""
    render(scene, settings, accel, checkpoint_path=str(path), checkpoint_every_s=0.0, max_launches=2, **kw)
    with np.load(path) as ck:
        done = int(ck["work_counter"])
    assert 0 < done < settings.width * settings.height * settings.max_samples, "stopped outside the frame"
    return render(scene, settings, accel, checkpoint_path=str(path), **kw)


@pytest.mark.parametrize("form", ["no NEE", "NEE separate", "NEE deferred"])
def test_resume_gives_the_uninterrupted_frame(tmp_path, capsys, form):
    scene, settings, accel = cornell(form != "no NEE")
    kw = dict(fused_nee=form == "NEE deferred")
    want, rays_want = render(scene, settings, accel, **kw)
    img, rays = stop_and_resume(tmp_path / "frame.ck", scene, settings, accel, progress=True, **kw)
    assert rays == rays_want
    golden(img, want, rays, rays_want)
    out = capsys.readouterr().out
    assert "[wavefront] checkpoint @" in out and "[wavefront] resumed at work item" in out
    # each checkpoint reports what its drain and its write took
    assert len(re.findall(r"drain [0-9.]+ s, write [0-9.]+ s", out)) == out.count("[wavefront] checkpoint @") == 2


def test_checkpointed_frame_matches_jax(tmp_path):
    """Both packages stop after one launch (a drained checkpoint) and resume."""
    js = jscene.compile_scene(ASSETS, "cornell-box", (SIZE, SIZE))
    jset = jscene.RenderSettings(width=SIZE, height=SIZE, max_samples=2, max_path_depth=4, environment_auto=True)
    jaccel = jf2.build_fused2_scene(js, mxu=False)
    jkw = dict(accel=jaccel, lanes=LANES, film_mode="scatter", iters_per_launch=2,
               checkpoint_path=str(tmp_path / "jax.ck"), checkpoint_every_s=0.0)
    jwf.render_image_wavefront(js, jset, max_launches=1, **jkw)
    want, rays_want = jwf.render_image_wavefront(js, jset, **jkw)
    scene, settings, _ = cornell(False)
    img, rays = stop_and_resume(tmp_path / "port.ck", scene, settings, tf2.build_fused2_scene(scene, mxu=False),
                                fused2_sort=False)
    golden(img, np.asarray(want), rays, rays_want)


def test_guard_refuses_another_configuration(tmp_path):
    scene, settings, accel = cornell(False)
    path = tmp_path / "frame.ck"
    render(scene, settings, accel, checkpoint_path=str(path), checkpoint_every_s=0.0, max_launches=1)
    mats = scene.materials
    brighter = dataclasses.replace(scene, materials=dataclasses.replace(mats, emission=mats.emission * 2))
    nee_scene, nee_settings, nee_accel = cornell(True)
    cases = {
        "scene": (brighter, settings, accel, {}),
        "accel": (scene, settings, tfilm.make_accel(scene, "fused2-bf16"), {}),
        "sort": (scene, settings, accel, dict(fused2_sort=False)),
        "fused_nee": (scene, settings, accel, dict(fused_nee=True)),
        "lanes": (scene, settings, accel, dict(lanes=2 * LANES)),
        "spp": (scene, dataclasses.replace(settings, max_samples=4), accel, {}),
        "sample_base": (scene, settings, accel, dict(sample_base=2)),
        "settings": (scene, dataclasses.replace(settings, environment_intensity=2.0), accel, {}),
    }
    for key, (sc, st, ac, kw) in cases.items():
        with pytest.raises(ValueError, match=rf"mismatched: \[.*'{key}'.*\]"):
            render(sc, st, ac, checkpoint_path=str(path), **kw)
    with pytest.raises(ValueError, match="'nee'"):
        render(nee_scene, nee_settings, nee_accel, checkpoint_path=str(path))


def test_drain_that_ends_busy_raises_and_writes_nothing(tmp_path, monkeypatch):
    scene, settings, accel = cornell(False)
    monkeypatch.setattr(twf, "DRAIN_LAUNCHES", 1)  # one launch of 2 steps cannot end depth-4 paths
    path = tmp_path / "frame.ck"
    with pytest.raises(RuntimeError, match="did not drain"):
        render(scene, settings, accel, checkpoint_path=str(path), checkpoint_every_s=0.0)
    assert list(tmp_path.iterdir()) == []


def test_film_checkpoint_round_trip_and_jax_files(tmp_path):
    scene, settings, _ = cornell(False)
    film = tfilm.add_samples(scene, settings, tfilm.new_film(settings, device="cpu"), 1,
                             accel=tfilm.make_accel(scene, "cluster"))
    tfilm.save_checkpoint(tmp_path / "port", film)  # numpy appends .npz, as for the JAX package
    back = tfilm.load_checkpoint(tmp_path / "port.npz", device="cpu")
    assert torch.equal(back.acc, film.acc) and torch.equal(back.rng, film.rng)
    assert (back.spp_done, back.width, back.height) == (1, SIZE, SIZE) and back.rng.dtype == torch.int64
    jset = jscene.RenderSettings(width=SIZE, height=SIZE, max_samples=1, max_path_depth=4)
    jfilm.save_checkpoint(tmp_path / "jax", jfilm.new_film(jset))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["acc", "height", "rng", "spp_done", "width"]
        assert a["rng"].dtype == b["rng"].dtype == np.uint32
    # each package reads the other's file
    jax_film = tfilm.load_checkpoint(tmp_path / "jax.npz", device="cpu")
    np.testing.assert_array_equal(jax_film.rng.numpy(), np.asarray(jfilm.new_film(jset).rng))
    np.testing.assert_array_equal(np.asarray(jfilm.load_checkpoint(tmp_path / "port.npz").rng),
                                  film.rng.numpy().astype(np.uint32))


def test_cli_checkpoint_resumes(tmp_path, monkeypatch, capsys):
    args = ["--assets", str(ASSETS), "--scene", "cornell-box", "--size", str(SIZE), "--spp", "2", "--depth", "3",
            "--intersector", "fused2", "--renderer", "wavefront", "--lanes", str(LANES), "--no-sweep",
            "--device", "cpu"]
    (want,) = tcli.main([*args, "--out", str(tmp_path / "plain")])
    ck = tmp_path / "frame.ck"
    full = twf.render_image_wavefront
    with monkeypatch.context() as mp:  # the first run stops after one launch, with a checkpoint
        mp.setattr(twf, "render_image_wavefront", functools.partial(full, max_launches=1, iters_per_launch=2))
        tcli.main([*args, "--out", str(tmp_path / "stopped"), "--checkpoint", str(ck), "--checkpoint-every", "0"])
    assert ck.exists()
    (got,) = tcli.main([*args, "--out", str(tmp_path / "resumed"), "--checkpoint", str(ck)])
    assert "[wavefront] resumed at work item" in capsys.readouterr().out
    # the film's sums may bank in another order: at most one 8-bit level apart
    diff = np.abs(read_png(got).astype(int) - read_png(want).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.995


def test_render_production_resumes_from_its_accumulator(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(render_production, "production_settings", lambda assets, spp: (
        "cornell-box", RenderSettings(width=SIZE, height=SIZE, max_samples=spp, max_path_depth=4)))
    args = ["--spp", "2", "--seg-spp", "1", "--lanes", str(LANES), "--device", "cpu"]
    want = render_production.main([*args, "--out-dir", str(tmp_path / "whole")])
    out = tmp_path / "stopped"
    full = render_production.render_image_wavefront
    segments = []

    def stop_at_second(*a, **kw):
        segments.append(kw["sample_base"])
        if len(segments) == 2:
            raise KeyboardInterrupt
        return full(*a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(render_production, "render_image_wavefront", stop_at_second)
        with pytest.raises(KeyboardInterrupt):
            render_production.main([*args, "--out-dir", str(out)])
    assert segments == [0, 1]
    render_production.main([*args, "--out-dir", str(out), "--resume-only"])
    assert "segments done: 1/2 spp" in capsys.readouterr().out
    got = render_production.main([*args, "--out-dir", str(out)])
    assert "[production] resuming after 1/2 spp" in capsys.readouterr().out
    assert got["rays_total"] == want["rays_total"] > 0
    np.testing.assert_array_equal(read_png(out / "car_production_spp2.png"),
                                  read_png(tmp_path / "whole" / "car_production_spp2.png"))
    assert json.loads((out / "car_production_spp2.json").read_text())["rays_total"] == got["rays_total"]
    assert not list(out.glob("*.ck")) and render_production.OUT_DIR.name == "production_out"
