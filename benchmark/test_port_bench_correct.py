"""The comparison that decides ``correct``, on the CPU at a tiny size: the
program's passes agree with the plain reference, and the controls and the
planted faults come out as not correct."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmark import check, control, drive
from benchmark.conftest import run_tiny, tiny_cell
from benchmark.reference import render as reference

CELLS = ("dragon7.wavefront", "dragon7.scan")


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    res = run_tiny(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0


def test_program_lower_precision_control_is_not_correct():
    """The wavefront cell's control: the program's own bfloat16 planes."""
    res = run_tiny(tiny_cell("dragon7.wavefront"), accel_kind="fused2-bf16")
    assert not res["correct"], res["checks"]


def test_reference_lower_precision_control_is_not_correct():
    """The scan cell's control: the reference with bfloat16 triangle data."""
    cell = tiny_cell("dragon7.scan")
    correct, checks = check.judge(control.reference_bf16(cell, 5, "cpu"), cell.limits)
    assert not correct, checks


def test_pass_radiance_of_a_progressive_film():
    """A scan pass's own radiance is recovered from two consecutive means."""
    prog = drive.Program.__new__(drive.Program)
    prog.cell = tiny_cell("dragon7.scan")
    prog.spp = 1
    rng = np.random.default_rng(0)
    passes = [rng.random((4, 5, 3), dtype=np.float32) for _ in range(3)]
    means = [np.mean(passes[: k + 1], axis=0, dtype=np.float32) for k in range(3)]
    np.testing.assert_allclose(prog.pass_radiance(means, 2), passes[2], rtol=1e-5, atol=1e-6)


def test_reference_loops_differ_only_on_retries():
    """Both loop forms give the same pass where no bounce retries."""
    cell = tiny_cell("dragon7.scan")
    scene = reference.load_scene(cell.config, drive.scenes.materialize(cell.config), 64, "cpu")
    a = reference.render_pass(scene, 9, "depth", "barycentric")
    b = reference.render_pass(scene, 9, "steps", "barycentric")
    assert a[1] == b[1] and torch.equal(a[0], b[0])


# ── planted faults: each must turn ``correct`` false ──────────────────────


def _wavefront(monkeypatch, wrap):
    from owl_path_tracer_tpu_torch.render import wavefront

    monkeypatch.setattr(wavefront, "render_image_wavefront", wrap(wavefront.render_image_wavefront))


def _scan(monkeypatch, wrap):
    from owl_path_tracer_tpu_torch.render import film

    monkeypatch.setattr(film, "add_samples", wrap(film.add_samples))


def _halve(img):
    """Every other row left out, the kept rows standing for both."""
    out = img.clone()
    out[1::2] = img[0::2][: out[1::2].shape[0]]
    return out


def fault_state_unchanged(monkeypatch, name):
    """Each bounce returns its path state unchanged."""
    from owl_path_tracer_tpu_torch.render import integrator

    monkeypatch.setattr(integrator, "trace_bounce", lambda scene, settings, state, *a, **k: state)
    # the pool then spins to its launch limit: keep that short here
    _wavefront(monkeypatch, lambda f: functools.partial(f, max_launches=4))


def fault_half_batch(monkeypatch, name):
    """Half the pixels of a pass left out, the image taken over the rest."""
    def wrap_wavefront(f):
        def g(*a, **k):
            img, rays = f(*a, **k)
            return _halve(img), rays // 2
        return g

    def wrap_scan(f):
        def g(scene, settings, film, *a, **k):
            out = f(scene, settings, film, *a, **k)
            grown = (out.acc - film.acc).reshape(film.height, film.width, 3)
            acc = film.acc + _halve(grown).reshape(-1, 3)
            return dataclasses.replace(out, acc=acc, rays_traced=film.rays_traced
                                       + (out.rays_traced - film.rays_traced) // 2)
        return g

    _wavefront(monkeypatch, wrap_wavefront)
    _scan(monkeypatch, wrap_scan)


def fault_answer_altered(monkeypatch, name):
    """The closest-hit query turns every 16th ray's hit into a miss."""
    from owl_path_tracer_tpu_torch.render import integrator

    inner = integrator._intersect

    def altered(intersect_fn, ray_o, ray_d):
        hit, blob = inner(intersect_fn, ray_o, ray_d)
        drop = torch.zeros_like(hit.tri, dtype=torch.bool)
        drop[::16] = True
        return dataclasses.replace(hit, tri=torch.where(drop, -1, hit.tri)), blob

    monkeypatch.setattr(integrator, "_intersect", altered)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch, fault_answer_altered])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    res = run_tiny(tiny_cell(name))
    assert not res["correct"], res["checks"]
