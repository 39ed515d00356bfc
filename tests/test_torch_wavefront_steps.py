"""A wavefront frame ends at its last busy step (``render/wavefront.py``):
the frame's launches stop stepping once no lane is alive, no shadow ray is
pending and the queue is handed out, and otherwise run as before.  On the
benchmark's two wavefront cells cut to a size the CPU renders in seconds
(``benchmark/conftest.py``'s TINY: 32x24, 256 lanes, C=64), the plain
dragon frame and the cornell box's deferred-NEE frame, in launches shorter
and longer than the frame: the steps run against the pool's state before
each step, the image and rays against the fixed-length launches the loop
ran before (each launch all its steps, the status read after it), and the
counts of steps run and cut."""
from __future__ import annotations

import pytest
import torch

from benchmark import drive, scenes, traces
from benchmark.conftest import tiny_cell
from owl_path_tracer_tpu_torch.render import wavefront

torch.set_num_threads(2)

CELLS = {"plain": "dragon7.wavefront", "deferred": "cornell.nee-deferred"}


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    cache = tmp_path_factory.mktemp("scenes")
    out = {}
    for kind, name in CELLS.items():
        cell = tiny_cell(name)
        out[kind] = drive.Program(cell, scenes.materialize(cell.config, cache), 0, "cpu")
    return out


def _render(prog, **kw):
    """One frame of the cell's path -> (image, live rays)."""
    tr = prog.cell.traffic
    return wavefront.render_image_wavefront(prog.scene, prog.settings, prog.accel, lanes=tr["lanes"],
                                            fused2_block=tr["block"], fused2_sort=tr["sort"], sample_base=11,
                                            **tr.get("options", {}), **kw)


def _iters(prog, iters_per_launch):
    """The steps of one launch, as ``render_image_wavefront`` sizes it."""
    s, lanes = prog.settings, prog.cell.traffic["lanes"]
    est = -(-s.width * s.height * s.max_samples // lanes) + s.max_path_depth + 3
    return max(2, min(iters_per_launch, est))


def _fixed_launches(monkeypatch):
    """Launches that run all their steps whatever the frame's status: the loop
    before frames ended at their last busy step."""
    run = wavefront._run_chunk
    monkeypatch.setattr(wavefront, "_run_chunk", lambda *a, stop_from=None, **k: run(*a, **k))


def _busy_before_each_step(monkeypatch):
    """A list that takes, before every step, whether a lane is alive or a
    shadow ray pending."""
    busy, step = [], wavefront.wavefront_step

    def record(scene, settings, st, *a, **k):
        busy.append(bool((st.alive | st.sh_active).any()))
        return step(scene, settings, st, *a, **k)

    monkeypatch.setattr(wavefront, "wavefront_step", record)
    return busy


@pytest.mark.parametrize("iters_per_launch", [3, 64], ids=["short-launches", "long-launches"])
@pytest.mark.parametrize("kind", ["plain", "deferred"])
def test_frame_ends_at_its_last_busy_step(programs, monkeypatch, kind, iters_per_launch):
    """The frame runs exactly as many steps as reach its last busy one (the
    last with a lane alive or a shadow ray pending before it), each in an
    ``owlpt.step`` range, and every launch but the last runs all its steps;
    the counts say so: steps run, steps cut from the last launch."""
    prog = programs[kind]
    busy = _busy_before_each_step(monkeypatch)
    wavefront.reset_counts()
    with traces.HostSpans() as spans:
        img, rays = _render(prog, iters_per_launch=iters_per_launch)
    steps = sum(n == "owlpt.step" for n, _, _ in spans.spans)
    last_busy = max(i for i, b in enumerate(busy) if b)
    assert rays > 0 and torch.isfinite(img).all()
    assert steps == len(busy) == last_busy + 1
    iters, counts = _iters(prog, iters_per_launch), dict(wavefront.STEPS)
    assert counts["run"] == steps and counts["run"] + counts["cut"] == counts["launches"] * iters
    assert (counts["launches"] - 1) * iters < steps and 0 <= counts["cut"] < iters
    if iters_per_launch == 3:
        assert counts["launches"] >= 3
    else:
        assert counts["cut"] > 0


@pytest.mark.parametrize("iters_per_launch", [3, 64], ids=["short-launches", "long-launches"])
@pytest.mark.parametrize("kind", ["plain", "deferred"])
def test_frame_equals_fixed_launches_bit_for_bit(programs, monkeypatch, kind, iters_per_launch):
    """The image and the ray count equal, bit for bit, those of launches
    that each run all their steps until the status read after a launch says
    the frame is done; those run the steps the frame ends without, and cut
    none."""
    prog = programs[kind]
    wavefront.reset_counts()
    img, rays = _render(prog, iters_per_launch=iters_per_launch)
    ended = dict(wavefront.STEPS)
    _fixed_launches(monkeypatch)
    wavefront.reset_counts()
    img_fixed, rays_fixed = _render(prog, iters_per_launch=iters_per_launch)
    fixed = dict(wavefront.STEPS)
    assert torch.equal(img, img_fixed) and rays == rays_fixed
    assert fixed["cut"] == 0 and fixed["run"] == fixed["launches"] * _iters(prog, iters_per_launch)
    assert fixed["launches"] == ended["launches"] and fixed["run"] == ended["run"] + ended["cut"]


@pytest.mark.parametrize("kind", ["plain", "deferred"])
def test_a_launch_that_leaves_its_frame_unfinished_runs_all_its_steps(programs, monkeypatch, kind):
    """``max_launches`` stops the frame before its end: each launch runs all
    its steps, and the film and rays are those of the fixed-length launches
    (what a stopped checkpoint holds)."""
    prog = programs[kind]
    wavefront.reset_counts()
    img, rays = _render(prog, iters_per_launch=3, max_launches=2)
    assert wavefront.STEPS == {"launches": 2, "run": 6, "cut": 0}
    _fixed_launches(monkeypatch)
    img_fixed, rays_fixed = _render(prog, iters_per_launch=3, max_launches=2)
    assert torch.equal(img, img_fixed) and rays == rays_fixed > 0


def test_reset_counts_zeroes_the_step_counts():
    wavefront.STEPS.update(launches=2, run=7, cut=3)
    wavefront.reset_counts()
    assert wavefront.STEPS == {"launches": 0, "run": 0, "cut": 0}
