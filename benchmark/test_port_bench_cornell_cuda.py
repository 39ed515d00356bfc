"""On the card: the NEE cell ``cornell.nee-deferred`` at a size a test run
holds (128x96, 4,096 lanes, the cell's C=512): its pass through the card's
mixed sweep agrees with the plain NEE reference, its ``fused2-bf16``
control does not, and a deferred frame makes every synchronising call
inside an ``owlpt.sync.*`` range.  Skipped where there is no CUDA device.

    python -m pytest -q benchmark/test_port_bench_cornell_cuda.py
"""
from __future__ import annotations

import collections
import contextlib
import time

import pytest

from benchmark import drive, scenes
from benchmark.conftest import tiny_cell

CELL = "cornell.nee-deferred"
SIZE = dict(width=128, height=96, lanes=4096)


def _cell():
    cell = tiny_cell(CELL, **SIZE)
    cell.traffic = dict(cell.traffic, cluster_size=drive.load_cell(CELL).traffic["cluster_size"])
    return cell


@pytest.mark.cuda
def test_card_pass_agrees_with_reference(cuda_device):
    res = drive.run(_cell(), 2**31 + 81, 0.0, False, cuda_device, time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_card_bf16_control_is_not_correct(cuda_device):
    res = drive.run(_cell(), 2**31 + 82, 0.0, False, cuda_device, time.perf_counter(), accel_kind="fused2-bf16")
    assert not res["correct"], res["checks"]


@contextlib.contextmanager
def _syncs_only_in_sync_spans():
    """Every synchronising CUDA call raises, except inside an
    ``owlpt.sync.*`` range (a wrap of ``record_function`` lifts the mode on
    such a range's enter and sets it again on its exit) -> a Counter of
    the ranges entered, by name."""
    import torch

    cls = torch.profiler.record_function
    enter, exit_ = cls.__enter__, cls.__exit__
    entered = collections.Counter()

    def lift(rf):
        out = enter(rf)
        entered[rf.name] += 1
        if rf.name.startswith("owlpt.sync."):
            torch.cuda.set_sync_debug_mode(0)
        return out

    def restore(rf, *exc):
        if rf.name.startswith("owlpt.sync."):
            torch.cuda.set_sync_debug_mode("error")
        return exit_(rf, *exc)

    torch.cuda.synchronize()
    cls.__enter__, cls.__exit__ = lift, restore
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield entered
    finally:
        torch.cuda.set_sync_debug_mode(0)
        cls.__enter__, cls.__exit__ = enter, exit_


@pytest.mark.cuda
def test_every_sync_of_the_deferred_frame_is_in_a_sync_span(cuda_device, tmp_path):
    """A deferred NEE frame of the cell's path renders with every
    synchronising call outside the ``owlpt.sync.*`` ranges raising, so
    ``host.syncs_per_pass`` counts every sync; the same image as without
    the check.  The frame renders once first (kernel builds and caches)."""
    import torch

    from owl_path_tracer_tpu_torch.render.wavefront import render_image_wavefront

    cell = _cell()
    prog = drive.Program(cell, scenes.materialize(cell.config, tmp_path), 0, cuda_device)
    tr = cell.traffic

    def frame():
        return render_image_wavefront(prog.scene, prog.settings, prog.accel, lanes=tr["lanes"],
                                      fused2_block=tr["block"], fused2_sort=tr["sort"], sample_base=5,
                                      **tr["options"])

    want, rays_want = frame()
    with _syncs_only_in_sync_spans() as entered:
        img, rays = frame()
    assert rays == rays_want > 0 and torch.equal(img, want)
    assert entered["owlpt.mixed"] == entered["owlpt.nee"] == entered["owlpt.step"] > 0
