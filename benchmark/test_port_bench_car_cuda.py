"""On the card: the car cell ``car.scan`` at a size a test run holds
(270x360, depth 16, the cell's C=128 and 65,536-pixel chunks, so a frame is
a whole chunk and a short one): its pass agrees with the plain reference,
the bfloat16 reference's control does not, a reference that drops the
clearcoat lobe does not on any of three sample bases, and a frame makes
every synchronising call inside an ``owlpt.sync.*`` range.  Skipped where
there is no CUDA device.

    python -m pytest -q benchmark/test_port_bench_car_cuda.py
"""
from __future__ import annotations

import time

import pytest

from benchmark import check, control, drive, scenes
from benchmark.conftest import tiny_cell
from benchmark.test_port_bench_cornell_cuda import _syncs_only_in_sync_spans

CELL = "car.scan"
SIZE = dict(width=270, height=360, pixel_chunk=65536)


def _cell():
    cell = tiny_cell(CELL, **SIZE)
    cell.traffic = dict(cell.traffic, cluster_size=drive.load_cell(CELL).traffic["cluster_size"])
    return cell


@pytest.mark.cuda
def test_card_pass_agrees_with_reference(cuda_device):
    res = drive.run(_cell(), 2**31 + 91, 0.0, False, cuda_device, time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_card_bf16_control_is_not_correct(cuda_device):
    cell = _cell()
    correct, checks = check.judge(control.reference_bf16(cell, 2**31 + 92, cuda_device), cell.limits)
    assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 93, 2**31 + 94, 2**31 + 95])
def test_reference_without_clearcoat_is_not_correct(cuda_device, seed):
    """The reference with every material's clearcoat at 0, in the program's
    place, against the sound reference: the image mean falls by more than
    its limit (the frame is dark but where paths reach the light, so the
    share of pixels cannot see it)."""
    cell = _cell()
    ref = drive.reference(cell.config)
    rs = ref.load_scene(cell.config, scenes.materialize(cell.config), cell.traffic["cluster_size"], cuda_device)
    want, want_rays, *_ = ref.render_pass(rs, seed, *ref.MODES["scan"])
    rs.mats["clearcoat"].zero_()
    got, rays, *_ = ref.render_pass(rs, seed, *ref.MODES["scan"])
    correct, checks = check.judge(check.compare(got.cpu().numpy(), want.cpu().numpy(), rays, want_rays),
                                  cell.limits)
    print(checks)
    assert not correct and checks["mean_gap_pct"]["value"] > checks["mean_gap_pct"]["limit"], checks


@pytest.mark.cuda
def test_every_sync_of_the_car_frame_is_in_a_sync_span(cuda_device, tmp_path):
    """A car frame on the scan renderer renders with every synchronising
    call outside the ``owlpt.sync.*`` ranges raising, so
    ``host.syncs_per_pass`` counts every sync; the same image as without
    the check.  The frame renders once first (kernel builds and caches)."""
    import torch

    cell = _cell()
    prog = drive.Program(cell, scenes.materialize(cell.config, tmp_path), 0, cuda_device)

    def frame():
        f = prog.film.add_samples(prog.scene, prog.settings, prog.film.new_film(prog.settings, device=cuda_device),
                                  1, pixel_chunk=cell.traffic["pixel_chunk"], accel=prog.accel)
        return prog.film.finalize(f), f.rays_traced

    want, rays_want = frame()
    with _syncs_only_in_sync_spans() as entered:
        img, rays = frame()
    assert rays == rays_want > 0 and torch.equal(img, want)
    print(sorted((k, v) for k, v in entered.items() if k.startswith("owlpt.sync.")))
    assert entered["owlpt.sync.resolved"] == 2 * cell.config["render"]["max_path_depth"]
