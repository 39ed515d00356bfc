"""On the card: the comparison at a size a test run holds (dragon
subdivision 5, 128x96), sound passes through the card's kernels and the
controls.  Skipped where there is no CUDA device.

    python -m pytest -q benchmark/test_port_bench_cuda.py
"""
from __future__ import annotations

import time

import pytest

from benchmark import check, control, drive
from benchmark.conftest import tiny_cell

SIZE = dict(subdivision=5, width=128, height=96, lanes=4096, pixel_chunk=4096)


def _cell(name):
    cell = tiny_cell(name, **SIZE)
    cell.traffic = dict(cell.traffic, cluster_size=drive.load_cell(name).traffic["cluster_size"])
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dragon7.wavefront", "dragon7.scan"])
def test_card_passes_agree_with_reference(cuda_device, name):
    res = drive.run(_cell(name), 77, 0.0, False, cuda_device, time.perf_counter())
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_card_program_bf16_control_is_not_correct(cuda_device):
    res = drive.run(_cell("dragon7.wavefront"), 78, 0.0, False, cuda_device, time.perf_counter(),
                    accel_kind="fused2-bf16")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_card_reference_bf16_control_is_not_correct(cuda_device):
    cell = _cell("dragon7.scan")
    correct, checks = check.judge(control.reference_bf16(cell, 79, cuda_device), cell.limits)
    assert not correct, checks
