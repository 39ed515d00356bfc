"""Helpers of the benchmark's own tests (``python -m pytest benchmark/``):
cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""
from __future__ import annotations

import copy
import json
import time

import pytest

from benchmark import drive

# the program's CPU path at this size renders a pass in a few seconds
TINY = dict(subdivision=2, width=32, height=24, cluster_size=64, lanes=256, pixel_chunk=256)

# upstream's Cornell box mesh, pinned by its hash
CORNELL_OBJ = "assets/cornell-box.obj.scene"
CORNELL_SHA256 = "94a9c659e6a5df9a13e70f9d76c609cfa32df7b88566dcfdfe3d3eeebc40ee33"


def cornell_config(width: int = TINY["width"], height: int = TINY["height"]) -> dict:
    """A configuration with a ``"file"`` scene: upstream's Cornell box, its
    camera and materials from ``assets/cornell-box.json``, depth 8, NEE off
    and no environment light."""
    assets = json.loads((drive.ROOT / "assets" / "cornell-box.json").read_text())
    return {"name": "cornell",
            "scene": {"name": "cornell", "generator": "file", "obj": CORNELL_OBJ, "obj_sha256": CORNELL_SHA256,
                      "camera": assets["camera"], "materials": assets["materials"]},
            "render": {"width": width, "height": height, "max_path_depth": 8, "environment_use": False,
                       "environment_auto": False, "environment_color": [0.0, 0.0, 0.0], "environment_intensity": 0.0,
                       "use_nee": False}}


def tiny_cell(name: str, **over) -> drive.Cell:
    """The cell ``name`` with its scene and pool cut to ``TINY`` (and ``over``)."""
    size = {**TINY, **over}
    cell = drive.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    if cfg["scene"]["generator"] == "dragon":
        cfg["scene"]["subdivision"] = size["subdivision"]
    cfg["render"]["width"], cfg["render"]["height"] = size["width"], size["height"]
    tr = dict(cell.traffic, cluster_size=size["cluster_size"])
    for key in ("lanes", "pixel_chunk"):
        if key in tr:
            tr[key] = size[key]
    cell.config, cell.traffic = cfg, tr
    return cell


def run_tiny(cell: drive.Cell, seed: int = 5, trace: bool = False, accel_kind=None) -> dict:
    """One run of the harness on the CPU, a window of one pass."""
    return drive.run(cell, seed, 0.0, trace, "cpu", time.perf_counter(), accel_kind=accel_kind)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at import)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
