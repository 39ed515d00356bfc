"""The controls of the comparison that decides ``correct``, at a cell's own
size: numbers that a lower precision than the configuration's gives.

    python3 -m benchmark.control --workload dragon7.wavefront --seeds 11 12 13 [--seconds 3]

A cell whose traffic runs ``fused2`` takes the program's own lower-precision
path as its control: the same run with ``fused2-bf16`` (bfloat16 planes).
Any other cell takes the reference in the program's place with its
triangle data rounded to bfloat16, against the float32 reference.  One JSON
line per seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

from . import check, drive, scenes


def reference_bf16(cell: drive.Cell, seed: int, device: str) -> dict:
    """The numbers of the bfloat16 reference's pass against the float32 one's."""
    import torch

    tr = cell.traffic
    ref = drive.reference(cell.config, cell.here)
    scene_dir = scenes.materialize(cell.config)
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref_scene = ref.load_scene(cell.config, scene_dir, tr["cluster_size"], device, plane_dtype=dtype)
        img, rays, *_ = ref.render_pass(ref_scene, seed, *ref.MODES[tr["renderer"]])
        got[dtype] = (img.cpu().numpy(), rays)
    (lo, lo_rays), (ref, ref_rays) = got[torch.bfloat16], got[torch.float32]
    return check.compare(lo, ref, lo_rays, ref_rays)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0, help="window of a program control run")
    args = ap.parse_args(argv)
    drive.cache_env()
    cell = drive.load_cell(args.workload)
    for seed in args.seeds:
        if cell.traffic["accel"] == "fused2":
            res = drive.run(cell, seed, args.seconds, False, "cuda", time.perf_counter(), accel_kind="fused2-bf16")
            numbers = {k: v["value"] for k, v in res["checks"].items()}
            kind = "program fused2-bf16"
        else:
            numbers = reference_bf16(cell, seed, "cuda")
            kind = "reference bfloat16"
        print(json.dumps({"workload": cell.name, "seed": seed, "control": kind, "numbers": numbers}), flush=True)


if __name__ == "__main__":
    main()
