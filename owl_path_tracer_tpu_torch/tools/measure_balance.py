"""Per-rank load balance of the sharded wavefront renderer (counterpart of
``tools/measure_balance.py``).

Renders the dragon (icosphere subdivision ``--sub``, concentrated geometry)
with ``parallel/shard.py::render_image_wavefront_sharded`` on ``--ranks``
processes and prints, for each work split, one JSON line with each rank's
live rays and ``load_balance`` (their mean over their max):

  * contiguous -- bands of the (pixel, sample) queue: ranks whose band is
    sky trace one-bounce paths while the dragon's trace full trees;
  * sample -- rank k renders samples [k*spp/n, (k+1)*spp/n) of every pixel.

    python -m owl_path_tracer_tpu_torch.tools.measure_balance --device cpu --ranks 8 [--sub 7] [--size 256] [--spp 16]
    python -m owl_path_tracer_tpu_torch.tools.measure_balance --ranks 4     # one card per rank, NCCL

Ranks run gloo on the CPU and NCCL on the cards (one card per rank;
``--backend gloo`` puts several ranks on one card).  Balance is a count of
rays, so a CPU run measures it as well as a card run.  The resolution is cut
(the per-pixel work distribution, which sets the balance, is the framing's);
spp stays a multiple of the rank count for the sample split.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..models.scene import RenderSettings, compile_scene
from ..parallel import shard
from ..render import film as film_mod
from ..utils.cli import resolve_device
from . import probe_common as pc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sub", type=int, default=7)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lanes-per-chip", type=int, default=16384)
    ap.add_argument("--splits", default="contiguous,sample")
    ap.add_argument("--device", default="cuda", help="torch device of every rank (default cuda)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: the cards present on cuda, 8 on the CPU)")
    ap.add_argument("--backend", default=None, help="process-group backend (default: nccl on cuda, gloo on cpu)")
    return ap.parse_args(argv)


def _rank(mesh, args, scene_name):
    """One rank: both splits -> their records (the same on every rank)."""
    scene = compile_scene(pc.ASSETS, scene_name, (args.size, args.size), device=mesh.device)
    settings = RenderSettings(width=args.size, height=args.size, max_samples=args.spp, max_path_depth=args.depth,
                              environment_auto=True, environment_intensity=1.0)
    accel = film_mod.make_accel(scene, "cluster", cluster_size=256)
    out = []
    for split in args.splits.split(","):
        t0 = time.time()
        _, _, stats = shard.render_image_wavefront_sharded(
            scene, settings, mesh=mesh, accel=accel, lanes_per_chip=args.lanes_per_chip, iters_per_launch=8,
            return_stats=True, work_split=split)
        out.append({
            "probe": "load_balance", "split": split, "scene": scene_name, "size": args.size, "spp": args.spp,
            "devices": mesh.size, "per_chip_rays": stats["per_chip_rays"],
            "load_balance": round(stats["load_balance"], 4), "wall_s": round(time.time() - t0, 1),
            "device": pc.device_name(mesh.device),
        })
    return out


def main(argv=None) -> list:
    """Measure -> the JSON records printed."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ranks = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 8)
    scene_name = pc.generated_dragon(args.sub)
    recs = shard.spawn_ranks(_rank, ranks, device=str(device), backend=args.backend, args=(args, scene_name))[0]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


if __name__ == "__main__":
    main()
