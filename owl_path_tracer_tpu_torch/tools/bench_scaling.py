"""Multi-rank scaling benchmark (counterpart of ``tools/bench_scaling.py``):
rays per second of the sharded renderer at 1, 2, 4, ... ranks.

    python -m owl_path_tracer_tpu_torch.tools.bench_scaling --device cpu --max-ranks 4 --scene cornell-box --size 128
    python -m owl_path_tracer_tpu_torch.tools.bench_scaling              # the cards present, one per rank (NCCL)

Prints one JSON line per rank count: seconds, rays (wavefront) or paths
(scan) per second, the efficiency against one rank, the image mean, and for
the wavefront each rank's rays and the load balance.  On cards each rank
takes its own card, so the counts stop at the cards present: a machine with
one card measures 1 rank only, and no speed-up across devices.  On the CPU
the ranks share the host's cores, so the wall-clock efficiency says nothing
about cards; ``load_balance`` (a count) is the work-imbalance bound.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..models.scene import RenderSettings, compile_scene
from ..ops import fused, fused2
from ..parallel import shard
from ..render import film as film_mod
from ..utils.cli import resolve_device
from . import probe_common as pc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell-box")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--cluster-size", type=int, default=None)
    ap.add_argument("--renderer", choices=["wavefront", "scan"], default="wavefront")
    ap.add_argument("--intersector", default="cluster")
    ap.add_argument("--lanes-per-chip", type=int, default=8192)
    ap.add_argument("--device", default="cuda", help="torch device of every rank (default cuda)")
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="largest rank count (default: the cards present on cuda, 8 on the CPU)")
    return ap.parse_args(argv)


def _rank(mesh, args):
    """One rank: a warm-up render, then the timed one -> (seconds, work, image mean, stats)."""
    scene = compile_scene(pc.ASSETS, args.scene, (args.size, args.size), device=mesh.device)
    settings = RenderSettings(width=args.size, height=args.size, max_samples=args.spp, max_path_depth=args.depth,
                              environment_auto=True, environment_intensity=1.0)
    accel = film_mod.make_accel(scene, args.intersector, cluster_size=args.cluster_size)
    if args.renderer == "wavefront":
        def render():
            return shard.render_image_wavefront_sharded(scene, settings, mesh=mesh, accel=accel,
                                                        lanes_per_chip=args.lanes_per_chip, return_stats=True)
    else:
        def render():
            img = shard.render_image_sharded(scene, settings, mesh=mesh, accel=accel)
            return img, args.size * args.size * args.spp, None  # paths: a lower bound on rays
        shard.render_image_sharded(scene, settings, mesh=mesh, spp=1, accel=accel)
    render()  # warm-up
    pc.sync(mesh.device)
    t0 = time.perf_counter()
    img, work, stats = render()
    pc.sync(mesh.device)
    return time.perf_counter() - t0, work, float(img.mean()), stats


def main(argv=None) -> list:
    """Measure each rank count -> the JSON records printed."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    max_ranks = args.max_ranks or (torch.cuda.device_count() if device.type == "cuda" else 8)
    pc.generate("generate.ensure_assets()")
    if device.type == "cuda":  # built once here, so that no two ranks build at once
        if args.intersector.startswith("fused2"):
            fused2.build_kernels()
        elif args.intersector == "fused":
            fused.build_kernels()
    recs, base_rate = [], None
    for n in (k for k in (1, 2, 4, 8, 16, 32) if k <= max_ranks):
        per_rank = shard.spawn_ranks(_rank, n, device=str(device), args=(args,))
        dt = max(r[0] for r in per_rank)  # the ranks end together, in the film's collective
        _, work, mean, stats = per_rank[0]
        rate = work / dt
        base_rate = base_rate or rate
        rec = {"devices": n, "seconds": round(dt, 3),
               ("rays_per_s" if args.renderer == "wavefront" else "paths_per_s"): round(rate),
               "efficiency_vs_1dev": round(rate / (base_rate * n), 3), "image_mean": round(mean, 6),
               "device": pc.device_name(device)}
        if stats is not None:
            rec["load_balance"] = round(stats["load_balance"], 4)
            rec["per_chip_rays"] = stats["per_chip_rays"]
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
