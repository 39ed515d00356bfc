"""Forward path-tracing throughput on the dragon stress scene (counterpart
of the repository's ``bench.py``, whose flags, defaults and output it keeps).

    python -m owl_path_tracer_tpu_torch.tools.bench                 # the headline, on the card
    python -m owl_path_tracer_tpu_torch.tools.bench --quick         # 256^2, spp 2, sub 6, no trend
    python -m owl_path_tracer_tpu_torch.tools.bench --device cpu --scene cornell-box --size 16 --spp 2

The LAST stdout line is the headline JSON:
  {"metric": ..., "value": N, "unit": "Mrays/s", "vs_baseline": N}

``value`` is live rays traced per second (primary + bounces alive at each
wavefront step, counted on the device) on the default config: dragon
(icosphere subdivision 7, 327,684 triangles), 1024x1024, spp 64, depth 4,
``fused2-bf16``, the persistent wavefront with the sort on.  The timed
window ends when the image is on the host (wavefront) or the card has
finished (scan), after one warm-up frame of the identical config (the first
launch builds the kernels with nvcc).  ``vs_baseline`` is the ratio against
``BASELINE_MRAYS``, the port's own first run of that config on an H100.

For ``--scene dragon`` without ``--no-trend`` a FROZEN secondary config
(dragon subdivision 6, 512x512, spp 4, ``--depth``, intersector ``fused2``)
is printed first as a ``"trend"`` line, as in ``bench.py``.  Before it one
line carries the device (``nvidia-smi``'s name and power limit) and each
config's label, live rays and seconds.

Differences from ``bench.py``: ``--device`` (default ``cuda``, which raises
without a card); the film is always read back in float32, so
``--no-readback-f16`` is accepted and changes nothing, and the label never
says ``f16-readback`` (it equals ``bench.py --no-readback-f16``'s); the
scenes are written by ``assets/generate.py`` in a child process.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

from ..models.scene import RenderSettings, compile_scene
from ..render import film as film_mod
from ..render.wavefront import render_image_wavefront
from ..utils.cli import resolve_device
from . import probe_common as pc

# Mrays/s of the port's first run of the default headline config (dragon7,
# 1024x1024, spp 64, depth 4, fused2-bf16, wavefront, sort on: 123,996,169
# rays in 17.668 s) on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (PERF.md §2); the denominator of both lines' vs_baseline.
BASELINE_MRAYS = 7.018

INTERSECTORS = ["fused2", "fused2-bf16", "fused", "cluster", "bvh", "brute"]


def label(args, scene_name, n_tris, size, spp, depth, nee=False) -> str:
    """The config's text, as ``bench.py``'s ``run_config`` writes it without f16 readback."""
    return (f"{scene_name} {n_tris // 1000}k tris {size}^2 spp={spp} depth={depth}, "
            f"{args.intersector} intersector, {args.renderer}" + (", nee" if nee else ""))


def run_config(args, scene_name, size, spp, depth, nee=False) -> tuple:
    """Render one timed frame after a warm-up -> (Mrays/s, label, live rays, seconds)."""
    device = resolve_device(args.device)
    scene = compile_scene(pc.ASSETS, scene_name, (size, size), device=device)
    settings = RenderSettings(width=size, height=size, max_samples=spp, max_path_depth=depth,
                              environment_auto=True, environment_intensity=1.0, use_nee=nee)
    accel = film_mod.make_accel(scene, args.intersector, cluster_size=args.cluster_size)
    n_tris = int(scene.tri_idx.shape[0])

    if args.renderer == "wavefront":
        kw = dict(accel=accel, lanes=args.lanes, fused2_block=args.fused2_block, fused2_sort=not args.no_sort,
                  iters_per_launch=args.iters_per_launch, fused_nee=args.fused_nee)
        render_image_wavefront(scene, settings, **kw)[0].cpu()  # warm-up: builds the kernels
        pc.sync(device)
        t0 = time.perf_counter()
        img, rays = render_image_wavefront(scene, settings, **kw)
        img.cpu()  # the window ends with the image on the host, as bench.py's
        dt = time.perf_counter() - t0
    else:
        warm = film_mod.new_film(settings, device=device)
        film_mod.add_samples(scene, settings, warm, 1, pixel_chunk=args.pixel_chunk, accel=accel)
        film = film_mod.new_film(settings, device=device)
        pc.sync(device)
        t0 = time.perf_counter()
        film = film_mod.add_samples(scene, settings, film, spp, pixel_chunk=args.pixel_chunk, accel=accel)
        pc.sync(device)
        dt = time.perf_counter() - t0
        rays = film.rays_traced
    return rays / dt / 1e6, label(args, scene_name, n_tris, size, spp, depth, nee), rays, dt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="dragon")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--dragon-sub", type=int, default=7,
                    help="dragon icosphere subdivisions (6 ~82k tris, 7 ~328k, 8 ~1.3M)")
    ap.add_argument("--cluster-size", type=int, default=None)
    ap.add_argument("--intersector", choices=INTERSECTORS, default="fused2-bf16",
                    help="fused2-bf16 (default) = fat-cluster traversal (K1b on the tensor cores) with "
                         "bfloat16 triangle planes; fused2 = float32 planes; fused = the round-1 kernel (K5); "
                         "cluster / bvh / brute = exact queries without a kernel")
    ap.add_argument("--pixel-chunk", type=int, default=65536)
    ap.add_argument("--renderer", choices=["wavefront", "scan"], default="wavefront")
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--iters-per-launch", type=int, default=32)
    ap.add_argument("--fused2-block", type=int, default=256, help="rays per fused2 kernel block")
    ap.add_argument("--no-sort", action="store_true", help="disable the per-wave coherence sort")
    ap.add_argument("--nee", action="store_true",
                    help="bench the NEE+MIS estimator (adds any-hit shadow rays)")
    ap.add_argument("--fused-nee", dest="fused_nee", action="store_true", default=False,
                    help="trace NEE shadow rays inside the deferred mixed sweep (K3) instead of a separate "
                         "any-hit sweep")
    ap.add_argument("--no-trend", action="store_true", help="skip the frozen secondary trend config")
    ap.add_argument("--no-readback-f16", dest="readback_f16", action="store_false",
                    help="accepted for bench.py's sake and changes nothing: the port always reads the film "
                         "back in float32, which is what this flag asks bench.py for")
    ap.add_argument("--quick", action="store_true", help="256^2, spp=2, sub=6 smoke config")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    if args.quick:
        args.size, args.spp, args.dragon_sub = 256, 2, 6
        args.no_trend = True
    return args


def _line(metric: str, mrays: float) -> dict:
    return {"metric": metric, "value": round(mrays, 3), "unit": "Mrays/s",
            "vs_baseline": round(mrays / BASELINE_MRAYS, 4)}


def main(argv=None) -> list:
    """Run the trend config (unless skipped) and the headline -> the JSON
    records printed: the device line, the trend line, the headline (last)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.scene == "dragon":
        scene_name = pc.generated_dragon(args.dragon_sub)
    else:
        pc.generate("generate.ensure_assets()")
        scene_name = args.scene

    configs, lines = [], []
    # frozen trend config: NEVER change these numbers (round-over-round line)
    if not args.no_trend and args.scene == "dragon":
        targs = copy.copy(args)
        targs.intersector = "fused2"  # frozen: f32, regardless of the default
        t_mrays, t_label, t_rays, t_s = run_config(targs, pc.generated_dragon(6), 512, 4, args.depth)
        configs.append({"metric": t_label, "rays": t_rays, "seconds": t_s})
        lines.append(_line(f"trend Mrays/s (frozen: {t_label})", t_mrays))
    mrays, head_label, rays, seconds = run_config(args, scene_name, args.size, args.spp, args.depth, nee=args.nee)
    configs.append({"metric": head_label, "rays": rays, "seconds": seconds})
    lines.append(_line(f"fwd Mrays/s ({head_label})", mrays))
    records = [{"device": pc.device_name(device), "configs": configs}, *lines]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
