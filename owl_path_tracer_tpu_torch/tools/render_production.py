"""Render the production frame of ``assets/settings.json``, checkpointed
(counterpart of ``tools/render_production.py``).

The reference program ships one production configuration: the car scene at
1080x1440, 12,288 samples per pixel, path depth 16, environment off.  This
tool renders it in spp segments (each a ``render_image_wavefront`` frame
seeded with its ``sample_base``, so the union of segments draws the streams
one monolithic frame would), with drained wavefront checkpoints inside a
segment and an accumulator file between segments, on ``make_accel(scene,
"fused2-bf16")`` with the sort on.  It writes the PNG and a JSON record of
the wall time and rays.

    python -m owl_path_tracer_tpu_torch.tools.render_production                # the full 12288-spp frame
    python -m owl_path_tracer_tpu_torch.tools.render_production --spp 2 --seg-spp 1
    python -m owl_path_tracer_tpu_torch.tools.render_production --resume-only  # report the accumulator

Kill it at any time; a rerun resumes from the accumulator and the segment's
checkpoint in ``--out-dir`` (default ``production_out/`` at the repository
root).  Differences from the reference: ``--device`` (default ``cuda``),
``--out-dir``, the ray total kept as a Python int, and the car assets made
by ``assets/generate.py`` in a child process.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np

from ..models.scene import RenderSettings, compile_scene
from ..render import film as film_mod
from ..render.wavefront import render_image_wavefront
from ..utils.cli import resolve_device
from ..utils.image import quantize_rgba8, write_png_rgba8
from ..utils.parser import parse_settings
from . import probe_common as pc

OUT_DIR = pc.REPO_ROOT / "production_out"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=12288)
    ap.add_argument("--seg-spp", type=int, default=1024,
                    help="spp per render segment, each seeded with its global sample_base offset")
    ap.add_argument("--checkpoint-every", type=float, default=300.0)
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--resume-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out-dir", default=str(OUT_DIR), help="accumulator, checkpoints, PNG and JSON record")
    return ap.parse_args(argv)


def production_settings(assets: pathlib.Path, spp: int):
    """(scene name, RenderSettings of one spp) from ``settings.json``: the
    reference's production settings verbatim, NEE off."""
    ref = parse_settings(assets / "settings.json")
    w, h = ref.buffer_size
    return ref.scene, RenderSettings(
        width=w, height=h, max_samples=spp, max_path_depth=ref.max_path_depth,
        environment_use=ref.environment_use, environment_auto=ref.environment_auto,
        environment_color=ref.environment_color, environment_intensity=ref.environment_intensity,
    )


def main(argv=None) -> dict | None:
    """Render (or resume) the frame -> its JSON record (None with --resume-only)."""
    args = parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    spp = args.spp
    acc_path = out_dir / f"car_production_spp{spp}_acc.npz"
    if args.resume_only:
        if acc_path.exists():
            with np.load(acc_path) as d:
                print(f"segments done: {int(d['spp_done'])}/{spp} spp")
        else:
            print("no accumulator")
        return None

    device = resolve_device(args.device)
    pc.ensure_car()
    name, one = production_settings(pc.ASSETS, 1)
    w, h = one.width, one.height
    scene = compile_scene(pc.ASSETS, name, (w, h), device=device)
    accel = film_mod.make_accel(scene, "fused2-bf16")
    out_dir.mkdir(parents=True, exist_ok=True)

    spp_done, rays_done, wall_done = 0, 0, 0.0
    img_sum = np.zeros((h, w, 3), np.float32)
    if acc_path.exists():
        with np.load(acc_path) as d:
            spp_done, rays_done, wall_done = int(d["spp_done"]), int(d["rays"]), float(d["wall_s"])
            img_sum = d["img_sum"]
        print(f"[production] resuming after {spp_done}/{spp} spp", flush=True)

    base = spp_done
    while base < spp:
        k = min(args.seg_spp, spp - base)
        _, settings = production_settings(pc.ASSETS, k)
        ck = out_dir / f"car_production_spp{spp}_seg{base}.ck"
        ts = time.time()
        img_k, rays_k = render_image_wavefront(
            scene, settings, accel, lanes=args.lanes, fused2_sort=True, checkpoint_path=str(ck),
            checkpoint_every_s=args.checkpoint_every, progress=True, sample_base=base,
        )
        img_sum = img_sum + img_k.cpu().numpy() * k
        base += k
        spp_done, rays_done = base, rays_done + rays_k
        wall_done += time.time() - ts
        tmp = f"{acc_path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, img_sum=img_sum, spp_done=spp_done, rays=rays_done, wall_s=wall_done)
        os.replace(tmp, acc_path)
        ck.unlink(missing_ok=True)
        print(f"[production] segment done: {spp_done}/{spp} spp, {rays_done / 1e9:.2f}G rays, {wall_done:.0f}s",
              flush=True)

    img = img_sum / spp
    png = out_dir / f"car_production_spp{spp}.png"
    write_png_rgba8(png, quantize_rgba8(np.clip(img, 0, 1)))
    rec = {
        "metric": f"car production frame ({w}x{h} spp={spp} depth={one.max_path_depth}, settings.json)",
        "wall_s_total": wall_done,
        "rays_total": rays_done,
        "mrays_per_s": rays_done / wall_done / 1e6,
        "png": str(png),
        "device": pc.device_name(device),
    }
    print(json.dumps(rec), flush=True)
    (out_dir / f"car_production_spp{spp}.json").write_text(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
