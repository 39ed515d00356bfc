"""Render the gallery (counterpart of ``tools/render_gallery.py``).

Small parity frames of every scene through the scan renderer on the
``cluster`` accelerator, or, with ``--hero``, frames of the hero scenes
(dragon7, mitsuba, car) through the production path: ``fused2`` traversal,
the persistent wavefront pool with the sort on, and NEE.

    python -m owl_path_tracer_tpu_torch.tools.render_gallery                  # small set, 96x96 spp 16
    python -m owl_path_tracer_tpu_torch.tools.render_gallery --hero           # 512x512 spp 256 heroes
    python -m owl_path_tracer_tpu_torch.tools.render_gallery --hero --size 1024

Differences from the JAX package's tool: the PNGs go to ``--out-dir``
(default ``gallery_out/`` at the repository root, not ``docs/gallery/``);
``--device`` (default ``cuda``); the scenes are made by
``assets/generate.py`` in a child process; the hero film is read back in
float32 (the JAX package's ``readback_f16`` is not ported).
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from ..models.scene import RenderSettings, compile_scene
from ..render import film as film_mod
from ..render.wavefront import render_image_wavefront
from ..utils.cli import resolve_device
from ..utils.image import quantize_rgba8, write_png_rgba8
from . import probe_common as pc

OUT_DIR = pc.REPO_ROOT / "gallery_out"

HERO_CONFIGS = [
    # (scene, dragon subdivision, settings)
    ("dragon", 7, dict(environment_auto=True, environment_intensity=1.0, use_nee=True)),
    ("mitsuba", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
    ("car", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
]

SMALL_CONFIGS = [
    ("sphere", None, dict(environment_auto=True, environment_intensity=1.0)),
    ("cube", None, dict(environment_auto=True, environment_intensity=1.0)),
    ("cornell-box", None, dict(environment_intensity=0.0, environment_color=(0, 0, 0), use_nee=True)),
    ("dragon", None, dict(environment_auto=True, environment_intensity=1.0, use_nee=True)),
    ("mitsuba", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
    ("car", None, dict(environment_use=True, environment_intensity=1.0, use_nee=True)),
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=0, help="0 = per-mode default")
    ap.add_argument("--spp", type=int, default=0)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--hero", action="store_true", help="hero frames through fused2 + wavefront + NEE")
    ap.add_argument("--scenes", default="", help="comma list override")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out-dir", default=str(OUT_DIR), help="where the PNGs go")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Render the chosen set -> the PNG paths written."""
    args = parse_args(argv)
    size = args.size or (512 if args.hero else 96)
    spp = args.spp or (256 if args.hero else 16)
    device = resolve_device(args.device)
    pc.generate("generate.ensure_assets()")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    configs = HERO_CONFIGS if args.hero else SMALL_CONFIGS
    if args.scenes:
        wanted = set(args.scenes.split(","))
        configs = [c for c in configs if c[0] in wanted]
    written = []
    for name, sub, env_kwargs in configs:
        scene_name = pc.ensure_dragon(sub) if sub else name
        scene = compile_scene(pc.ASSETS, scene_name, (size, size), device=device)
        s = RenderSettings(width=size, height=size, max_samples=spp, max_path_depth=args.depth, **env_kwargs)
        t0 = time.time()
        if args.hero:
            accel = film_mod.make_accel(scene, "fused2", cluster_size=512)
            img, rays = render_image_wavefront(scene, s, accel=accel, fused2_sort=True)
            note = f"{rays / 1e6:.0f} Mrays, fused2+wavefront+nee"
            out = out_dir / f"{name}_hero.png"
        else:
            accel = film_mod.make_accel(scene, "cluster", cluster_size=128)
            img = film_mod.render_image(scene, s, pixel_chunk=size * size, accel=accel)
            note = "scan"
            out = out_dir / f"{name}.png"
        write_png_rgba8(out, quantize_rgba8(np.clip(img.cpu().numpy(), 0, 1)))
        print(f"{name}: {time.time() - t0:.1f}s ({note}) -> {out}", flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
