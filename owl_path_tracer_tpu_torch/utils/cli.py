"""CLI driver and material parameter-sweep harness (counterpart of
``owl_path_tracer_tpu/utils/cli.py``; same flags, defaults and output names).

* reads ``settings.json`` from the assets directory and sweeps one material
  attribute from values[0] to values[1] in ``step_size`` steps;
* output naming: ``{scene}_{test}_{attr}({value}).png`` with ``{:.1f}``
  value formatting, or ``{scene}.png`` for a single frame;
* ``--device`` (default ``cuda``) picks where the scene, the accelerator and
  the render live; ``cuda`` raises where there is no GPU;
* ``--checkpoint PATH`` (``--renderer wavefront``): drained checkpoints every
  ``--checkpoint-every`` seconds, and a rerun resumes from them
  (render/wavefront.py).  A sweep keeps one checkpoint per frame,
  ``PATH.<frame index>``, where the JAX package reuses PATH for every frame;
  with the scan renderer, which writes none, ``--checkpoint`` raises where
  the JAX package ignores it.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import time

import torch

from ..models.scene import RenderSettings, Scene, compile_scene
from ..render import film as film_mod
from .image import quantize_rgba8, write_png_rgba8
from .parser import MATERIAL_SCALAR_FIELDS, parse_materials, parse_settings


def set_material_attribute(scene: Scene, material_index: int, attribute: str, value) -> Scene:
    """A new Scene with one material attribute replaced; the caller's
    tensors are not written."""
    mats = scene.materials
    if attribute == "base_color":
        col = torch.as_tensor(value, dtype=torch.float32, device=mats.base_color.device)
        new = mats.base_color.clone()
        new[material_index] = col
    elif attribute in MATERIAL_SCALAR_FIELDS:
        new = getattr(mats, attribute).clone()
        new[material_index] = float(value)
    else:
        raise ValueError(f"unknown material attribute {attribute!r}")
    return dataclasses.replace(scene, materials=dataclasses.replace(mats, **{attribute: new}))


def sweep_values(values, step_size: float):
    """The reference loop: i = 0, step*100, ... 100; value = lerp(v0, v1, i/100)."""
    v0, v1 = values[0], values[1]
    vstep = int(step_size * 100)
    out = []
    for i in range(0, 101, max(vstep, 1)):
        c = i / 100.0
        if isinstance(v0, (tuple, list)):
            out.append(tuple(a + (b - a) * c for a, b in zip(v0, v1)))
        else:
            out.append(v0 + (v1 - v0) * c)
    return out


def format_value(v) -> str:
    """``{:.1f}``, vec3 components joined by commas."""
    if isinstance(v, (tuple, list)):
        return ",".join(f"{x:.1f}" for x in v)
    return f"{float(v):.1f}"


def resolve_device(name: str) -> torch.device:
    """A ``--device`` argument; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; none is available (pass --device cpu)")
    return device


def run_sweep(args) -> list:
    if getattr(args, "checkpoint", None) is not None and args.renderer != "wavefront":
        raise ValueError("--checkpoint needs --renderer wavefront: the scan renderer writes no checkpoints")
    device = resolve_device(getattr(args, "device", "cuda"))
    assets = pathlib.Path(args.assets)
    settings_desc = parse_settings(assets / "settings.json")
    scene_name = args.scene or settings_desc.scene

    width, height = settings_desc.buffer_size
    if args.size:
        width = height = args.size
    rset = RenderSettings(
        width=width,
        height=height,
        max_samples=args.spp or settings_desc.max_samples,
        max_path_depth=args.depth or settings_desc.max_path_depth,
        environment_use=settings_desc.environment_use,
        environment_auto=settings_desc.environment_auto,
        environment_color=settings_desc.environment_color,
        environment_intensity=settings_desc.environment_intensity,
        use_nee=args.nee,
    )
    scene = compile_scene(assets, scene_name, (width, height), device=device)
    accel = film_mod.make_accel(scene, args.intersector, cluster_size=args.cluster_size)

    test = settings_desc.test
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def single_frame():
        path = out_dir / f"{scene_name}.png"
        write_png_rgba8(path, quantize_rgba8(_render(scene, rset, args, accel, getattr(args, "checkpoint", None))))
        print(f"Image written to {path}")
        return [path]

    if test is None or args.no_sweep:
        return single_frame()
    names = [d.name for d in parse_materials(assets / f"{scene_name}.json")]
    if test.material_name not in names:
        # the sweep block does not apply to this (overridden) scene
        print(f"note: sweep material {test.material_name!r} not in scene {scene_name!r}; "
              "rendering a single frame instead")
        return single_frame()
    mat_index = names.index(test.material_name)
    values = test.vec_values if test.vec_values else test.flt_values
    attr = "base_color" if test.vec_values else test.attribute_name

    outputs = []
    ck = getattr(args, "checkpoint", None)
    for i, value in enumerate(sweep_values(values, test.step_size)):
        print("TRACING")
        swept = set_material_attribute(scene, mat_index, attr, value)
        t0 = time.time()
        img = _render(swept, rset, args, accel, None if ck is None else f"{ck}.{i}")
        path = out_dir / f"{scene_name}_{test.name}_{test.attribute_name}({format_value(value)}).png"
        write_png_rgba8(path, quantize_rgba8(img))
        print(f"Image written to {path}  [{time.time() - t0:.1f}s]")
        outputs.append(path)
    return outputs


def _render(scene, rset, args, accel, checkpoint=None):
    """One frame -> linear float32 [H,W,3] numpy image, row 0 the top;
    ``checkpoint`` is the wavefront's checkpoint path."""
    if args.renderer == "wavefront":
        from ..render.wavefront import render_image_wavefront

        img, _rays = render_image_wavefront(scene, rset, accel, lanes=args.lanes, fused2_block=args.fused2_block,
                                            fused2_sort=getattr(args, "sort", False), checkpoint_path=checkpoint,
                                            checkpoint_every_s=getattr(args, "checkpoint_every", 600.0),
                                            progress=checkpoint is not None)
    else:
        img = film_mod.render_image(scene, rset, pixel_chunk=args.pixel_chunk, accel=accel)
    return img.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="owlpt", description="Wavefront path tracer on PyTorch + CUDA")
    ap.add_argument("--assets", default="assets", help="assets directory (settings.json inside)")
    ap.add_argument("--scene", default=None, help="override scene name")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--size", type=int, default=None, help="square buffer override")
    ap.add_argument(
        "--intersector",
        choices=["brute", "bvh", "cluster", "fused", "fused2", "fused2-bf16"],
        default="cluster",
        help="cluster = exact cluster query; fused = the same clusters through the fused kernel; "
             "fused2 / fused2-bf16 = fat-cluster kernel with f32 / bf16 planes; brute = every triangle; "
             "bvh = per-ray-stack BVH traversal",
    )
    ap.add_argument("--cluster-size", type=int, default=None,
                    help="tris per cluster (default: 128; 512 for fused2)")
    ap.add_argument("--pixel-chunk", type=int, default=65536)
    ap.add_argument(
        "--renderer", choices=["scan", "wavefront"], default="scan",
        help="wavefront = persistent-pool path regeneration (production/benchmark path)",
    )
    ap.add_argument("--lanes", type=int, default=131072, help="wavefront pool size (lanes)")
    ap.add_argument("--fused2-block", type=int, default=None,
                    help="rays per fused2 kernel block (default ops/fused2.BLOCK_RAYS)")
    ap.add_argument("--nee", action="store_true", help="next-event estimation + MIS")
    ap.add_argument("--sort", action="store_true",
                    help="wavefront: per-wave coherence sort (scene-adaptive morton/cid2 key)")
    ap.add_argument("--checkpoint", default=None,
                    help="wavefront: film checkpoint path (resumes from it if present)")
    ap.add_argument("--checkpoint-every", type=float, default=600.0,
                    help="seconds between checkpoints (default 600)")
    ap.add_argument("--no-sweep", action="store_true", help="single frame, ignore test block")
    ap.add_argument("--device", default="cuda", help="torch device to render on (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    return run_sweep(args)


if __name__ == "__main__":
    main()
