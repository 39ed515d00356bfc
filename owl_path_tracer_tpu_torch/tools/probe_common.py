"""Shared pieces of the probes and tools (counterpart of
``tools/tpu_probe2.py``'s ``load``, ``make_rays`` and ``timeit``): the
generated scenes, the probe rays and a timer.

``assets/generate.py`` imports the JAX package's IO modules, so the scenes it
makes are written by a child process; the port itself never imports it.
"""
from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..models.camera import primary_rays
from ..models.scene import RenderSettings, compile_scene

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
ASSETS = REPO_ROOT / "assets"


def generate(code: str) -> str:
    """Run ``code`` with ``assets/generate.py`` imported as ``generate``, in a
    child process from the repository root -> its standard output."""
    prelude = "import sys; sys.path.insert(0, 'assets'); import generate\n"
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=REPO_ROOT, capture_output=True, text=True,
                          check=True, timeout=600).stdout.strip()


def ensure_dragon(sub: int) -> str:
    """Write ``assets/dragon{sub}.{json,obj.scene}`` unless present -> the scene name."""
    return generate(
        f"name = 'dragon{sub}'\n"
        "js = generate.HERE / f'{name}.json'\n"
        "js.exists() or js.write_text((generate.HERE / 'dragon.json').read_text())\n"
        "obj = generate.HERE / f'{name}.obj.scene'\n"
        f"obj.exists() or generate.gen_dragon_scene(obj, {sub})\n"
        "print(name)\n")


def generated_dragon(sub: int) -> str:
    """``assets/generate.py``'s own ``ensure_dragon``, as ``bench.py`` calls it
    (sub <= 6 is the shared ``dragon`` scene, larger subs ``dragon{sub}``)
    -> the scene name."""
    return generate(f"print(generate.ensure_dragon({sub}))").splitlines()[-1]


def sync(device):
    """Wait for the card's queued work on a CUDA device (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ensure_texture(rel: str):
    """Write the stand-in texture ``assets/<rel>`` (generate.py's checkerboard) unless present."""
    generate(f"tex = generate.HERE / {rel!r}\ntex.exists() or generate.gen_cube_texture(tex)\n")


def ensure_car() -> str:
    """Write ``assets/car.obj.scene`` and its Ground texture unless present -> the scene name."""
    generate("obj = generate.HERE / 'car.obj.scene'\nobj.exists() or generate.gen_car_scene(obj)\n")
    ensure_texture("Ground-textures/uv-texture.png")
    return "car"


def ensure_mitsuba() -> str:
    """Write ``assets/mitsuba.obj.scene`` unless present -> the scene name."""
    generate("obj = generate.HERE / 'mitsuba.obj.scene'\nobj.exists() or generate.gen_mitsuba_scene(obj)\n")
    return "mitsuba"


def load(sub: int, size: int = 1024, *, device):
    """The dragon at icosphere subdivision ``sub`` -> (scene, settings), the
    reference's probe configuration."""
    name = ensure_dragon(sub)
    scene = compile_scene(ASSETS, name, (size, size), device=device)
    settings = RenderSettings(width=size, height=size, max_samples=64, max_path_depth=4, environment_auto=True,
                              environment_intensity=1.0)
    return scene, settings


def make_rays(scene, n: int, kind: str = "primary", seed: int = 0):
    """``primary``: camera rays of consecutive pixels of a 1024x1024 frame,
    64 samples each; ``bounce``: those rays' points at t ~ U(0.5, 3) with
    random unit directions, randomly permuted.  The reference's numpy
    seeding and order -> (origins, directions) on the scene's device."""
    dev = scene.vertices.device
    r = np.random.default_rng(seed)
    pix = np.arange(n) // 64
    px, py = pix % 1024, pix // 1024
    jitter = r.uniform(0, 1, (n, 2)).astype(np.float32)
    o, d = primary_rays(scene.camera, torch.as_tensor(np.stack([px, py], -1), device=dev),
                        torch.as_tensor(jitter, device=dev), (1024, 1024))
    if kind == "primary":
        return o, d
    t = r.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    o2 = o.cpu().numpy() + d.cpu().numpy() * t
    d2 = r.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    perm = r.permutation(n)
    return torch.as_tensor(o2[perm], device=dev), torch.as_tensor(d2[perm], device=dev)


def time_ms(fn, device, repeats: int = 3) -> tuple:
    """(min, median) milliseconds of ``repeats`` calls of ``fn`` after one
    warm-up: CUDA events around each call on a CUDA device, the host clock
    on the CPU (where ``fn`` returns when its work is done)."""
    fn()
    times = []
    for _ in range(repeats):
        if torch.device(device).type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times), statistics.median(times)


def device_name(device) -> str:
    """The card's ``nvidia-smi`` name and power limit for a CUDA device, else ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()

