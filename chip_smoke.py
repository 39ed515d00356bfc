#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (owl_path_tracer_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py            # main path at spp 8
    python3 chip_smoke.py --spp 64   # the headline spp

Phases (one line each, with times; any failure exits non-zero):
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build the kernels from csrc/ (nvcc, sm_90a);
  3. kernel vs plain version on a small triangle soup, blocks 128 and 256,
     per-ray t_max, padding rays, and max_steps=1 (unresolved blocks);
  4. kernel vs plain version at the main path's shapes: the dragon scene at
     icosphere subdivision 7 (~328k triangles), one 131072-ray wave of
     primaries through the image centre and the bounce wave the port's own
     trace_bounce makes of it; median
     of timed runs (CUDA events) for both;
  5. frame parity: cornell-box 64x64, spp 4, depth 4, rendered on the GPU
     and through the port on the CPU (plain version), golden rule;
  6. main path: dragon sub 7, 1024x1024, depth 4, auto sky, 131072 lanes,
     block 256, sort on; kernel launch counts are reset just before it.
The second-to-last lines are the kernels JSON and the GPU's nvidia-smi line;
the last line is {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package; the dragon scene file is made
by assets/generate.py in a child process.  Needs no network.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# main path (bench.py's headline configuration, spp from --spp)
DRAGON_SUB, SIZE, DEPTH, LANES, BLOCK = 7, 1024, 4, 131072, 256
# frame-parity configuration
FRAME_SCENE, FRAME_SIZE, FRAME_SPP, FRAME_LANES = "cornell-box", 64, 4, 4096
SOURCE = "owl_path_tracer_tpu_torch/csrc/fused2_traverse.cu"
REPLACES = "owl_path_tracer_tpu/ops/fused2.py:269"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.2f} s", flush=True)


def run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=600, **kw).stdout.strip()


def ensure_dragon(sub: int) -> str:
    """Write assets/dragon{sub}.{json,obj.scene} (generate.py), in a child process."""
    code = (
        "import sys; sys.path.insert(0, 'assets'); import generate\n"
        f"name = 'dragon{sub}'\n"
        "js = generate.HERE / f'{name}.json'\n"
        "js.exists() or js.write_text((generate.HERE / 'dragon.json').read_text())\n"
        "obj = generate.HERE / f'{name}.obj.scene'\n"
        f"obj.exists() or generate.gen_dragon_scene(obj, {sub})\n"
        "print(name)\n"
    )
    return run([sys.executable, "-c", code], cwd=ROOT)


def cuda_ms(fn, reps: int = 3):
    """Median milliseconds of ``reps`` timed calls after one warm-up (CUDA events)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(got, want, allow_ties: bool):
    """Kernel output vs plain output ([N,32]) -> max |t,u,v| error on agreeing rows.

    tri must match exactly, except (``allow_ties``) where both t agree to
    5e-6 relative -- a true tie between triangles of different clusters.
    Agreeing rows: t/u/v to rtol 5e-6 and the attribute blob exactly."""
    import torch

    check(bool((got[:, 5] == 1).all()), "kernel left rays unresolved")
    same = got[:, 3] == want[:, 3]
    if allow_ties:
        tie = torch.isclose(got[:, 0], want[:, 0], rtol=5e-6, atol=0)
        check(bool((same | tie).all()), f"{int((~same & ~tie).sum())} winners differ beyond ties")
    else:
        check(bool(same.all()), f"{int((~same).sum())} winners differ")
    g, w = got[same], want[same]
    for col in (4, 7, 8):
        check(bool((g[:, col] == w[:, col]).all()), f"column {col} differs")
    check(bool((g[:, 16:32] == w[:, 16:32]).all()), "attribute blob differs")
    torch.testing.assert_close(g[:, 0:3], w[:, 0:3], rtol=5e-6, atol=1e-6)
    return float((g[:, 0:3] - w[:, 0:3]).abs().max()) if len(g) else 0.0, int((~same).sum())


def soup(device):
    """3000 random triangles (C=64) and 300 rays, half with a finite t_max."""
    import numpy as np
    import torch

    from owl_path_tracer_tpu_torch.ops import fused2

    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(9000, dtype=np.int32).reshape(3000, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    tc = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    mat = r.integers(0, 5, 3000).astype(np.int32)
    fb = fused2.build_fused2(verts, idx, 64, normals, tc, mat, device=device)
    n = 300  # not a multiple of either block: padding rays
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    return fb, [torch.as_tensor(x, device=device) for x in (o, d, tmax)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=8, help="main-path samples per pixel (64: headline)")
    args = ap.parse_args()

    if not (ROOT / "owl_path_tracer_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure(f"{ROOT} is not a checkout of the repository (no owl_path_tracer_tpu_torch)")
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.native import nvcc_path
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops.fused2 import pack_rays
    from owl_path_tracer_tpu_torch.render import integrator, wavefront
    from owl_path_tracer_tpu_torch.render.film import make_accel

    from owl_path_tracer_tpu_torch.render.film import scene_has_textures

    dev = torch.device("cuda", 0)
    results = {"max_abs_err": 0.0}

    # 1 ── environment
    t0 = time.perf_counter()
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"])
    print(smi, flush=True)
    lines = run([nvcc_path(), "--version"]).splitlines()
    nvcc = next((ln for ln in lines if "release" in ln), lines[-1])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc}, python {sys.version.split()[0]}")
    phase("1 environment", t0)

    # 2 ── build
    t0 = time.perf_counter()
    path, seconds, log = fused2.build_kernels()
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"built {path.name} in {seconds:.2f} s")
    phase("2 build", t0)

    # 3 ── kernel vs plain, small
    t0 = time.perf_counter()
    fb, (o, d, tmax) = soup(dev)
    for block in (128, 256):
        rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
        got = fused2.fused2_traverse_packed(rays, fb, block=block)
        want = fused2.fused2_traverse_packed_plain(rays, fb)
        err, _ = compare(got, want, allow_ties=False)
        check(bool((got[300:, 4] == 0).all()), "a padding ray hit")
        results["max_abs_err"] = max(results["max_abs_err"], err)
        print(f"  soup block {block}: {int(got[:, 4].sum())}/300 hits, max |tuv err| {err:.3g}")
    overflow = fused2.fused2_traverse_packed(pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3]), fb,
                                             block=128, max_steps=1)
    check(bool((overflow[:, 5] == 0).any()), "max_steps=1 left no block unresolved")
    rec, blob = fused2.fused2_closest_hit(o, d, fb, t_max=tmax, max_steps=1)
    ref, ref_blob = fused2._hits_from_output(
        fused2.fused2_traverse_packed_plain(pack_rays(o, d, tmax), fb), o, d, fb, 1e-3, tmax)
    check(bool((rec.tri == ref.tri).all()) and bool((blob == ref_blob).all()), "max_steps=1 differs")
    torch.testing.assert_close(rec.t, ref.t, rtol=5e-6, atol=1e-6)
    print(f"  max_steps=1: {int((overflow[:, 5] == 0).sum())} rays unresolved, answers equal the plain version")
    phase("3 kernel vs plain, small", t0)

    # 4 ── kernel vs plain at the main path's shapes
    t0 = time.perf_counter()
    dragon = ensure_dragon(DRAGON_SUB)
    size, lanes, block = SIZE, LANES, BLOCK
    scene = compile_scene(ROOT / "assets", dragon, (size, size), device=dev)
    accel = make_accel(scene, "fused2")
    mode = fused2.auto_sort_mode(scene)
    print(f"  {dragon}: {scene.num_tris} triangles, K={accel.num_clusters} C={accel.cluster_size}, sort {mode}")
    settings = RenderSettings(width=size, height=size, max_samples=args.spp, max_path_depth=DEPTH,
                              environment_auto=True)
    # a mid-frame wave: the work items of the rows through the image centre
    ids = settings.width * settings.height * args.spp // 2 - lanes // 2 + torch.arange(lanes, device=dev)
    _, ray_o, ray_d, rng = wavefront._spawn(scene, settings, ids)
    state = integrator.PathState(
        ray_o=ray_o, ray_d=ray_d, result=torch.zeros_like(ray_o), throughput=torch.ones_like(ray_o),
        rng=rng, alive=torch.ones(lanes, dtype=torch.bool, device=dev),
        prev_lobe=torch.full((lanes,), -1, dtype=torch.int64, device=dev),
        depth=torch.zeros(lanes, dtype=torch.int64, device=dev), prev_pdf=torch.zeros(lanes, device=dev),
    )
    isect, _ = integrator.make_intersectors(scene, accel, fused2_block=block, fused2_sort=mode)
    bounce = integrator.trace_bounce(scene, settings, state, isect, scene_has_textures(scene))
    waves = {
        "primary": (state.ray_o, state.ray_d),
        "bounce": (torch.where(bounce.alive[:, None], bounce.ray_o, wavefront.PARK), bounce.ray_d),
    }
    timing = {}
    for name, (wo, wd) in waves.items():
        tm = torch.full((lanes,), 1e10, device=dev)
        keys = fused2.wave_sort_keys(wo, wd, tm, accel, mode=mode)
        rays = pack_rays(wo, wd, tm)[torch.sort(keys, stable=True).indices]
        got = fused2.fused2_traverse_packed(rays, accel, block=block)
        want = fused2.fused2_traverse_packed_plain(rays, accel)
        err, ties = compare(got, want, allow_ties=True)
        results["max_abs_err"] = max(results["max_abs_err"], err)
        k_ms = cuda_ms(lambda: fused2.fused2_traverse_packed(rays, accel, block=block))
        p_ms = cuda_ms(lambda: fused2.fused2_traverse_packed_plain(rays, accel))
        timing[name] = (k_ms, p_ms)
        steps = got[:, 6].reshape(-1, block)[:, 0]
        print(f"  {name} wave: {int(got[:, 4].sum())}/{lanes} hits, {ties} tie swaps, "
              f"max |tuv err| {err:.3g}, clusters/block mean {float(steps.mean()):.1f} max {int(steps.max())}, "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    results["ms"], results["plain_ms"] = timing["bounce"]
    phase("4 kernel vs plain, main-path shapes", t0)

    # 5 ── frame parity: GPU (kernel) vs CPU (plain version)
    t0 = time.perf_counter()
    fset = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP,
                          max_path_depth=DEPTH, environment_auto=True)
    cpu_scene = compile_scene(ROOT / "assets", FRAME_SCENE, (FRAME_SIZE, FRAME_SIZE), device="cpu")
    cpu_accel = make_accel(cpu_scene, "fused2")
    want, rays_want = wavefront.render_image_wavefront(cpu_scene, fset, cpu_accel, lanes=FRAME_LANES,
                                                       fused2_block=block, fused2_sort=True)
    img, rays_got = wavefront.render_image_wavefront(cpu_scene.to(dev), fset, cpu_accel.to(dev),
                                                     lanes=FRAME_LANES, fused2_block=block,
                                                     fused2_sort=True)
    img = img.cpu()
    close = torch.isclose(img, want, rtol=1e-4, atol=1e-5).float().mean().item()
    mean_rel = abs(img.mean().item() - want.mean().item()) / abs(want.mean().item())
    print(f"  {FRAME_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP}: {close:.4%} pixels close, mean rel diff {mean_rel:.2e}, "
          f"rays {rays_got} vs {rays_want}")
    check(close > 0.995 and mean_rel < 1e-3, "GPU frame fails the golden rule against the CPU frame")
    check(abs(rays_got - rays_want) <= 0.005 * rays_want, "ray counts differ by more than 0.5%")
    phase("5 frame parity", t0)

    # 6 ── main path
    t0 = time.perf_counter()
    warm = RenderSettings(width=size, height=size, max_samples=1, max_path_depth=DEPTH,
                          environment_auto=True)
    wavefront.render_image_wavefront(scene, warm, accel, lanes=lanes, fused2_block=block, fused2_sort=True)
    torch.cuda.synchronize()
    fused2.KERNEL_LAUNCHES = 0
    fused2.UNRESOLVED_RAYS = 0
    start = time.perf_counter()
    img, rays = wavefront.render_image_wavefront(scene, settings, accel, lanes=lanes, fused2_block=block,
                                                 fused2_sort=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, unresolved = fused2.KERNEL_LAUNCHES, fused2.UNRESOLVED_RAYS
    check(launches > 0, "the main path launched no traversal kernel")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(img.shape == (size, size, 3), f"image shape {tuple(img.shape)}")
    check(0.0 < img.mean().item() < 10.0, f"implausible image mean {img.mean().item()}")
    print(f"  {dragon} {size}x{size} spp {args.spp} depth {DEPTH}: {rays} rays in {seconds:.3f} s = "
          f"{rays / seconds / 1e6:.3f} Mrays/s; kernel launches {launches}, unresolved rays "
          f"{unresolved}, image mean {img.mean().item():.6f}")
    phase("6 main path", t0)

    check("jax" not in sys.modules and "owl_path_tracer_tpu" not in sys.modules,
          "the JAX package was imported")
    print(json.dumps({"kernels": [{
        "name": "fused2_closest_hit", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": results["max_abs_err"],
        "ms": results["ms"], "plain_ms": results["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except (SmokeFailure, subprocess.CalledProcessError, AssertionError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
