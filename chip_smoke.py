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
  3b. the any-hit (K2) and mixed (K3) modes vs their plain versions on the
     soup: blocks 128 and 256, per-ray t_max, max_steps=1;
  4b. K2 and K3 vs plain at the NEE path's shapes (cornell-box, C=512,
     cid2): a 131072-ray wave of shadow rays from the bounce wave's vertices
     toward sample_lights points, and the 262144-ray mixed wave the deferred
     form traces (those bounce rays plus those shadow rays); CUDA events;
  5. frame parity: cornell-box 64x64, spp 4, depth 4, rendered on the GPU
     and through the port on the CPU (plain version), golden rule;
  5b. the same with NEE, both forms, card vs CPU, and the deferred form vs
     the separate one on the card;
  6. main path: dragon sub 7, 1024x1024, depth 4, auto sky, 131072 lanes,
     block 256, sort on; kernel launch counts are reset just before it;
  6b. the NEE main path: cornell-box 1024x1024, depth 4, NEE on, 131072
     lanes, block 256, sort on (cid2), once separate (fused_nee=False) and
     once deferred (fused_nee=True), counts reset just before each.
The second-to-last lines are the kernels JSON and the GPU's nvidia-smi line;
the last line is {"ok": true, "device": {...}}.  Each kernel's bound_ms is
the larger of two times at the wave it was timed on: its Moller-Trumbore
operations (45 fp32 operations per ray and slot of each cluster that ray's
exact query needs, see needed_clusters) over the H100's published 67 TFLOP/s
fp32 peak (700 W), and its bytes (inputs read once, output written once) over
3.35 TB/s.

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
# NEE configuration (docs/PERF.md round 3's NEE cell)
NEE_SCENE = "cornell-box"
SOURCE = "owl_path_tracer_tpu_torch/csrc/fused2_traverse.cu"
REPLACES = "owl_path_tracer_tpu/ops/fused2.py:269"
# bound: Moller-Trumbore fp32 operations per ray, slot and needed cluster;
# published peaks of one H100 SXM at 700 W (fp32 FLOP/s outside the tensor
# cores, HBM bytes/s)
MT_OPS, FP32_FLOPS, HBM_BYTES_S = 45, 67e12, 3.35e12


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


def k2_error(got, want, rays):
    """Largest difference of an any-hit output from its contract: the
    occlusion flag against the plain version's, and t (column 0) against the
    ray's tmax, which any-hit mode never lowers."""
    return max(float((got[:, 4] - want[:, 4]).abs().max()), float((got[:, 0] - rays[:, 6]).abs().max()))


def needed_clusters(rays, want, fb, any_hit):
    """Per ray [N], the clusters an exact query has to test on these inputs.

    ``want`` is the plain version's output on ``rays`` and ``any_hit`` [N]
    marks the occlusion lanes.  A closest-hit lane needs every cluster whose
    box it enters before its closest hit (t = tmax on a miss): the plain
    version's entry-ordered walk tests exactly these.  An occluded any-hit
    lane needs one cluster; one that is not occluded needs every cluster whose
    box meets its window."""
    import torch

    from owl_path_tracer_tpu_torch.ops import math as m
    from owl_path_tracer_tpu_torch.ops.cluster import _cluster_entries

    counts = []
    for lo in range(0, rays.shape[0], 16384):
        r, w, ah = rays[lo : lo + 16384], want[lo : lo + 16384], any_hit[lo : lo + 16384]
        best_t = torch.where(ah, r[:, 6], w[:, 0])
        entries = _cluster_entries(r[:, 0:3], r[:, 3:6], fb.cluster, m.T_MIN, r[:, 6])
        n = (entries < best_t[:, None]).sum(1)
        counts.append(torch.where(ah & (w[:, 4] > 0), 1, n))
    return torch.cat(counts)


def bound(rays, want, fb, any_hit, with_attrs=True):
    """(bound_ms, bound_by, needed clusters per ray) of one kernel call: the
    Moller-Trumbore operations of the clusters each ray needs over the fp32
    peak, vs inputs read once and output written once over HBM bytes/s."""
    need = needed_clusters(rays, want, fb, any_hit)
    ops = MT_OPS * fb.cluster_size * float(need.sum())
    nbytes = 4 * (rays.numel() + want.numel() + fb.boxes.numel() + fb.planes.numel()
                  + (fb.attrs.numel() if with_attrs else 0))
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")), float(need.float().mean())


def golden(img, want, rays_got, rays_want, what):
    """The golden rule of tests/test_golden.py, and ray counts within 0.5%."""
    import torch

    close = torch.isclose(img, want, rtol=1e-4, atol=1e-5).float().mean().item()
    mean_rel = abs(img.mean().item() - want.mean().item()) / abs(want.mean().item())
    print(f"  {what}: {close:.4%} pixels close, mean rel diff {mean_rel:.2e}, rays {rays_got} vs {rays_want}")
    check(close > 0.995 and mean_rel < 1e-3, f"{what} fails the golden rule")
    check(abs(rays_got - rays_want) <= 0.005 * rays_want, f"{what}: ray counts differ by more than 0.5%")


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
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from owl_path_tracer_tpu_torch.models.lights import build_light_table, sample_lights
    from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
    from owl_path_tracer_tpu_torch.native import nvcc_path
    from owl_path_tracer_tpu_torch.ops import fused2
    from owl_path_tracer_tpu_torch.ops import math as m
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
        if any(w in line for w in ("registers", "smem", "spill", "Compiling entry")):
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

    # 3b ── any-hit (K2) and mixed (K3) vs plain, small
    t0 = time.perf_counter()
    err2, err3 = 0.0, 0.0
    r = np.random.default_rng(1)
    shadow = torch.as_tensor(np.arange(300) % 2 == 1, device=dev)
    dist = torch.as_tensor(np.where(shadow.cpu().numpy(), r.uniform(2.0, 20.0, 300), 1e10).astype(np.float32),
                           device=dev)
    for block in (128, 256):
        rays = pack_rays(*fused2._pad_rays(o, d, tmax, block)[:3])
        got = fused2.fused2_traverse_packed(rays, fb, block=block, mode="any_hit")
        want = fused2.fused2_traverse_packed_plain(rays, fb, mode="any_hit")
        check(bool((got[:, 5] == 1).all()), "K2 left rays unresolved")
        e2 = k2_error(got, want, rays)
        check(e2 == 0.0, f"K2 differs from the plain version (flags) or lowered t: max error {e2}")
        err2 = max(err2, e2)
        o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, block)
        sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)])
        rays = pack_rays(o_p, d_p, t_p, sh_p)
        got = fused2.fused2_traverse_packed(rays, fb, block=block, mode="mixed")
        want = fused2.fused2_traverse_packed_plain(rays, fb, mode="mixed")
        e, _ = compare(got[~sh_p], want[~sh_p], allow_ties=False)
        err3 = max(err3, e)
        check(bool((got[sh_p, 5] == 1).all()), "K3 left shadow rays unresolved")
        check(bool((got[sh_p, 4] == want[sh_p, 4]).all()), "K3 shadow flags differ from the plain version")
        print(f"  soup block {block}: K2 {int(want[:300, 4].sum())}/300 occluded, identical; K3 "
              f"{int(want[sh_p, 4].sum())}/{int(sh_p.sum())} shadow lanes occluded, identical, closest-hit "
              f"lanes max |tuv err| {e:.3g}")
    # max_steps=1 leaves rows unresolved in both modes (closest and shadow
    # lanes in K3), so the wrappers' exact fallback runs
    o_p, d_p, t_p, _ = fused2._pad_rays(o, d, tmax, 128)
    out = fused2.fused2_traverse_packed(pack_rays(o_p, d_p, t_p), fb, block=128, max_steps=1, mode="any_hit")
    check(bool((out[:, 5] == 0).any()), "K2 max_steps=1 left no ray unresolved")
    o_p, d_p, t_p, _ = fused2._pad_rays(o, d, dist, 128)
    sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - 300)])
    out = fused2.fused2_traverse_packed(pack_rays(o_p, d_p, t_p, sh_p), fb, block=128, max_steps=1, mode="mixed")
    check(bool((out[sh_p, 5] == 0).any()) and bool((out[~sh_p, 5] == 0).any()),
          "K3 max_steps=1 left no shadow or no closest-hit ray unresolved")
    cpu_fb = fb.to("cpu")
    oc, dc, tc, distc, shc = (x.cpu() for x in (o, d, tmax, dist, shadow))
    unresolved = fused2.UNRESOLVED_RAYS
    occ = fused2.fused2_occluded(o, d, fb, t_max=tmax, max_steps=1)
    check(fused2.UNRESOLVED_RAYS > unresolved, "fused2_occluded max_steps=1 sent no row to the exact query")
    check(bool((occ.cpu() == fused2.fused2_occluded(oc, dc, cpu_fb, t_max=tc)).all()), "K2 max_steps=1 differs")
    unresolved = fused2.UNRESOLVED_RAYS
    rec, blob, occ = fused2.fused2_sweep_mixed(o, d, dist, shadow, fb, max_steps=1)
    check(fused2.UNRESOLVED_RAYS > unresolved, "fused2_sweep_mixed max_steps=1 sent no row to the exact query")
    ref, ref_blob, ref_occ = fused2.fused2_sweep_mixed(oc, dc, distc, shc, cpu_fb)
    check(bool((occ.cpu()[shc] == ref_occ[shc]).all()), "K3 max_steps=1 shadow flags differ")
    check(bool((rec.tri.cpu()[~shc] == ref.tri[~shc]).all()), "K3 max_steps=1 winners differ")
    check(bool((blob.cpu()[~shc] == ref_blob[~shc]).all()), "K3 max_steps=1 blobs differ")
    torch.testing.assert_close(rec.t.cpu()[~shc], ref.t[~shc], rtol=5e-6, atol=1e-6)
    print("  max_steps=1: both modes left rows unresolved; K2 and K3 wrapper answers equal the plain version's")
    results["k2_err"], results["k3_err"] = err2, err3
    phase("3b any-hit and mixed vs plain, small", t0)

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
        bnd, need = bound(rays, want, accel, torch.zeros_like(got[:, 0], dtype=torch.bool))
        results[f"k1_bound_{name}"] = bnd
        steps = got[:, 6].reshape(-1, block)[:, 0]
        print(f"  {name} wave: {int(got[:, 4].sum())}/{lanes} hits, {ties} tie swaps, "
              f"max |tuv err| {err:.3g}, clusters/block mean {float(steps.mean()):.1f} max {int(steps.max())}, "
              f"clusters needed/ray mean {need:.3f}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    results["ms"], results["plain_ms"] = timing["bounce"]
    results["k1_bound"] = results["k1_bound_bounce"]
    phase("4 kernel vs plain, main-path shapes", t0)

    # 4b ── K2 and K3 vs plain at the NEE path's shapes
    t0 = time.perf_counter()
    nee_scene = compile_scene(ROOT / "assets", NEE_SCENE, (size, size), env_map_path=None, device=dev)
    nee_accel = make_accel(nee_scene, "fused2")
    nee_mode = fused2.auto_sort_mode(nee_scene)
    lights = build_light_table(nee_scene)
    print(f"  {NEE_SCENE}: {nee_scene.num_tris} triangles, {lights.count} light triangles, "
          f"K={nee_accel.num_clusters} C={nee_accel.cluster_size}, sort {nee_mode}")
    nset = RenderSettings(width=size, height=size, max_samples=args.spp, max_path_depth=DEPTH,
                          environment_auto=True, use_nee=True)
    _, ray_o, ray_d, rng = wavefront._spawn(nee_scene, nset, ids)
    state = integrator.PathState(
        ray_o=ray_o, ray_d=ray_d, result=torch.zeros_like(ray_o), throughput=torch.ones_like(ray_o),
        rng=rng, alive=torch.ones(lanes, dtype=torch.bool, device=dev),
        prev_lobe=torch.full((lanes,), -1, dtype=torch.int64, device=dev),
        depth=torch.zeros(lanes, dtype=torch.int64, device=dev), prev_pdf=torch.zeros(lanes, device=dev),
    )
    isect, _ = integrator.make_intersectors(nee_scene, nee_accel, fused2_block=block, fused2_sort=nee_mode)
    bounce = integrator.trace_bounce(nee_scene, nset, state, isect, False)
    # shadow rays from the bounce wave's vertices (its rays' origins) toward light samples
    u3 = torch.as_tensor(np.random.default_rng(2).random((lanes, 3), dtype=np.float32), device=dev)
    ls = sample_lights(lights, bounce.ray_o, u3)
    on = bounce.alive & (ls.pdf > 0)
    sh_o = torch.where(on[:, None], bounce.ray_o, wavefront.PARK)
    sh_d = torch.where(on[:, None], ls.direction, torch.tensor([0.0, 0.0, 1.0], device=dev))
    sh_t = torch.where(on, ls.distance - m.T_MIN, m.T_MIN)
    b_o = torch.where(bounce.alive[:, None], bounce.ray_o, wavefront.PARK)
    b_t = torch.full((lanes,), m.T_MAX, device=dev)
    keys = fused2.wave_sort_keys(sh_o, sh_d, sh_t, nee_accel, mode=nee_mode)
    rays2 = pack_rays(sh_o, sh_d, sh_t)[torch.sort(keys, stable=True).indices]
    got = fused2.fused2_traverse_packed(rays2, nee_accel, block=block, mode="any_hit")
    want = fused2.fused2_traverse_packed_plain(rays2, nee_accel, mode="any_hit")
    check(bool((got[:, 5] == 1).all()), "K2 left rays unresolved at the NEE shapes")
    e2 = k2_error(got, want, rays2)
    check(e2 == 0.0, f"K2 differs from the plain version at the NEE shapes: max error {e2}")
    results["k2_err"] = max(results["k2_err"], e2)
    results["k2_ms"] = cuda_ms(lambda: fused2.fused2_traverse_packed(rays2, nee_accel, block=block, mode="any_hit"))
    results["k2_plain_ms"] = cuda_ms(lambda: fused2.fused2_traverse_packed_plain(rays2, nee_accel, mode="any_hit"))
    results["k2_bound"], need = bound(rays2, want, nee_accel, torch.ones_like(got[:, 0], dtype=torch.bool),
                                      with_attrs=False)
    steps = got[:, 6].reshape(-1, block)[:, 0]
    print(f"  shadow wave: {int(on.sum())}/{lanes} live, {int(got[:, 4].sum())} occluded (identical flags), "
          f"max error {e2}, clusters/block mean {float(steps.mean()):.2f} max {int(steps.max())}, "
          f"clusters needed/ray mean {need:.3f}, "
          f"K2 {results['k2_ms']:.3f} ms, plain {results['k2_plain_ms']:.3f} ms, "
          f"bound {results['k2_bound'][0]:.4f} ms ({results['k2_bound'][1]})")

    comb_o, comb_d = torch.cat([b_o, sh_o]), torch.cat([bounce.ray_d, sh_d])
    comb_t = torch.cat([b_t, sh_t])
    comb_sh = torch.cat([torch.zeros(lanes, dtype=torch.bool, device=dev), torch.ones(lanes, dtype=torch.bool, device=dev)])
    keys = fused2.wave_sort_keys(comb_o, comb_d, comb_t, nee_accel, mode=nee_mode)
    keys = keys | (comb_sh.to(torch.int64) << fused2.SHADOW_CLASS_BIT)
    perm = torch.sort(keys, stable=True).indices
    rays3, sh3 = pack_rays(comb_o, comb_d, comb_t, comb_sh)[perm], comb_sh[perm]
    got = fused2.fused2_traverse_packed(rays3, nee_accel, block=block, mode="mixed")
    want = fused2.fused2_traverse_packed_plain(rays3, nee_accel, mode="mixed")
    err, ties = compare(got[~sh3], want[~sh3], allow_ties=True)
    results["k3_err"] = max(results["k3_err"], err)
    check(bool((got[sh3, 5] == 1).all()), "K3 left shadow rays unresolved at the NEE shapes")
    check(bool((got[sh3, 4] == want[sh3, 4]).all()), "K3 shadow flags differ from the plain version")
    results["k3_ms"] = cuda_ms(lambda: fused2.fused2_traverse_packed(rays3, nee_accel, block=block, mode="mixed"))
    results["k3_plain_ms"] = cuda_ms(lambda: fused2.fused2_traverse_packed_plain(rays3, nee_accel, mode="mixed"))
    results["k3_bound"], need = bound(rays3, want, nee_accel, sh3)
    steps = got[:, 6].reshape(-1, block)[:, 0]
    print(f"  mixed wave ({2 * lanes} rays): {int(got[~sh3, 4].sum())} bounce hits, {ties} tie swaps, "
          f"max |tuv err| {err:.3g}, {int(got[sh3, 4].sum())} shadow rays occluded (identical flags), "
          f"clusters/block mean {float(steps.mean()):.2f} max {int(steps.max())}, "
          f"clusters needed/ray mean {need:.3f}, "
          f"K3 {results['k3_ms']:.3f} ms, plain {results['k3_plain_ms']:.3f} ms, "
          f"bound {results['k3_bound'][0]:.4f} ms ({results['k3_bound'][1]})")
    phase("4b any-hit and mixed vs plain, NEE shapes", t0)

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
    golden(img.cpu(), want, rays_got, rays_want,
           f"{FRAME_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP}, GPU vs CPU")
    phase("5 frame parity", t0)

    # 5b ── NEE frame parity, both forms
    t0 = time.perf_counter()
    nset_small = RenderSettings(width=FRAME_SIZE, height=FRAME_SIZE, max_samples=FRAME_SPP,
                                max_path_depth=DEPTH, environment_auto=True, use_nee=True)
    cpu_scene = compile_scene(ROOT / "assets", NEE_SCENE, (FRAME_SIZE, FRAME_SIZE), env_map_path=None,
                              device="cpu")
    cpu_accel = make_accel(cpu_scene, "fused2")
    frames = {}
    for fused_nee in (False, True):
        form = "deferred" if fused_nee else "separate"
        want, rays_want = wavefront.render_image_wavefront(
            cpu_scene, nset_small, cpu_accel, lanes=FRAME_LANES, fused2_block=block, fused2_sort=True,
            fused_nee=fused_nee)
        img, rays_got = wavefront.render_image_wavefront(
            cpu_scene.to(dev), nset_small, cpu_accel.to(dev), lanes=FRAME_LANES, fused2_block=block,
            fused2_sort=True, fused_nee=fused_nee)
        frames[form] = (img.cpu(), rays_got)
        golden(frames[form][0], want, rays_got, rays_want,
               f"{NEE_SCENE} {FRAME_SIZE}x{FRAME_SIZE} spp {FRAME_SPP} NEE {form}, GPU vs CPU")
    (img_s, rays_s), (img_d, rays_d) = frames["separate"], frames["deferred"]
    check(rays_s == rays_d, f"deferred form traced {rays_d} rays, separate {rays_s}")
    torch.testing.assert_close(img_d, img_s, rtol=1e-4, atol=1e-5)
    print(f"  GPU deferred vs separate: equal to rtol 1e-4 / atol 1e-5, max |diff| "
          f"{float((img_d - img_s).abs().max()):.3g}, rays {rays_d} both")
    phase("5b NEE frame parity", t0)

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
    k1_launches = launches

    # 6b ── the NEE main path, separate and deferred
    t0 = time.perf_counter()
    warm = RenderSettings(width=size, height=size, max_samples=1, max_path_depth=DEPTH,
                          environment_auto=True, use_nee=True)
    for fused_nee in (False, True):
        wavefront.render_image_wavefront(nee_scene, warm, nee_accel, lanes=lanes, fused2_block=block,
                                         fused2_sort=True, fused_nee=fused_nee)
    nee_launches = {}
    for fused_nee in (False, True):
        form = "deferred" if fused_nee else "separate"
        torch.cuda.synchronize()
        fused2.KERNEL_LAUNCHES = fused2.OCCLUDE_LAUNCHES = fused2.MIXED_LAUNCHES = 0
        fused2.UNRESOLVED_RAYS = 0
        start = time.perf_counter()
        img, rays = wavefront.render_image_wavefront(nee_scene, nset, nee_accel, lanes=lanes, fused2_block=block,
                                                     fused2_sort=True, fused_nee=fused_nee)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = (fused2.KERNEL_LAUNCHES, fused2.OCCLUDE_LAUNCHES, fused2.MIXED_LAUNCHES)
        nee_launches[form] = counts
        check(bool(torch.isfinite(img).all()), f"NEE {form}: non-finite pixels")
        check(img.shape == (size, size, 3), f"NEE {form}: image shape {tuple(img.shape)}")
        check(0.0 < img.mean().item() < 10.0, f"NEE {form}: implausible image mean {img.mean().item()}")
        print(f"  {NEE_SCENE} NEE {form} {size}x{size} spp {args.spp} depth {DEPTH}: {rays} rays in "
              f"{seconds:.3f} s = {rays / seconds / 1e6:.3f} Mrays/s; launches K1 {counts[0]} K2 {counts[1]} "
              f"K3 {counts[2]}, unresolved rays {fused2.UNRESOLVED_RAYS}, image mean {img.mean().item():.6f}")
    check(nee_launches["separate"][0] > 0 and nee_launches["separate"][1] > 0,
          "the separate NEE path did not launch K1 and K2")
    check(nee_launches["deferred"][2] > 0, "the deferred NEE path did not launch K3")
    phase("6b NEE main path", t0)

    check("jax" not in sys.modules and "owl_path_tracer_tpu" not in sys.modules,
          "the JAX package was imported")
    def entry(name, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("fused2_closest_hit", k1_launches, results["max_abs_err"], results["ms"], results["plain_ms"],
              results["k1_bound"]),
        entry("fused2_occluded", nee_launches["separate"][1], results["k2_err"], results["k2_ms"],
              results["k2_plain_ms"],
              results["k2_bound"]),
        entry("fused2_sweep_mixed", nee_launches["deferred"][2], results["k3_err"], results["k3_ms"],
              results["k3_plain_ms"], results["k3_bound"]),
    ]}))
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
