"""One run of one cell: set-up, the measured window of passes, the check
against the plain reference, and the metrics read by name.

Everything that belongs to a configuration, a traffic mix or a metric is in
a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (the scene, see ``scenes.py``, its render settings
and, under ``"reference"``, the module of ``reference/`` that renders its
passes again, ``render`` where it names none), ``traffic/<traffic>.json``
(the renderer, its accelerator, the pass and, under ``"options"``, further
keyword arguments of the renderer's entry point), ``limits/<cell>.json``
(the limit of each number compared) and ``metrics/<metric>.py`` (a
``read(readings)`` that returns the metric, or None where its run has
nothing to read).

A reference module has ``load_scene``, ``MODES`` (renderer -> the
arguments of ``render_pass`` after the scene and the sample base) and
``render_pass`` -> (image, live rays, clusters needed[, further work]): the
dict of further work counts joins ``Readings.work`` of a traced run.

The window is a closed loop: a pass starts when the previous pass's image
is on the host.  Pass k renders with sample base ``seed + k`` (its spp per
pass further for every pass).  The window runs passes until ``seconds``
have passed and finishes the pass in flight.

A traced run (``--trace 1``) times the program's ``owlpt.*`` ranges on the
host clock in every pass, and profiles the device (CUDA activity alone) over
``trace_passes`` passes from half the window on.  The host ranges' metrics
are read over the passes before those, which run as an untraced run's do:
the profiler's cost per launch stays after it stops.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import random
import sys
import time

import numpy as np

from . import check, scenes, traces
from .reference import rng

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list
    here: pathlib.Path = HERE  # the benchmark's folder, which holds the cell's files


def load_cell(name: str, here: pathlib.Path = HERE) -> Cell:
    """A cell and its files, by its name in the ``BENCHMARK.json`` beside
    the benchmark's folder ``here``."""
    bench = load_json(here.parent / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json (have {sorted(cells)})")
    c = cells[name]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(c["chips"]), config=load_json(here / "configs" / f"{c['config']}.json"),
                traffic=load_json(here / "traffic" / f"{c['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]), here=here)


def reader(metric: str, here: pathlib.Path = HERE):
    """The ``read`` of the metric's file ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", here / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(config: dict, here: pathlib.Path = HERE):
    """The plain reference module the configuration names: ``reference/<name>.py``
    under ``here``, ``render`` by default.  It runs inside the package
    ``benchmark.reference``, so its relative imports find the shared
    ``render``, ``shading``, ``traversal`` and ``rng``."""
    name = config.get("reference", "render")
    qualified = f"{__package__}.reference.{name}"
    if here == HERE:
        return importlib.import_module(qualified)
    spec = importlib.util.spec_from_file_location(qualified, here / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Readings:
    """What a metric's reader reads."""

    setup_s: float
    window_s: float
    pass_s: list  # host seconds of each pass, start to image on the host
    pass_rays: list  # live rays of each pass
    spans: dict  # host seconds of set-up steps, by name
    traffic: dict
    trace: traces.Trace | None = None  # the device-traced passes (--trace 1 on a card)
    work: dict | None = None  # the checked pass's work, from the reference (--trace 1)
    host: HostTimes | None = None  # the program's ranges on the host clock (--trace 1)


def cache_env():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = HERE / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))


class Program:
    """The system under test, set up for one cell: its scene, its
    accelerator, and the pass the traffic asks for."""

    def __init__(self, cell: Cell, scene_dir: pathlib.Path, seed: int, device, accel_kind: str | None = None):
        import torch

        from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
        from owl_path_tracer_tpu_torch.render import film, wavefront

        self.torch, self.film, self.wavefront = torch, film, wavefront
        self.cell, self.seed, self.device = cell, seed, device
        r, tr = cell.config["render"], cell.traffic
        self.spp = int(tr["spp_per_pass"])
        self.settings = RenderSettings(
            width=r["width"], height=r["height"], max_samples=self.spp, max_path_depth=r["max_path_depth"],
            environment_use=r["environment_use"], environment_auto=r["environment_auto"],
            environment_color=tuple(r["environment_color"]), environment_intensity=r["environment_intensity"],
            use_nee=r["use_nee"])
        self.spans = {}
        t = time.perf_counter()
        self.scene = compile_scene(scene_dir, cell.config["scene"]["name"], (r["width"], r["height"]),
                                   env_map_path=None, device=device)
        self.sync()
        self.spans["compile_scene"] = time.perf_counter() - t
        t = time.perf_counter()
        self.accel = film.make_accel(self.scene, accel_kind or tr["accel"], cluster_size=tr["cluster_size"])
        self.sync()
        self.spans["make_accel"] = time.perf_counter() - t
        self.rays_before = 0
        self.options = tr.get("options", {})
        if tr["renderer"] == "scan":
            self.film_state = film.new_film(self.settings, device=device)

    def sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    def sample_base(self, k: int) -> int:
        return self.seed + k * self.spp

    def warm_up(self):
        """One pass of the window's shapes on a sample stream no window pass
        draws, outside the film."""
        film_state = getattr(self, "film_state", None)
        self.run_pass(-1)
        self.rays_before = 0
        if film_state is not None:
            self.film_state = film_state
        self.sync()

    def run_pass(self, k: int):
        """Pass k -> (image float32 [H,W,3] on the host, live rays)."""
        tr = self.cell.traffic
        if tr["renderer"] == "wavefront":
            img, rays = self.wavefront.render_image_wavefront(
                self.scene, self.settings, self.accel, lanes=tr["lanes"], fused2_block=tr["block"],
                fused2_sort=tr["sort"], sample_base=self.sample_base(k), **self.options)
            img = img.cpu().numpy()
        else:
            w, h = self.settings.width, self.settings.height
            lin = self.torch.arange(w * h, device=self.device)
            base = self.torch.full_like(lin, self.sample_base(k) & rng.MASK32)
            state = dataclasses.replace(self.film_state, rng=rng.seed(lin, base))
            self.film_state = self.film.add_samples(self.scene, self.settings, state, self.spp,
                                                    pixel_chunk=tr["pixel_chunk"], accel=self.accel, **self.options)
            img = self.film.finalize(self.film_state).cpu().numpy()
            rays = self.film_state.rays_traced - self.rays_before
            self.rays_before = self.film_state.rays_traced
        return img, rays

    def pass_radiance(self, images: list, k: int) -> np.ndarray:
        """The radiance pass k alone added, summed over its samples: a
        progressive film's image holds the mean of every pass so far."""
        if self.cell.traffic["renderer"] != "scan":
            return images[k].astype(np.float64) * self.spp
        prev = images[k - 1].astype(np.float64) * (k * self.spp) if k else 0.0
        return images[k].astype(np.float64) * ((k + 1) * self.spp) - prev


@dataclasses.dataclass
class HostTimes:
    """The program's ranges on the host clock, and which passes they read."""

    spans: list  # (name, start_ns, end_ns), time.perf_counter_ns
    passes: list  # (start_ns, end_ns) of each pass
    read: tuple  # (first, end) indices of the passes that ran before any device profiler


@dataclasses.dataclass
class Window:
    images: list  # each pass's image on the host
    pass_s: list
    pass_rays: list
    window_s: float
    cpu_s: float  # the main thread's CPU seconds over the window
    trace: traces.Trace | None  # the device-profiled passes
    profiled: tuple | None  # (first, end) indices of the device-profiled passes
    host: HostTimes | None


def window(run_pass, seconds: float, trace_passes: int = 0, device_trace: bool = False) -> Window:
    """Passes back to back until ``seconds`` have passed, the pass in flight
    finished.  ``trace_passes`` > 0 times the program's host ranges in every
    pass and, with ``device_trace``, profiles the device over that many
    passes from the first that starts at half the window."""
    import torch

    spans = traces.HostSpans() if trace_passes else None
    profiler = first = None
    marks = []
    if trace_passes and device_trace:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CUDA])
    if spans is not None:
        spans.__enter__()
    images, pass_s, pass_rays, bounds = [], [], [], []
    t0, cpu0 = time.perf_counter(), time.thread_time()
    try:
        while True:
            k = len(images)
            if profiler is not None and first is None and time.perf_counter() - t0 >= seconds / 2:
                first = k
                profiler.__enter__()
            profiling = first is not None and k < first + trace_passes
            ts = time.perf_counter_ns()
            if profiling:
                marks.append(traces.mark())
            img, rays = run_pass(k)
            te = time.perf_counter_ns()
            bounds.append((ts, te))
            pass_s.append((te - ts) / 1e9)
            images.append(img)
            pass_rays.append(int(rays))
            if profiling and k + 1 == first + trace_passes:
                marks.append(traces.mark())
                torch.cuda.synchronize()
                profiler.__exit__(None, None, None)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s, cpu_s = time.perf_counter() - t0, time.thread_time() - cpu0
    finally:
        if spans is not None:
            spans.__exit__(None, None, None)
    traced = profiled = None
    if first is not None:
        end = min(len(images), first + trace_passes)
        if len(images) < first + trace_passes:
            marks.append(traces.mark())
            torch.cuda.synchronize()
            profiler.__exit__(None, None, None)
        traced = traces.from_profiler(profiler, marks, spans.spans)
        profiled = (first, end)
    host = None
    if spans is not None:
        host = HostTimes(spans=spans.spans, passes=bounds, read=(0, first if first is not None else len(images)))
    return Window(images=images, pass_s=pass_s, pass_rays=pass_rays, window_s=window_s, cpu_s=cpu_s, trace=traced,
                  profiled=profiled, host=host)


def host_speed(device: str, n: int = 20000) -> float:
    """The host's cost of one launch of a small operation, in microseconds
    (the best of three runs of ``n``): what the eager host loop pays per
    operation, read after the window to tell a slow host from slow work."""
    import torch

    a = torch.ones(4, device=device)
    out = torch.empty_like(a)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(n):
            torch.add(a, a, out=out)
        if out.is_cuda:
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best / n * 1e6


def host_record(device: str, win: Window) -> dict:
    """How the host ran the window: the main thread's share of it on a CPU
    and the launch probe; in a profiled run the mean seconds of the passes
    before, under and after the profiler."""
    out = {"main_thread_cpu_pct": 100.0 * win.cpu_s / win.window_s, "launch_us": host_speed(device)}
    if win.profiled is not None:
        first, end = win.profiled
        for key, part in (("before", win.pass_s[:first]), ("profiled", win.pass_s[first:end]),
                          ("after", win.pass_s[end:])):
            if part:
                out[f"pass_s_{key}"] = sum(part) / len(part)
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        accel_kind: str | None = None) -> dict:
    """One run -> the result line (a dict), ``checks`` last."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    on_card = torch.device(device).type == "cuda"
    ref = reference(cell.config, cell.here)
    scene_dir = scenes.materialize(cell.config)
    prog = Program(cell, scene_dir, seed, device, accel_kind)
    prog.warm_up()
    setup_s = time.perf_counter() - t_start

    win = window(prog.run_pass, seconds, tr["trace_passes"] if trace else 0, device_trace=on_card)
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # the check: one pass drawn from the seed (a device-profiled one in a traced run)
    rel = random.Random(seed).randrange(len(win.trace.passes) if win.trace is not None else len(win.images))
    k = rel + (win.profiled[0] if win.trace is not None else 0)
    got = prog.pass_radiance(win.images, k)
    base = prog.sample_base(k)
    failed = sum(int(not np.isfinite(im).all()) for im in win.images)
    spans = dict(prog.spans)
    del prog, win.images
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    host = host_record(device, win)
    t_ref = time.perf_counter()
    ref_scene = ref.load_scene(cell.config, scene_dir, tr["cluster_size"], device)
    ref_img, ref_rays, need, *more = ref.render_pass(ref_scene, base, *ref.MODES[tr["renderer"]])
    extra, = more or [{}]  # the reference's further work counts
    numbers = check.compare(got, ref_img.cpu().numpy(), win.pass_rays[k], ref_rays)
    correct, checks = check.judge(numbers, cell.limits)
    print(f"benchmark: pass {k} of {len(win.pass_s)} checked against the reference in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    traced = win.trace
    readings = Readings(setup_s=setup_s, window_s=win.window_s, pass_s=win.pass_s, pass_rays=win.pass_rays,
                        spans=spans, traffic=tr, trace=traced, host=win.host)
    if traced is not None:
        readings.work = dict(pass_index=rel, needed=need, rays=ref_rays, tris=int(ref_scene.tri_p.shape[0]),
                             clusters=int(ref_scene.clusters.cmin.shape[0]), cluster_size=tr["cluster_size"],
                             **extra)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"], cell.here)(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_record(device, memory_peak)
    result = {"correct": bool(correct), "attempted": len(win.pass_s), "failed": failed, "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_ns() / 1e9
        dev["window_s"] = traced.window_ns / 1e9
        result["breakdown"] = traces.breakdown(traced)
    result["host"] = host
    result["checks"] = checks
    return result


def device_record(device: str, memory_peak: int) -> dict:
    """The card's name, count, peak memory and power limit."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": memory_peak}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": memory_peak,
            "power_limit": limit}
