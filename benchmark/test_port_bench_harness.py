"""The harness on the CPU: files found by name (a configuration's scene,
renderer options and reference among them), the result line, the window
and tail arithmetic, the trace readings and the roofline count."""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import bound, drive, traces
from benchmark.conftest import TINY, cornell_config, run_tiny, tiny_cell
from benchmark.reference.traversal import build_clusters, closest_hit

ROOT = drive.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    c = drive.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert set(c.limits) == set(drive.check.NUMBERS)
    for m in c.end_to_end + c.per_layer:
        assert callable(drive.reader(m["name"]))


def _bench_copy(tmp_path):
    """A copy of the benchmark's folder under ``tmp_path`` -> (the folder,
    ``BENCHMARK.json`` parsed, to be written beside it)."""
    here = tmp_path / "benchmark"
    shutil.copytree(drive.HERE, here, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return here, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Adding files (and their entries) is enough: no file there is edited."""
    here, bench = _bench_copy(tmp_path)
    (here / "configs" / "dragon5.json").write_text(
        json.dumps(dict(json.loads((here / "configs" / "dragon7.json").read_text()), name="dragon5")))
    (here / "traffic" / "preview.json").write_text(json.dumps(dict(drive.load_cell("dragon7.wavefront").traffic)))
    (here / "limits" / "dragon5.preview.json").write_text(json.dumps({n: 1.0 for n in drive.check.NUMBERS}))
    (here / "metrics" / "passes.count.py").write_text("def read(r):\n    return len(r.pass_s)\n")
    bench["workloads"].append({"name": "dragon5.preview", "config": "dragon5", "traffic": "preview", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "passes.count", "unit": "passes", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["dragon5.preview"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = drive.load_cell("dragon5.preview", here)
    assert cell.config["name"] == "dragon5" and cell.traffic["renderer"] == "wavefront"
    assert [m["name"] for m in cell.end_to_end] == ["mrays_per_s", "setup_s", "passes.count"]
    readings = drive.Readings(setup_s=1.0, window_s=2.0, pass_s=[0.5] * 4, pass_rays=[10] * 4, spans={},
                              traffic=cell.traffic)
    assert drive.reader("passes.count", here)(readings) == 4
    assert drive.load_cell("dragon7.scan", here).per_layer == drive.load_cell("dragon7.scan").per_layer


def test_a_configuration_brings_its_scene_options_and_reference_as_new_files(tmp_path, monkeypatch):
    """A cell whose scene is a file pinned by its hash, whose traffic passes
    the renderer an option and whose configuration names a reference module
    of its own: new files alone, run by the harness as it is, and correct."""
    from owl_path_tracer_tpu_torch.render import wavefront

    here, bench = _bench_copy(tmp_path)
    (here / "configs" / "cornell.json").write_text(json.dumps(dict(cornell_config(), reference="cornell_ref")))
    (here / "traffic" / "nee-deferred.json").write_text(json.dumps(dict(
        renderer="wavefront", accel="fused2", cluster_size=TINY["cluster_size"], lanes=TINY["lanes"], block=256,
        sort=True, spp_per_pass=1, trace_passes=3, options={"fused_nee": True})))
    (here / "limits" / "cornell.nee-deferred.json").write_text(json.dumps(drive.load_cell("dragon7.wavefront").limits))
    (here / "reference" / "cornell_ref.py").write_text("from .render import MODES, load_scene, render_pass\n")
    bench["workloads"].append({"name": "cornell.nee-deferred", "config": "cornell", "traffic": "nee-deferred",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded, calls = [], []
    monkeypatch.setattr(drive, "reference", lambda config, where, inner=drive.reference: loaded.append(
        inner(config, where)) or loaded[-1])
    inner_render = wavefront.render_image_wavefront
    monkeypatch.setattr(wavefront, "render_image_wavefront", lambda *a, **k: calls.append(k) or inner_render(*a, **k))

    cell = drive.load_cell("cornell.nee-deferred", here)
    res = drive.run(cell, 5, 0.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert {"mrays_per_s", "setup_s"} <= set(res["metrics"]) and res["metrics"]["mrays_per_s"]["value"] > 0
    assert [pathlib.Path(m.__file__) for m in loaded] == [here / "reference" / "cornell_ref.py"]
    assert len(calls) == 2 and all(k["fused_nee"] is True for k in calls)  # the warm-up and the window's pass


# each entry point's keyword arguments as the harness passed them before traffic options
TODAYS_CALL = {"dragon7.wavefront": {"lanes", "fused2_block", "fused2_sort", "sample_base"},
               "dragon7.scan": {"pixel_chunk", "accel"}}


@pytest.mark.parametrize("name, options", [("dragon7.wavefront", None), ("dragon7.wavefront", {"fused_nee": True}),
                                           ("dragon7.scan", None), ("dragon7.scan", {"fused2_block": 128})])
def test_traffic_options_reach_the_entry_point(monkeypatch, name, options):
    from owl_path_tracer_tpu_torch.render import film, wavefront

    calls = []

    def record(f):
        return lambda *a, **k: calls.append((len(a), k)) or f(*a, **k)

    monkeypatch.setattr(wavefront, "render_image_wavefront", record(wavefront.render_image_wavefront))
    monkeypatch.setattr(film, "add_samples", record(film.add_samples))
    cell = tiny_cell(name)
    if options is not None:
        cell.traffic = dict(cell.traffic, options=options)
    assert run_tiny(cell)["correct"]
    positional = 3 if name == "dragon7.wavefront" else 4
    assert len(calls) == 2
    for n, k in calls:
        assert n == positional and set(k) == TODAYS_CALL[name] | set(options or {})
        assert all(k[key] == v for key, v in (options or {}).items())


@pytest.mark.parametrize("name", ["dragon7.wavefront", "dragon7.scan"])
def test_an_unknown_option_fails_the_run(name):
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, options={"no_such_option": 1})
    with pytest.raises(TypeError, match="no_such_option"):
        run_tiny(cell)


FURTHER_WORK = """from . import render
from .render import MODES, load_scene  # noqa: F401


def render_pass(*args):
    img, rays, need = render.render_pass(*args)
    return img, rays, need, {KEY: 3 * need + 1}
"""

SHADOW_METRIC = """import re

from benchmark.bound import share

KERNELS = re.compile(r"slot_kernel|fused_kernel")


def read(r):
    return share(r, KERNELS, KERNELS, 4, r.traffic.get("pixel_chunk"), needed="shadow_needed")
"""


@pytest.mark.parametrize("key", ["shadow_needed", "needed"])
def test_a_references_further_work_reaches_the_readings_and_the_roofline(tmp_path, monkeypatch, key):
    """A fourth element of ``render_pass`` joins ``Readings.work`` beside
    today's keys, which it may not replace, and ``bound.share`` counts the
    key it is given (a traced run, its device trace made up here)."""
    here, _ = _bench_copy(tmp_path)
    (here / "reference" / "shadowed.py").write_text(FURTHER_WORK.replace("KEY", repr(key)))
    (here / "metrics" / "shadow.roofline_pct.py").write_text(SHADOW_METRIC)
    cell = tiny_cell("dragon7.scan")
    cell.here, cell.config = here, dict(cell.config, reference="shadowed")
    k5 = next(m for m in BENCH["per_layer"] if m["name"] == "k5.roofline_pct")
    cell.per_layer = [k5, dict(k5, name="shadow.roofline_pct")]
    ms = 1_000_000
    fake = traces.Trace(device_ops=[("kernel", "slot_kernel(float const*)", 1 * ms, 3 * ms)], ranges=[],
                        passes=[(0, 10 * ms)])

    def traced_window(*a, inner=drive.window, **k):
        win = inner(*a, **k)
        win.trace, win.profiled = fake, (0, 1)
        return win

    seen = []
    monkeypatch.setattr(drive, "window", traced_window)
    monkeypatch.setattr(drive, "reader", lambda name, where, inner=drive.reader: (
        lambda r: seen.append(r) or inner(name, where)(r)))
    if key == "needed":
        with pytest.raises(TypeError, match="needed"):
            run_tiny(cell, trace=True)
        return
    res = run_tiny(cell, trace=True)
    work = seen[0].work
    assert set(work) == {"pass_index", "needed", "rays", "tris", "clusters", "cluster_size", "shadow_needed"}
    assert work["shadow_needed"] == 3 * work["needed"] + 1 and work["needed"] > 0
    got, base = (res["metrics"][m]["value"] for m in ("shadow.roofline_pct", "k5.roofline_pct"))
    kernels = re.compile("slot_kernel|fused_kernel")
    assert got == bound.share(seen[0], kernels, kernels, 4, TINY["pixel_chunk"], needed="shadow_needed")
    # bound by operations at this size, so the share follows the count
    assert got / base == pytest.approx(work["shadow_needed"] / work["needed"])
    assert bound.share(seen[0], kernels, kernels, 4, TINY["pixel_chunk"], needed="no_such_work") is None


# the checked pass's reference image (sha256 of its float32 bytes), its live
# rays and the checks of ``run_tiny(tiny_cell(name))``, as the harness
# judged them before the configuration's reference and options were files
JUDGED_BEFORE = {
    name: {"ref": "d8105a50f3c269091bce2341bd3d536ff24f93ce084c6b250a76c8276b84f415", "ref_rays": 1331,
           "checks": {"mean_gap_pct": {"value": 0.0, "limit": 0.5}, "mismatch_pct": {"value": 0.0, "limit": 0.25},
                      "rays_gap_pct": {"value": 0.0, "limit": 0.05}}}
    for name in ("dragon7.wavefront", "dragon7.scan")}


@pytest.mark.parametrize("name", sorted(JUDGED_BEFORE))
def test_dragon7_cells_are_judged_as_before(monkeypatch, name):
    seen = {}

    def compare(img, ref, rays, ref_rays, inner=drive.check.compare):
        seen.update(ref=hashlib.sha256(np.ascontiguousarray(ref, np.float32).tobytes()).hexdigest(),
                    ref_rays=ref_rays)
        return inner(img, ref, rays, ref_rays)

    monkeypatch.setattr(drive.check, "compare", compare)
    res = run_tiny(tiny_cell(name))
    assert dict(seen, checks=res["checks"]) == JUDGED_BEFORE[name]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(trace):
    res = run_tiny(tiny_cell("dragon7.wavefront"), trace=trace)
    # no card here: nothing traces a device, so no breakdown
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "host", "checks"]
    assert set(res["checks"]) == set(drive.check.NUMBERS)
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    names = {m["name"] for m in BENCH["end_to_end"]} if not trace else {m["name"] for m in BENCH["per_layer"]}
    assert set(res["metrics"]) <= names
    if trace:
        # the device's metrics say nothing, the host's do
        assert "device.idle_pct" not in res["metrics"] and "shade.host_ms_per_pass" in res["metrics"]
        assert res["metrics"]["shade.host_ms_per_pass"]["value"] > 0
    else:
        assert {"mrays_per_s", "setup_s"} <= set(res["metrics"])
    assert res["host"]["launch_us"] > 0 and res["host"]["main_thread_cpu_pct"] > 0
    json.dumps(res)


def test_no_card_no_result():
    """Without a CUDA device the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "dragon7.scan", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


@pytest.mark.parametrize("seconds", [0.0, 0.05, 0.12])
def test_window_runs_until_the_time_and_finishes_the_pass_in_flight(seconds):
    durations = [0.02, 0.03, 0.01, 0.04] * 10

    def stub(k):
        time.sleep(durations[k])
        return np.zeros((2, 2, 3), np.float32), 100 + k

    win = drive.window(stub, seconds)
    n = len(win.pass_s)
    assert n >= 1 and sum(durations[: n - 1]) < seconds + 0.02
    assert win.window_s >= seconds and win.window_s >= sum(win.pass_s) * 0.999
    assert win.pass_rays == [100 + k for k in range(n)]
    for got, want in zip(win.pass_s, durations):
        assert want <= got < want + 0.02
    r = drive.Readings(setup_s=3.0, window_s=win.window_s, pass_s=win.pass_s, pass_rays=win.pass_rays, spans={},
                       traffic={})
    assert drive.reader("mrays_per_s")(r) == pytest.approx(sum(win.pass_rays) / win.window_s / 1e6)


def test_window_profiles_from_half_the_window(monkeypatch):
    """The device profiler runs over ``trace_passes`` passes from the first
    that starts at half the window; the host ranges are read before it."""
    import torch.profiler

    calls, events = [], []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            events.append(("enter", len(calls)))

        def __exit__(self, *exc):
            events.append(("exit", len(calls)))

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(traces, "mark", time.perf_counter_ns)
    monkeypatch.setattr(traces, "from_profiler", lambda prof, marks, spans: ("trace", len(marks)))

    def stub(k):
        calls.append(k)
        time.sleep(0.01)
        return np.zeros((2, 2, 3), np.float32), 1

    win = drive.window(stub, 0.1, trace_passes=2, device_trace=True)
    first, end = win.profiled
    assert end == first + 2 < len(win.pass_s) and sum(win.pass_s[:first]) >= 0.045
    assert events == [("enter", first), ("exit", end)] and win.trace == ("trace", 3)
    assert win.host.read == (0, first)


def _trace():
    ms = 1_000_000
    ops = [("kernel", "void fused_kernel<1>(float*)", 1 * ms, 3 * ms),
           ("kernel", "void at::native::elementwise_kernel<128>()", 4 * ms, 5 * ms),
           ("gpu_memcpy", "Memcpy DtoH", 5 * ms, 6 * ms),
           ("kernel", "slot_kernel(float const*)", 12 * ms, 14 * ms),
           ("kernel", "weight_kernel(float const*)", 11 * ms, 12 * ms)]
    ranges = [("owlpt.shade", 0, 4 * ms), ("owlpt.intersect", 6 * ms, 11 * ms), ("owlpt.shade", 14 * ms, 19 * ms)]
    return traces.Trace(device_ops=sorted(ops, key=lambda o: o[2]), ranges=ranges,
                        passes=[(0, 10 * ms), (10 * ms, 20 * ms)])


def test_trace_readings():
    t = _trace()
    assert t.busy_ns() == 7_000_000 and t.window_ns == 20_000_000
    ms = 1_000_000
    # three passes, the last profiled; shade ranges (one nested in another) in the first two
    host = drive.HostTimes(spans=[("owlpt.shade", 1 * ms, 4 * ms), ("owlpt.shade", 11 * ms, 14 * ms),
                                  ("owlpt.shade", 12 * ms, 13 * ms), ("owlpt.intersect", 14 * ms, 15 * ms),
                                  ("owlpt.shade", 21 * ms, 26 * ms)],
                           passes=[(0, 10 * ms), (10 * ms, 20 * ms), (20 * ms, 30 * ms)], read=(0, 2))
    r = drive.Readings(setup_s=1.0, window_s=1.0, pass_s=[0.01, 0.01, 0.02], pass_rays=[1, 1, 1], spans={},
                       traffic={}, trace=t, host=host)
    # 7 ms busy over the 2 profiled passes, against the 10 ms of a pass before the profiler
    assert drive.reader("device.idle_pct")(r) == pytest.approx(65.0)
    assert drive.reader("host.launches_per_pass")(r) == pytest.approx(2.0)
    assert drive.reader("shade.host_ms_per_pass")(r) == pytest.approx(3.0)
    host.read = (0, 0)  # the profiler from the first pass: nothing to read
    assert drive.reader("shade.host_ms_per_pass")(r) is None and drive.reader("device.idle_pct")(r) is None
    b = traces.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(0.002)
    gaps = dict(b["idle_gaps"])
    # gaps 0-1 and 3-4 ms (shade), 6-11 ms (intersect), 14-20 ms (shade open at 14)
    assert gaps == pytest.approx({"owlpt.shade": 0.001 + 0.001 + 0.006, "owlpt.intersect": 0.005})


def test_roofline_share_of_the_checked_pass():
    t = _trace()
    work = dict(pass_index=1, needed=1000, rays=500, tris=4096, clusters=32, cluster_size=128)
    r = drive.Readings(setup_s=1.0, window_s=1.0, pass_s=[0.01, 0.01], pass_rays=[1, 1], spans={},
                       traffic={"pixel_chunk": 256}, trace=t, work=work)
    got = drive.reader("k5.roofline_pct")(r)
    ops = (bound.SLAB_OPS + bound.CHAIN_OPS * 128) * 1000
    nbytes = 4.0 * 1 * (256 * (7 + 4) + 32 * 6 + 4096 * 9)
    want = 100 * max(ops / bound.FP32_FLOPS, nbytes / bound.HBM_BYTES_S) / 0.003
    assert got == pytest.approx(want)
    assert drive.reader("k1b_f32.roofline_pct")(r) is None  # no fused2 kernel in that pass


def test_needed_clusters_on_a_small_soup():
    """The traversal's hits are the brute sweep's, and a ray needs exactly
    the clusters whose box it enters before its closest hit."""
    rng = np.random.default_rng(1)
    centers = rng.uniform(-1, 1, (300, 1, 3))
    tri_p = (centers + rng.normal(0, 0.08, (300, 3, 3))).astype(np.float32)
    cl = build_clusters(tri_p, 16, "cpu")
    o = torch.as_tensor(rng.uniform(-3, 3, (400, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32)) - o * 0.3, dim=1)
    t, tri, u, v, need = closest_hit(o, d, cl)
    # brute force, float64
    p = torch.as_tensor(tri_p, dtype=torch.float64)
    o64, d64 = o.double(), d.double()
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    h = torch.linalg.cross(d64[:, None], e2[None].expand(400, -1, -1), dim=-1)
    det = (e1[None] * h).sum(-1)
    s = o64[:, None] - p[None, :, 0]
    uu = (s * h).sum(-1) / det
    q = torch.linalg.cross(s, e1[None].expand(400, -1, -1), dim=-1)
    vv = (d64[:, None] * q).sum(-1) / det
    tt = (e2[None] * q).sum(-1) / det
    ok = (det.abs() > 1e-12) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-3)
    best = torch.where(ok, tt, torch.inf).min(1).values
    hit = torch.isfinite(best)
    assert torch.equal(hit, tri >= 0)
    assert torch.allclose(t[hit].double(), best[hit], rtol=1e-4)
    # boxes entered before the hit, in float64
    lo, hi = cl.cmin.double(), cl.cmax.double()
    inv = 1.0 / d64
    t0 = (lo[None] - o64[:, None]) * inv[:, None]
    t1 = (hi[None] - o64[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1).clamp(min=1e-3)
    tf = torch.maximum(t0, t1).amin(-1)
    enter = (tn <= tf) & (tn < torch.where(hit, best, torch.full_like(best, 1e10))[:, None])
    assert (need - enter.sum(1)).abs().max() <= 1
    assert int(need.sum()) > 400


class _Event:
    """A kineto event of a torch without ``activity_type``."""

    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def _prof(events):
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    return Prof()


def test_trace_passes_from_markers():
    """Passes run from one marker kernel to the next; the host ranges move
    onto the trace's clock by the markers' shift; CPU events are not read."""
    mk = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    us = 1000
    base = 7_000_000_000
    prof = _prof([_Event(mk, "DeviceType.CUDA", base + 5 * us, 2), _Event("void k<1>()", "DeviceType.CUDA", base + 20 * us, 3),
                  _Event("Memcpy DtoH", "DeviceType.CUDA", base + 40 * us, 5),
                  _Event("cudaLaunchKernel", "DeviceType.CPU", 11, 1),
                  _Event(mk, "DeviceType.CUDA", base + 900_006 * us, 2),
                  _Event(mk, "DeviceType.CUDA", base + 1_800_004 * us, 2)])
    host_marks = [0, 900_000 * us, 1_800_000 * us]
    t = traces.from_profiler(prof, host_marks, [("owlpt.shade", 10 * us, 30 * us)])
    assert t.passes == [(base + 5 * us, base + 900_006 * us), (base + 900_006 * us, base + 1_800_004 * us)]
    [(name, s, e)] = t.ranges
    assert name == "owlpt.shade" and abs(s - base - 15 * us) <= 5 * us and abs(e - base - 35 * us) <= 5 * us
    assert t.device_ops == [("kernel", "void k<1>()", base + 20 * us, base + 20 * us + 3),
                            ("gpu_memcpy", "Memcpy DtoH", base + 40 * us, base + 40 * us + 5)]


def _markers(lost=None):
    """Host launch times and device starts of 4 markers 1.9-2.1 s apart, the
    trace's clock 1.25% slow against the host's and the first marker 3 ms
    late (as on the card's machines), one of them lost where asked."""
    us = 1000
    host = [0, 2_000_000 * us, 4_100_000 * us, 6_000_000 * us]
    device = [50_000 * us + round(h * 0.9875) + d for h, d in zip(host, [3005 * us, 6 * us, 4 * us, 5 * us])]
    kept = device if lost is None else device[:lost] + device[lost + 1:]
    # the first pass's first kernel, 1 ms after its marker, is the earliest event where that marker is lost
    return host, device, kept, device[0] + (1000 * us if lost == 0 else 0)


@pytest.mark.parametrize("lost", [None, 0, 1, 2])
def test_passes_run_from_marker_to_marker_and_a_lost_one_starts_on_the_clock_line(lost):
    us = 1000
    host, device, kept, earliest = _markers(lost)
    mk = "spin_kernel(long)"
    events = [_Event(mk, "DeviceType.CUDA", d, 2) for d in kept] + [_Event("k()", "DeviceType.CUDA", earliest, 3)]
    t = traces.from_profiler(_prof(events), host, [("owlpt.shade", 1_000_000 * us, 1_500_000 * us)])
    starts = [a for a, _ in t.passes] + [t.passes[-1][1]]
    for i, (got, want) in enumerate(zip(starts, device)):
        assert got == want if i != lost else abs(got - (want - (3000 * us if i == 0 else 0))) <= 20 * us
    [(_, s, e)] = t.ranges
    line = lambda h: 50_000 * us + round(h * 0.9875) + 5 * us  # noqa: E731
    assert abs(s - line(1_000_000 * us)) <= 20 * us and abs(e - line(1_500_000 * us)) <= 20 * us


def test_no_trace_without_two_markers():
    host, _, kept, earliest = _markers()
    assert traces.match(kept[:1], host, earliest) is None
    assert traces.from_profiler(_prof([_Event("spin_kernel(long)", "DeviceType.CUDA", kept[0], 2)]), host, []) is None


def test_host_spans_time_the_programs_ranges():
    from torch.autograd import profiler

    enter, exit_ = profiler.record_function.__enter__, profiler.record_function.__exit__
    with traces.HostSpans() as spans:
        with torch.profiler.record_function("owlpt.shade"):
            with torch.profiler.record_function("owlpt.occlude"):
                time.sleep(0.002)
        with torch.profiler.record_function("other"):
            pass
    with torch.profiler.record_function("owlpt.shade"):
        pass
    assert (profiler.record_function.__enter__, profiler.record_function.__exit__) == (enter, exit_)
    assert [n for n, _, _ in spans.spans] == ["owlpt.occlude", "owlpt.shade"]
    (_, s1, e1), (_, s0, e0) = spans.spans
    assert s0 <= s1 and e1 <= e0 and e1 - s1 >= 2_000_000
    assert traces.union_ns([(s0, e0), (s1, e1)]) == e0 - s0


def test_window_times_host_ranges_in_every_pass():
    def stub(k):
        with torch.profiler.record_function("owlpt.shade"):
            time.sleep(0.01)
        return np.zeros((2, 2, 3), np.float32), 1

    win = drive.window(stub, 0.05, trace_passes=2)
    assert win.trace is None and win.profiled is None  # no device profiled here
    assert win.host.read == (0, len(win.pass_s))
    assert len(win.host.spans) == len(win.pass_s) == len(win.host.passes)
    for (_, s, e), (ps, pe) in zip(win.host.spans, win.host.passes):
        assert ps <= s < e <= pe
