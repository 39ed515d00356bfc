"""The harness on the CPU: files found by name, the result line, the window
and tail arithmetic, the trace readings and the roofline count."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import bound, drive, traces
from benchmark.conftest import run_tiny, tiny_cell
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


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Adding files (and their entries) is enough: no file there is edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(drive.HERE, here, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
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
