"""The port's span registry (``render/metrics.py``): every ``owlpt.*`` range
the package opens is in ``SPANS`` and named in PERF.md's layer table; a
wavefront frame and a scan frame open their ranges per frame, per step, per
launch and per sweep as documented, and change no number; and the
benchmark's readers of those ranges (``benchmark/metrics/``) on synthetic
readings."""
from __future__ import annotations

import hashlib
import pathlib
import re

import pytest
import torch

from benchmark import drive, scenes, traces
from benchmark.conftest import tiny_cell
from owl_path_tracer_tpu_torch.render import film, metrics, wavefront

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "owl_path_tracer_tpu_torch"
NAMED = re.compile(r'"(owlpt\.[A-Za-z0-9_.]+)"')
# the frames below as the package rendered them before it had its spans:
# (sha256 of the image's float32 bytes, first 16 digits; live rays)
BEFORE = {"wavefront": ("1ab6597018c409c7", 1335), "scan": ("576a7b02b3a14f8a", 1338)}


def _sources():
    return {p: p.read_text() for p in sorted(PACKAGE.rglob("*.py"))}


def _opened() -> set:
    """Every range name the package's modules (the registry's aside) spell out."""
    return {name for path, text in _sources().items() if path.name != "metrics.py" for name in NAMED.findall(text)}


def test_every_opened_span_is_registered():
    """No range is opened but through ``metrics.span`` (or ``host_copy``,
    which opens one), and every name it is given is in the registry."""
    for path, text in _sources().items():
        if path.name != "metrics.py":
            assert "record_function" not in text, path
    assert _opened() <= set(metrics.SPANS), _opened() - set(metrics.SPANS)
    assert len(set(metrics.SPANS)) == len(metrics.SPANS)
    assert all(name.startswith(traces.RANGES) for name in metrics.SPANS)


@pytest.mark.parametrize("name", metrics.SPANS)
def test_each_registered_span_is_opened_and_documented(name):
    """A registered name is opened somewhere in the package and named in
    PERF.md section 3 (the layers and the metrics that read them)."""
    assert name in _opened()
    perf = (ROOT / "PERF.md").read_text()
    layers = perf[perf.index("## 3. Layers"):perf.index("## 4. Cells")]
    assert f"`{name}`" in layers


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The benchmark's two cells cut to a size the CPU renders in a second
    (the displaced icosphere at subdivision 2, 32x24, 256 lanes or pixels)."""
    cache = tmp_path_factory.mktemp("scenes")
    out = {}
    for kind in ("wavefront", "scan"):
        cell = tiny_cell(f"dragon7.{kind}")
        out[kind] = drive.Program(cell, scenes.materialize(cell.config, cache), 0, "cpu")
    return out


def _render(prog, kind, **kw):
    """One frame of the cell's path -> (image, live rays)."""
    tr = prog.cell.traffic
    if kind == "wavefront":
        return wavefront.render_image_wavefront(prog.scene, prog.settings, prog.accel, lanes=tr["lanes"],
                                                fused2_block=tr["block"], fused2_sort=tr["sort"], sample_base=7,
                                                **kw)
    f = film.add_samples(prog.scene, prog.settings, prog.film_state, 1, pixel_chunk=tr["pixel_chunk"],
                         accel=prog.accel)
    return film.finalize(f), f.rays_traced


def _spans(prog, kind, **kw):
    with traces.HostSpans() as spans:
        img, rays = _render(prog, kind, **kw)
    return spans.spans, img, rays


def _count(spans, name):
    return sum(n == name for n, _, _ in spans)


def _inside(spans, outer, name):
    """For each ``outer`` range, the ``name`` ranges within it."""
    return [sum(n == name and s0 <= s and e <= e0 for n, s, e in spans)
            for o, s0, e0 in spans if o == outer]


def test_wavefront_frame_opens_its_spans_per_frame_step_launch_and_sweep(programs):
    """fused2's plain path, sorted, in launches of 4 steps: the frame once, a
    step per step of every launch (every launch but the last runs its 4, the
    last no more), the status read between steps, after each from the first
    that could end the frame (its queue handed out, one step more run), the
    sort and the resolved column's read per sweep, and in each step one
    query, one shading, one banking and one regeneration."""
    prog = programs["wavefront"]
    wavefront.reset_counts()
    spans, _, _ = _spans(prog, "wavefront", iters_per_launch=4)
    launches = wavefront.STEPS["launches"]
    steps = _count(spans, "owlpt.step")
    assert _count(spans, "owlpt.frame") == 1 and launches >= 2
    assert (launches - 1) * 4 < steps <= launches * 4 and wavefront.STEPS["run"] == steps
    s = prog.settings
    first_read = -(-s.width * s.height * s.max_samples // prog.cell.traffic["lanes"]) + 1
    assert first_read <= 4 and _count(spans, "owlpt.sync.status") == steps - first_read + 1
    assert _inside(spans, "owlpt.step", "owlpt.sync.status") == [0] * steps
    for name in ("owlpt.intersect", "owlpt.sort", "owlpt.sync.resolved", "owlpt.shade", "owlpt.bank",
                 "owlpt.regen"):
        assert _count(spans, name) == steps, name
        assert _inside(spans, "owlpt.step", name) == [1] * steps, name
    assert _inside(spans, "owlpt.intersect", "owlpt.sort") == [1] * steps
    assert _count(spans, "owlpt.sync.rays") == 1 and _count(spans, "owlpt.unresolved") == 0
    assert _inside(spans, "owlpt.frame", "owlpt.sync.scene") == [3]  # the texture test, the sort mode's two reads
    assert _inside(spans, "owlpt.frame", "owlpt.sync.pool") == [4]
    for name in ("owlpt.sync.pad_rays", "owlpt.sync.hit_t_max"):
        assert _inside(spans, "owlpt.intersect", name) == [1] * steps, name
    for name in ("owlpt.sync.sky", "owlpt.sync.normal"):
        assert _inside(spans, "owlpt.shade", name) == [1] * steps, name
    assert _inside(spans, "owlpt.regen", "owlpt.sync.camera") == [1] * steps


def test_scan_frame_opens_a_step_per_chunk_and_bounce(programs):
    """``film.add_samples`` on the fused kernel's plain path: one step per
    depth of every chunk's wave, each with one query and one resolved-column
    read; the frame and the ray count once."""
    prog = programs["scan"]
    spans, _, _ = _spans(prog, "scan")
    s = prog.settings
    chunks = -(-s.width * s.height // prog.cell.traffic["pixel_chunk"])
    steps = chunks * s.max_path_depth
    assert chunks >= 2 and _count(spans, "owlpt.step") == steps
    for name in ("owlpt.intersect", "owlpt.sync.resolved", "owlpt.shade", "owlpt.sync.pack_rays",
                 "owlpt.sync.k5_t_max", "owlpt.sync.sky"):
        assert _inside(spans, "owlpt.step", name) == [1] * steps, name
    assert _count(spans, "owlpt.sync.camera") == chunks  # each chunk's primary rays
    assert _count(spans, "owlpt.frame") == 1 and _count(spans, "owlpt.sync.rays") == 1
    assert _count(spans, "owlpt.film") == 2 * chunks  # the sample sum, the chunk's write-back
    assert _count(spans, "owlpt.sort") == 0 and _count(spans, "owlpt.bank") == 0


@pytest.mark.parametrize("kind", ["wavefront", "scan"])
def test_spans_change_no_number(programs, kind):
    """The frame with its ranges recorded, with none recorded (then every
    span is a no-op), and as the package rendered it before it had spans:
    the same image bit for bit and the same ray count."""
    spans, img, rays = _spans(programs[kind], kind)
    bare, bare_rays = _render(programs[kind], kind)
    assert len(spans) > 10 and torch.equal(img, bare) and rays == bare_rays
    digest = hashlib.sha256(img.contiguous().numpy().tobytes()).hexdigest()[:16]
    assert (digest, rays) == BEFORE[kind]


def test_a_span_is_a_range_only_while_something_records_ranges(tmp_path):
    """With no profiler and no wrap of ``record_function`` a span is a
    no-op; under the benchmark's host clock (a wrap) or a profiler it is a
    ``record_function`` range of its name."""
    assert not isinstance(metrics.span("owlpt.step"), torch.profiler.record_function)
    with traces.HostSpans() as spans:
        with metrics.span("owlpt.step"):
            metrics.host_copy("owlpt.sync.sky", [1.0, 2.0])
    assert [n for n, _, _ in spans.spans] == ["owlpt.sync.sky", "owlpt.step"]
    with metrics.profile_trace(str(tmp_path)) as prof:
        with metrics.span("owlpt.frame"):
            pass
    assert "owlpt.frame" in {e.key for e in prof.key_averages()}


MS = 1_000_000


def _readings(spans, read=(0, 2), rays=(600, 400, 900), traffic=None):
    """Three passes of 10 ms, the last one device-profiled."""
    host = drive.HostTimes(spans=spans, passes=[(0, 10 * MS), (10 * MS, 20 * MS), (20 * MS, 30 * MS)], read=read)
    return drive.Readings(setup_s=1.0, window_s=0.03, pass_s=[0.01] * 3, pass_rays=list(rays), spans={},
                          traffic={"lanes": 250} if traffic is None else traffic, host=host)


# two read passes of two steps each (one step nested ranges); the third pass is profiled
SYNTHETIC = [
    ("owlpt.frame", 0, 1 * MS), ("owlpt.sync.scene", 0, MS // 2),
    ("owlpt.step", 1 * MS, 4 * MS), ("owlpt.intersect", 1 * MS, 2 * MS), ("owlpt.sync.resolved", MS + MS // 2, 2 * MS),
    ("owlpt.bank", 2 * MS, 3 * MS), ("owlpt.regen", 3 * MS, 4 * MS),
    ("owlpt.step", 4 * MS, 6 * MS), ("owlpt.intersect", 4 * MS, 5 * MS), ("owlpt.sync.status", 6 * MS, 7 * MS),
    ("owlpt.frame", 10 * MS, 11 * MS), ("owlpt.step", 11 * MS, 13 * MS), ("owlpt.intersect", 11 * MS, 12 * MS),
    ("owlpt.film", 12 * MS, 12 * MS + MS // 2), ("owlpt.step", 13 * MS, 15 * MS),
    ("owlpt.sync.rays", 15 * MS, 16 * MS),
    ("owlpt.frame", 20 * MS, 29 * MS), ("owlpt.step", 21 * MS, 22 * MS), ("owlpt.sync.status", 22 * MS, 23 * MS),
]


@pytest.mark.parametrize("metric, want", [
    # frame 1 + bank 1 + regen 1, then frame 1 + film 0.5, over two passes
    ("loop.host_ms_per_pass", 4.5 / 2),
    # 1000 live rays over 4 steps of 250 lanes
    ("loop.lane_occupancy_pct", 100.0),
    # scene, resolved, status, rays
    ("host.syncs_per_pass", 2.0),
    # 1 + 1, then 1 ms
    ("intersect.host_ms_per_pass", 3.0 / 2),
])
def test_span_readers(metric, want):
    r = _readings(SYNTHETIC)
    assert drive.reader(metric)(r) == pytest.approx(want)
    r.host.read = (0, 0)  # the profiler from the first pass: nothing to read
    assert drive.reader(metric)(r) is None
    r.host = None  # an untraced run
    assert drive.reader(metric)(r) is None


@pytest.mark.parametrize("metric", ["loop.host_ms_per_pass", "loop.lane_occupancy_pct", "host.syncs_per_pass"])
def test_span_readers_read_nothing_without_steps(metric):
    """A program that opens no ``owlpt.step`` range (one without the host
    loop's spans) gives no reading, though it has other ranges."""
    old = [s for s in SYNTHETIC if s[0] in ("owlpt.intersect", "owlpt.film", "owlpt.shade")]
    assert drive.reader(metric)(_readings(old)) is None
    assert drive.reader("intersect.host_ms_per_pass")(_readings(old)) == pytest.approx(1.5)


def test_occupancy_takes_the_scan_chunk_as_the_width():
    r = _readings(SYNTHETIC, traffic={"pixel_chunk": 500})
    assert drive.reader("loop.lane_occupancy_pct")(r) == pytest.approx(50.0)
    r.traffic = {}
    assert drive.reader("loop.lane_occupancy_pct")(r) is None
