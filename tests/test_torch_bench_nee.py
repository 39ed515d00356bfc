"""The benchmark's NEE cell (``cornell.nee-deferred``) on the CPU at a tiny
size (``benchmark/conftest.py``'s TINY: 32x24, 256 lanes, C=64): the
program against the plain NEE reference (``benchmark/reference/nee.py``) in
both NEE forms, planted faults of the NEE path that the comparison has to
catch, the reference's shadow-segment count against a brute count over
every cluster, the reference's imports, the NEE path's spans, and the
readers of the cell's new metrics."""
from __future__ import annotations

import dataclasses
import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import drive, scenes, traces
from benchmark.conftest import run_tiny, tiny_cell
from benchmark.reference import nee
from benchmark.reference.traversal import build_clusters
from owl_path_tracer_tpu_torch.models import lights as lights_mod
from owl_path_tracer_tpu_torch.render import integrator, wavefront

torch.set_num_threads(2)

CELL = "cornell.nee-deferred"


def _cell(fused_nee: bool = True) -> drive.Cell:
    cell = tiny_cell(CELL)
    cell.traffic = dict(cell.traffic, options={"fused_nee": fused_nee})
    return cell


@pytest.mark.parametrize("fused_nee", [True, False], ids=["deferred", "separate"])
def test_program_agrees_with_reference(fused_nee):
    res = run_tiny(_cell(fused_nee), seed=2**31 + 77)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0


def test_reference_counts_its_shadow_work():
    """A traced run hands the reference's work to the readers: the shadow
    segments and their clusters beside the path rays'."""
    cell = _cell()
    k1b = next(m for m in cell.per_layer if m["name"] == "k1b_mixed.roofline_pct")
    assert k1b["workloads"] == [CELL]
    cfg = cell.config
    ref = drive.reference(cfg)
    scene = ref.load_scene(cfg, scenes.materialize(cfg), cell.traffic["cluster_size"], "cpu")
    img, rays, need, work = ref.render_pass(scene, 9, *ref.MODES["wavefront"])
    assert set(work) == {"shadow_rays", "shadow_needed", "mixed_needed"}
    assert work["mixed_needed"] == need + work["shadow_needed"]
    assert 0 < work["shadow_rays"] <= work["shadow_needed"] and rays > 0
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    with pytest.raises(ValueError, match="wavefront"):
        ref.render_pass(scene, 9, "steps", "barycentric")


# ── planted faults: each must turn ``correct`` false ──────────────────────


def fault_shadow_unoccluded(monkeypatch):
    """The mixed sweep reports every 16th shadow lane unoccluded."""
    inner = integrator.make_mixed_sweep_fn

    def make(*a, **k):
        sweep = inner(*a, **k)

        def altered(ray_o, ray_d, t_max, shadow):
            rec, blob, occ = sweep(ray_o, ray_d, t_max, shadow)
            occ = occ.clone()
            occ[torch.nonzero(shadow).squeeze(1)[::16]] = False
            return rec, blob, occ

        return altered

    monkeypatch.setattr(integrator, "make_mixed_sweep_fn", make)


def fault_light_dropped(monkeypatch):
    """The light sample's contribution is dropped (its emission read as 0)."""
    inner = lights_mod.sample_lights

    def dropped(*a):
        ls = inner(*a)
        return dataclasses.replace(ls, emission=torch.zeros_like(ls.emission))

    monkeypatch.setattr(lights_mod, "sample_lights", dropped)


def fault_mis_one_on_emission(monkeypatch):
    """An emissive hit's MIS weight is 1: the light's pdf of the hit is 0."""
    monkeypatch.setattr(lights_mod, "pdf_hit_light", lambda lights, tri, *a: torch.zeros(tri.shape))


def fault_rr_uncompensated(monkeypatch):
    """The NEE path's Russian roulette without the 1/q of its survivors."""
    src = inspect.getsource(integrator._shade_bounce_nee)
    line = "throughput = torch.where((rr_active & survive)[..., None], throughput / q[..., None], throughput)"
    assert line in src
    scope = dict(vars(integrator))
    exec(compile(src.replace(line, "pass"), integrator.__file__, "exec"), scope)
    monkeypatch.setattr(integrator, "_shade_bounce_nee", scope["_shade_bounce_nee"])


@pytest.mark.parametrize("fault", [fault_shadow_unoccluded, fault_light_dropped, fault_mis_one_on_emission,
                                   fault_rr_uncompensated])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny(_cell(), seed=2**31 + 77)
    assert not res["correct"], res["checks"]


# ── shadow segments: the reference's count against a brute count ──────────


def _stack():
    """Right triangles in the planes x = 1..4, each covering the half of its
    square (y, z in [-1, 1]) with y + z <= 0, then a floor triangle in z = 0
    and a wall triangle in x = 9 that rises to z = 0.5 (their box is 0.5
    thick): in Morton order, clusters of two."""
    tris = [[[x, -1, -1], [x, 1, -1], [x, -1, 1]] for x in (1.0, 2.0, 3.0, 4.0)]
    tris += [[[5, -2, 0], [9, -2, 0], [5, 2, 0]], [[9, -2, 0], [9, 2, 0], [9, 0, 0.5]]]
    return np.asarray(tris, np.float32)


def _brute(tri_p, cl, o, d, t_max):
    """Per cluster in float64: the box's entry (slab test, from T_MIN), then
    the clusters entered before ``t_max`` nearest first, each counted until
    one holds a hit in (T_MIN, t_max) -> (occluded, needed)."""
    o, d = np.float64(o), np.float64(d)
    entries = []
    for k in range(cl.cmin.shape[0]):
        lo, hi = cl.cmin[k].double().numpy(), cl.cmax[k].double().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (lo - o) / d, (hi - o) / d
        inside = (o >= lo) & (o <= hi)  # a slab the segment runs along: always in it, or never
        t0 = np.where(d == 0, np.where(inside, -np.inf, np.inf), t0)
        t1 = np.where(d == 0, np.inf, t1)
        tn, tf = max(np.minimum(t0, t1).max(), 1e-3), np.maximum(t0, t1).min()
        if tn <= tf and tn < t_max:
            entries.append((tn, k))
    needed = 0
    for _, k in sorted(entries):
        needed += 1
        for j in cl.tri[k].tolist():
            if j < 0:
                continue
            p0, p1, p2 = np.float64(tri_p[j])
            e1, e2 = p1 - p0, p2 - p0
            h = np.cross(d, e2)
            det = e1 @ h
            if abs(det) < 1e-12:
                continue
            s = o - p0
            u = (s @ h) / det
            q = np.cross(s, e1)
            v = (d @ q) / det
            t = (e2 @ q) / det
            if u >= 0 and v >= 0 and u + v <= 1 and 1e-3 < t < t_max:
                return True, needed
    return False, needed


SEGMENTS = {
    # through the covered halves: the first plane's triangle stops it
    "occluded": ((0.0, -0.5, -0.5), (1.0, 0.0, 0.0), 3.5),
    # through the empty halves of every plane it reaches
    "unoccluded": ((0.0, 0.5, 0.5), (1.0, 0.0, 0.0), 4.5),
    # from the floor, leaving it at a shallow angle and ending short of the
    # wall: the floor's box is entered at T_MIN, but the floor's hit (t = 0)
    # lies before the segment
    "grazing": ((6.0, 0.0, 0.0), (0.9995, 0.0, 0.0316), 2.0),
    # ends short of the third plane
    "short": ((0.0, 0.5, 0.5), (1.0, 0.0, 0.0), 2.5),
}


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_segment_needed_matches_a_brute_count(name):
    tri_p = _stack()
    cl = build_clusters(tri_p, 2, "cpu")
    o, d, t_max = SEGMENTS[name]
    d = np.asarray(d, np.float32) / np.linalg.norm(np.asarray(d, np.float32))
    want_occ, want_need = _brute(tri_p, cl, o, d, t_max)
    occ, need = nee.segment_query(torch.tensor([o], dtype=torch.float32), torch.as_tensor(d[None]),
                                  torch.tensor([t_max], dtype=torch.float32), cl)
    assert (bool(occ[0]), int(need[0])) == (want_occ, want_need)
    assert want_occ == (name == "occluded") and want_need >= 1


def test_reference_imports_neither_jax_nor_either_package():
    code = ("import sys\nimport benchmark.reference.nee\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'owl_path_tracer_tpu', 'owl_path_tracer_tpu_torch'))\n"
            "assert not bad, bad\nprint('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=drive.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "clean", proc.stderr


# ── the NEE path's spans ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    cell = _cell()
    return drive.Program(cell, scenes.materialize(cell.config, tmp_path_factory.mktemp("scenes")), 0, "cpu")


def _frame(prog):
    tr = prog.cell.traffic
    return wavefront.render_image_wavefront(prog.scene, prog.settings, prog.accel, lanes=tr["lanes"],
                                            fused2_block=tr["block"], fused2_sort=tr["sort"], sample_base=11,
                                            fused_nee=True)


def _inside(spans, outer, name):
    return [sum(n == name and s0 <= s and e <= e0 for n, s, e in spans) for o, s0, e0 in spans if o == outer]


def test_deferred_step_opens_one_mixed_and_one_nee(cornell):
    """Each step of the deferred frame: one ``owlpt.mixed`` (the sort, the
    resolved column's read and the parked shadow direction inside it) and
    one ``owlpt.shade`` with one ``owlpt.nee`` inside; no closest-hit query
    of its own, no shadow test of its own; the light table once a frame."""
    with traces.HostSpans() as rec:
        _frame(cornell)
    spans = rec.spans
    steps = sum(n == "owlpt.step" for n, _, _ in spans)
    assert steps >= 2
    for name in ("owlpt.mixed", "owlpt.shade", "owlpt.bank", "owlpt.regen"):
        assert _inside(spans, "owlpt.step", name) == [1] * steps, name
    for name in ("owlpt.sort", "owlpt.sync.resolved", "owlpt.sync.shadow_dir"):
        assert _inside(spans, "owlpt.mixed", name) == [1] * steps, name
    for name in ("owlpt.nee", "owlpt.sync.env_color"):
        assert _inside(spans, "owlpt.shade", name) == [1] * steps, name
    assert not any(n in ("owlpt.intersect", "owlpt.occlude") for n, _, _ in spans)
    assert _inside(spans, "owlpt.frame", "owlpt.sync.lights") == [1]


def test_nee_spans_change_no_number(cornell):
    """The deferred frame with its ranges recorded and with none recorded:
    the same image bit for bit and the same ray count."""
    with traces.HostSpans() as rec:
        img, rays = _frame(cornell)
    bare, bare_rays = _frame(cornell)
    assert len(rec.spans) > 10 and rays == bare_rays > 0 and torch.equal(img, bare)


# ── the readers of the cell's new metrics ─────────────────────────────────

MS = 1_000_000


def _readings(spans, work=None, trace=None):
    host = drive.HostTimes(spans=spans, passes=[(0, 10 * MS), (10 * MS, 20 * MS), (20 * MS, 30 * MS)], read=(0, 2))
    return drive.Readings(setup_s=1.0, window_s=0.03, pass_s=[0.01] * 3, pass_rays=[5, 5, 5], spans={},
                          traffic={"lanes": 256}, host=host, work=work, trace=trace)


@pytest.mark.parametrize("metric, name", [("mixed.host_ms_per_pass", "owlpt.mixed"),
                                          ("nee.host_ms_per_pass", "owlpt.nee")])
def test_span_readers(metric, name):
    spans = [(name, 1 * MS, 3 * MS), (name, 11 * MS, 12 * MS), ("owlpt.shade", 4 * MS, 9 * MS),
             (name, 21 * MS, 29 * MS)]  # the last pass is profiled: not read
    assert drive.reader(metric)(_readings(spans)) == pytest.approx(1.5)
    assert drive.reader(metric)(_readings(spans[2:3])) is None
    r = _readings(spans)
    r.host = None
    assert drive.reader(metric)(r) is None


def test_mixed_roofline_counts_both_halves_of_the_wave():
    """``k1b_mixed.roofline_pct`` bounds the fused2 kernels of the checked
    pass by the path rays' and the segments' clusters, a wave of 2 x lanes
    rays per launch; without segment counts it reads nothing."""
    from benchmark import bound

    t = traces.Trace(device_ops=[("kernel", "void fused2_kernel<0,1>()", 1 * MS, 3 * MS)], ranges=[],
                     passes=[(0, 10 * MS)])
    work = dict(pass_index=0, needed=100, rays=50, tris=4096, clusters=8, cluster_size=512, mixed_needed=300)
    got = drive.reader("k1b_mixed.roofline_pct")(_readings([], work=work, trace=t))
    ops = (bound.SLAB_OPS + bound.CHAIN_OPS * 512) * 300
    nbytes = 4.0 * (512 * (7 + 20) + 8 * 6 + 4096 * 9)
    assert got == pytest.approx(100 * max(ops / bound.FP32_FLOPS, nbytes / bound.HBM_BYTES_S) / 0.002)
    del work["mixed_needed"]
    assert drive.reader("k1b_mixed.roofline_pct")(_readings([], work=work, trace=t)) is None
