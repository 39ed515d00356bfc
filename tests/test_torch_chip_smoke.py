"""The near-tie rule of chip_smoke.py (``compare_near_tie``), which holds the
MXU-layout kernel (K1b, K4) against its plain version on the card, fails a
wrong winner.  Here the plain version with a planted fault stands in for a
faulty kernel, on the CPU at the soup's size (3000 triangles, C=64, 300 rays
padded to 384): a plain version that drops the t_min test (hits behind the
origin and self-hits), one that skips the nearest hits (a farther valid hit
wins), and winners copied from other rays (slots outside this ray's window).  The
rule's kind for the tensor cores' sums (``tensor=True``) fails the same
faults, excuses a planted flip whose deciding margin lies within the sums'
rounding bound, and fails one beyond it or onto a slot whose window fails by
more.
"""
import dataclasses
import json

import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu_torch.ops import fused2
from owl_path_tracer_tpu_torch.ops import latency_probe as lp
from owl_path_tracer_tpu_torch.ops import math as m

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module", params=list(DTYPES))
def soup(request):
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=DTYPES[request.param])
    rays = fused2.pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3])
    return fb, rays, fused2.fused2_traverse_packed_plain(rays, fb)


def test_equal_outputs_pass(soup):
    fb, rays, want = soup
    err, differ = chip_smoke.compare_near_tie(want.clone(), want, rays, fb, "same")
    assert err == 0.0 and differ == 0


@pytest.mark.parametrize("t_min", [-1e30, 2.0], ids=["t_min_dropped", "nearest_skipped"])
def test_planted_t_min_fault_fails(soup, monkeypatch, t_min):
    fb, rays, want = soup
    with monkeypatch.context() as mp:
        mp.setattr(m, "T_MIN", t_min)
        got = fused2.fused2_traverse_packed_plain(rays, fb)
    assert (got[:, 3] != want[:, 3]).sum() > 10
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted fault")


def test_winners_of_other_rays_fail(soup):
    fb, rays, want = soup
    got = want.clone()
    hits = torch.nonzero(want[:300, 4] > 0).squeeze(1)
    got[hits, 3:9] = want[hits.roll(1), 3:9]
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted fault")


# ── the sums' rounding kind (tensor=True: K1b on bf16 planes, tensor cores) ──


def test_tensor_rule_equal_outputs_pass(soup):
    fb, rays, want = soup
    err, differ = chip_smoke.compare_near_tie(want.clone(), want, rays, fb, "same", tensor=True)
    assert err == 0.0 and differ == 0


@pytest.mark.parametrize("t_min", [-1e30, 2.0], ids=["t_min_dropped", "nearest_skipped"])
def test_tensor_rule_planted_t_min_fault_fails(soup, monkeypatch, t_min):
    fb, rays, want = soup
    with monkeypatch.context() as mp:
        mp.setattr(m, "T_MIN", t_min)
        got = fused2.fused2_traverse_packed_plain(rays, fb)
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted fault", tensor=True)


def test_tensor_rule_winners_of_other_rays_fail(soup):
    fb, rays, want = soup
    got = want.clone()
    hits = torch.nonzero(want[:300, 4] > 0).squeeze(1)
    got[hits, 3:9] = want[hits.roll(1), 3:9]
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted fault", tensor=True)


def _planted_u_margin(fb, rays, want, extra: bool):
    """A hit ray i and a copy of ``fb`` whose planes at i's winning slot make
    its u*det sum cancel exactly (two terms f0 f1 - f1 f0, exact in either
    arithmetic, the other rows zero): u's margin 0 lies within any positive
    rounding bound.  ``extra`` adds a third term of 2^-6 |f0 f1| on the side
    that passes, far beyond the bound -> (i, fb copy, its plain output)."""
    c = fb.cluster_size
    for i in torch.nonzero(want[:300, 4] > 0).squeeze(1).tolist():
        feat = fused2._ray_features(rays[i : i + 1, 0:3], rays[i : i + 1, 3:6], fb.planes.dtype == torch.bfloat16)[0]
        f0, f1, f2 = (float(x) for x in feat[:3])
        if min(abs(f0), abs(f1), abs(f2)) < 1e-2:
            continue
        cid, slot = int(want[i, 7]), int(want[i, 8])
        (det, *_), _ = fused2.mxu_slot_sums(rays[i : i + 1, 0:3], rays[i : i + 1, 3:6], fb,
                                            want[i : i + 1, 7], want[i : i + 1, 8])
        sgn = -1.0 if float(det[0]) < 0 else 1.0
        planes = fb.planes.clone()
        col = torch.zeros(6, dtype=torch.float32)
        col[0], col[1] = f1, -f0
        if extra:
            col[2] = sgn * 2.0**-6 * abs(f0 * f1) / f2
        planes[cid, 0:6, c + slot] = col.to(planes.dtype)
        planted = dataclasses.replace(fb, planes=planes)
        out = fused2.fused2_traverse_packed_plain(rays, planted)
        if int(out[i, 7]) == cid and int(out[i, 8]) == slot:  # still the plain version's winner
            return i, planted, out
    raise AssertionError("no ray to plant a flip on")


def _kernel_missed(want, rays, i):
    """``want`` with ray i's winner dropped, as a kernel that rejected it would report."""
    got = want.clone()
    got[i, 0], got[i, 1:5], got[i, 7:9], got[i, 16:32] = rays[i, 6], 0.0, -1.0, 0.0
    got[i, 3] = -1.0
    return got


def test_flip_within_rounding_bound_passes(soup):
    fb, rays, want = soup
    i, planted, out = _planted_u_margin(fb, rays, want, extra=False)
    within, close, _, _ = chip_smoke.sums_decisions(rays[i : i + 1], planted, out[i : i + 1, 7].long(),
                                                    out[i : i + 1, 8].long())
    assert bool(within[0]) and bool(close[0])
    err, differ = chip_smoke.compare_near_tie(_kernel_missed(out, rays, i), out, rays, planted, "planted flip",
                                              tensor=True)
    assert differ == 1 and err == 0.0
    # the rule without the rounding kind does not excuse it
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(_kernel_missed(out, rays, i), out, rays, planted, "planted flip")


def test_flip_beyond_rounding_bound_fails(soup):
    fb, rays, want = soup
    i, planted, out = _planted_u_margin(fb, rays, want, extra=True)
    within, close, _, _ = chip_smoke.sums_decisions(rays[i : i + 1], planted, out[i : i + 1, 7].long(),
                                                    out[i : i + 1, 8].long())
    assert bool(within[0]) and not bool(close[0])
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(_kernel_missed(out, rays, i), out, rays, planted, "planted flip", tensor=True)


def test_flip_onto_a_failing_window_fails(soup):
    """The plain winner's u margin lies within the bound, but the kernel's
    winner is a slot whose window fails for this ray by far more."""
    fb, rays, want = soup
    i, planted, out = _planted_u_margin(fb, rays, want, extra=False)
    for j in torch.nonzero(out[:300, 4] > 0).squeeze(1).tolist():
        within, *_ = chip_smoke.sums_decisions(rays[i : i + 1], planted, out[j : j + 1, 7].long(),
                                               out[j : j + 1, 8].long())
        if j != i and not bool(within[0]):
            break
    got = out.clone()
    got[i, 3:9] = out[j, 3:9]
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the near-tie rule"):
        chip_smoke.compare_near_tie(got, out, rays, planted, "planted flip", tensor=True)


# ── any-hit flags under the sums' rounding kind (compare_flags with rays) ──


def test_flag_flip_within_rounding_bound_passes(soup):
    """A ray whose only hit slot's u margin is an exact cancellation (within
    any rounding bound): its flag flipped, as a tensor-core any-hit kernel
    may report it, is explained; the rule without the rays fails it, and
    so does the rule with the rays when the share it allows off the park
    point is 0."""
    fb, rays, want = soup
    i, planted, _ = _planted_u_margin(fb, rays, want, extra=False)
    want_a = fused2.fused2_traverse_packed_plain(rays, planted, "any_hit")
    got = want_a.clone()
    got[i, 4] = 1.0 - got[i, 4]
    assert bool(chip_smoke.flag_rounding(rays[i : i + 1], planted)[0])
    share = 1.0 - 1.0 / rays.shape[0]
    assert chip_smoke.compare_flags(got, want_a, "planted flag", share, rays=rays, fb=planted) == 1
    with pytest.raises(chip_smoke.SmokeFailure, match="flags differ"):
        chip_smoke.compare_flags(got, want_a, "planted flag", min_share=1.0)
    with pytest.raises(chip_smoke.SmokeFailure, match="off the park point"):
        chip_smoke.compare_flags(got, want_a, "planted flag", 1.0, rays=rays, fb=planted)


def test_flag_flip_beyond_rounding_bound_fails(soup):
    """A flipped flag on a ray none of whose entered slots is decided within
    the bound is not explained."""
    fb, rays, want = soup
    want_a = fused2.fused2_traverse_packed_plain(rays, fb, "any_hit")
    far = chip_smoke.flag_rounding(rays[:300], fb)
    i = int(torch.nonzero(~far).squeeze(1)[0])
    got = want_a.clone()
    got[i, 4] = 1.0 - got[i, 4]
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the sums' rounding"):
        chip_smoke.compare_flags(got, want_a, "planted flag", rays=rays, fb=fb)


def test_tf32_bound_counts_three_tf32_products_per_f32_product():
    """The f32 tensor-core rows' second bound: the same slots with three TF32
    products each at the TF32 rate, against the window chain at fp32 and the
    bytes; never above the fp32-peak bound.  Each TF32 product is the one
    k=8 step per column group that the kernel issues (12 mma.sync m16n8k8
    per 16 rays and 8 slots: 192 FLOP per ray and slot), not the reference's
    16-row product."""
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=torch.float32)
    rays = fused2.pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3])
    want = fused2.fused2_traverse_packed_plain(rays, fb)
    closest = torch.zeros(rays.shape[0], dtype=torch.bool)
    (fp32_ms, _), need = chip_smoke.bound(rays, want, fb, closest)
    (tf32_ms, by), need_tf32 = chip_smoke.bound(rays, want, fb, closest, tf32=True)
    slots = fb.cluster_size * float(chip_smoke.needed_clusters(rays, want, fb, closest).sum())
    assert chip_smoke.TF32_FLOP == 12 * 2 * 16 * 8 * 8 // (16 * 8) == 192
    ops = max(chip_smoke.TF32_FLOP * slots / chip_smoke.TF32_FLOPS,
              chip_smoke.CHAIN_OPS * slots / chip_smoke.FP32_FLOPS) * 1e3
    assert need_tf32 == need and tf32_ms <= fp32_ms
    assert tf32_ms == ops if by == "operations" else tf32_ms > ops


def test_no_fma_ceiling_is_twice_the_fp32_peak_bound():
    """The component rows' second bound: the same Moller-Trumbore operations
    at half the fp32 peak (one instruction each under --fmad=false), so the
    fp32-peak bound is half of it where operations bound both: no component
    kernel can pass 50% of its fp32-peak bound."""
    fb, (o, d, tmax) = chip_smoke.soup("cpu", mxu=False)
    o, d, tmax = (x.repeat(64, *([1] * (x.dim() - 1))) for x in (o, d, tmax))  # enough rays to be op-bound
    rays = fused2.pack_rays(o, d, tmax)
    want = fused2.fused2_traverse_packed_plain(rays, fb)
    closest = torch.zeros(rays.shape[0], dtype=torch.bool)
    (fp32_ms, by), need = chip_smoke.bound(rays, want, fb, closest)
    (ceiling_ms, ceiling_by), need_ceiling = chip_smoke.bound(rays, want, fb, closest, no_fma=True)
    slots = fb.cluster_size * float(chip_smoke.needed_clusters(rays, want, fb, closest).sum())
    assert by == ceiling_by == "operations" and need_ceiling == need
    assert fp32_ms == pytest.approx(chip_smoke.MT_OPS * slots / chip_smoke.FP32_FLOPS * 1e3, rel=1e-12)
    assert fp32_ms == pytest.approx(ceiling_ms / 2, rel=1e-12)
    assert chip_smoke.FP32_NO_FMA_OPS == chip_smoke.FP32_FLOPS / 2


def _profile(rows):
    """A profile entry's rows from per-block phase cycles and retired clusters."""
    phases = torch.tensor([r[0] for r in rows], dtype=torch.int64)
    steps = torch.tensor([[r[1]] for r in rows], dtype=torch.int64)
    return torch.cat([phases, phases.sum(1, keepdim=True), steps], 1)


def test_profile_split_names_the_slowest_and_the_mean_block():
    prof = _profile([([10, 20, 0, 60, 10], 4), ([5, 10, 5, 170, 10], 9), ([10, 10, 10, 60, 10], 2)])
    split = chip_smoke.profile_split(prof)
    assert split["slowest"]["block"] == 1 and split["slowest"]["cycles"] == 200.0
    assert split["slowest"]["clusters"] == 9
    assert split["slowest"]["share"] == pytest.approx(
        {"setup": 0.025, "pick": 0.05, "stage": 0.025, "test": 0.85, "payload": 0.05})
    assert split["mean"]["cycles"] == pytest.approx(400 / 3)
    assert split["mean"]["share"]["test"] == pytest.approx(290 / 400)
    assert sum(split["mean"]["share"].values()) == pytest.approx(1.0)
    assert split["clusters_per_block"] == {"mean": pytest.approx(5.0), "max": 9}
    line = chip_smoke.format_split(split, mhz=1000.0)
    assert "slowest block 200 cycles = 0.000 ms at 1000 MHz" in line and "test 85.0%" in line
    assert "clusters per block mean 5.00 max 9" in line


def test_profile_split_of_idle_blocks():
    """A block that skipped the scene (no cycles in any phase) has shares 0."""
    split = chip_smoke.profile_split(_profile([([0, 0, 0, 0, 0], 0)]))
    assert split["slowest"]["share"] == dict.fromkeys(fused2.PROFILE_COLS[:5], 0.0)


def test_differing_columns_compares_bits():
    a = torch.zeros(4, fused2.OUT_COLS)
    b = a.clone()
    assert chip_smoke.differing_columns(a, b) == {}
    b[1, 3], b[2, 3], b[0, 30] = 1.0, -2.0, -0.0  # -0.0 == 0.0 as floats, not as bits
    assert chip_smoke.differing_columns(a, b) == {3: 2, 30: 1}
    a[:, 8] = b[:, 8] = float("nan")
    assert 8 not in chip_smoke.differing_columns(a, b)


# ── K4's loop t/u/v on the tensor cores (compare_near_tie without a blob) ──


@pytest.fixture(scope="module")
def k4_soup():
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=torch.float32)
    rays = fused2.pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3])
    want = fused2.fused2_traverse_packed_plain(rays, fb, with_attrs=False)
    hit = torch.nonzero(want[:, 4] > 0).squeeze(1)
    bnd = chip_smoke.loop_tuv_errors(rays[hit], fb, want[hit, 7].long(), want[hit, 8].long())
    return fb, rays, want, hit, bnd


def test_loop_tuv_within_rounding_bound_pass(k4_soup):
    """K4's tensor form: t/u/v moved by half of each quotient's rounding
    bound pass, also where that is beyond rtol 5e-6."""
    fb, rays, want, hit, bnd = k4_soup
    got = want.clone()
    got[hit, 0:3] += 0.5 * bnd
    beyond = ~torch.isclose(got[hit, 0:3], want[hit, 0:3], rtol=5e-6, atol=1e-6).all(1)
    assert int(beyond.sum()) > 0
    chip_smoke.compare_near_tie(got, want, rays, fb, "in-bound tuv", blob=False, tensor=True)


@pytest.mark.parametrize("col", [0, 1, 2], ids=["t", "u", "v"])
def test_loop_tuv_beyond_rounding_bound_fails(k4_soup, col):
    fb, rays, want, hit, bnd = k4_soup
    got = want.clone()
    got[hit, col] += 2 * bnd[:, col] + 1e-5 * got[hit, col].abs() + 1e-6
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the sums' rounding"):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted tuv", blob=False, tensor=True)


def test_loop_tuv_rule_only_for_the_tensor_form(k4_soup):
    """Without ``tensor`` (K4's exact form) t/u/v stay at rtol 5e-6."""
    fb, rays, want, hit, bnd = k4_soup
    got = want.clone()
    got[hit, 0] *= 1 + 1e-4
    with pytest.raises(AssertionError):
        chip_smoke.compare_near_tie(got, want, rays, fb, "planted tuv", blob=False)


# ── K6's tensor form (compare_probe_tensor) and its bound ─────────────────


def _probe_f64(feat, pl, best):
    """The probe's chain with its feature sums taken in float64 and rounded
    once (another summation than the plain version's left-to-right float32
    sums, inside their rounding bound): a stand-in for the tensor cores."""
    c = pl.shape[2] // lp.GROUPS
    acc = (feat.double()[:, :, :, None] * pl.double()[:, None]).sum(2).float()
    det, ua, vb, tcd = acc.split(c, dim=-1)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    dd, ua, vb, tcd = det * sgn, ua * sgn, vb * sgn, tcd * sgn
    ok = ((dd >= 1e-12) & (ua >= 0.0) & (vb >= 0.0) & (ua + vb <= dd) & (tcd > dd * m.T_MIN)
          & (tcd < dd * best[..., None]))
    t = torch.where(ok, tcd / torch.where(dd < 1e-12, 1.0, dd), torch.inf).amin(-1)
    return torch.where(t < best, t, best)


@pytest.fixture(scope="module", params=["pick_dma_mm", "pick_dma_mm_bf16", "interleave2"])
def probe_case(request):
    name = request.param
    v = lp.variant(name)
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=torch.bfloat16 if v.bf16 else torch.float32)
    rays = fused2.pack_rays(o[:256], d[:256], tmax[:256])
    want = lp.latency_probe_plain(rays, fb.boxes, fb.planes, name, 8, 128)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lp, "_chain_best", _probe_f64)
        other = lp.latency_probe_plain(rays, fb.boxes, fb.planes, name, 8, 128)
    return name, fb, rays, want, other


def test_probe_rule_passes_another_summation(probe_case):
    """The probe's best t from sums taken in another order (float64, rounded
    once) passes; on f32 planes it differs from the plain version's on some
    rays (bf16 planes' exact products of few bits sum alike here)."""
    name, fb, rays, want, other = probe_case
    err, differ = chip_smoke.compare_probe_tensor(other, want, rays, fb.boxes, fb.planes, name, 8, 128, "f64 sums")
    assert differ == int((other[..., 0] != want[..., 0]).sum()) and err < 1e-4
    assert differ > 0 or lp.variant(name).bf16
    assert chip_smoke.compare_probe_tensor(want.clone(), want, rays, fb.boxes, fb.planes, name, 8, 128,
                                           "same") == (0.0, 0)


def test_probe_rule_passes_a_planted_in_bound_difference(probe_case):
    """One ulp up or down on every hit lies within the bound."""
    name, fb, rays, want, _ = probe_case
    got = want.clone()
    hit = got[..., 0] < rays[:, 6].view(got.shape[:2])
    assert int(hit.sum()) > 0
    got[..., 0][hit] = torch.nextafter(got[..., 0][hit], torch.tensor(torch.inf))
    chip_smoke.compare_probe_tensor(got, want, rays, fb.boxes, fb.planes, name, 8, 128, "one ulp")


@pytest.mark.parametrize("fault", ["farther", "nearer", "miss_hits", "hit_misses", "column"])
def test_probe_rule_fails_planted_out_of_bound_faults(probe_case, fault):
    """A best t 1e-3 farther or nearer than a hit's, a hit for a ray that
    meets nothing, a miss for a ray that surely hits, or a non-zero column
    1-15 fail."""
    name, fb, rays, want, _ = probe_case
    got = want.clone()
    t = got[..., 0]
    hit = t < rays[:, 6].view(got.shape[:2])
    if fault == "farther":
        t[hit] *= 1 + 1e-3
    elif fault == "nearer":
        t[hit] *= 1 - 1e-3
    elif fault == "miss_hits":
        t[~hit] = 1.0
    elif fault == "hit_misses":
        t[hit] = rays[:, 6].view(got.shape[:2])[hit]
    else:
        got[..., 3] = 1.0
    with pytest.raises(chip_smoke.SmokeFailure, match="beyond the sums' rounding|columns 1-15"):
        chip_smoke.compare_probe_tensor(got, want, rays, fb.boxes, fb.planes, name, 8, 128, f"planted {fault}")


def test_probe_rule_holds_variants_without_a_product_of_planes_equal():
    """sched_mm multiplies zeros (no copy): any difference fails."""
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=torch.float32)
    rays = fused2.pack_rays(o[:256], d[:256], tmax[:256])
    want = lp.latency_probe_plain(rays, fb.boxes, fb.planes, "sched_mm", 8, 128)
    got = want.clone()
    got[0, 0, 0] = 1.0
    with pytest.raises(chip_smoke.SmokeFailure, match="without a product of planes"):
        chip_smoke.compare_probe_tensor(got, want, rays, fb.boxes, fb.planes, "sched_mm", 8, 128, "planted")


@pytest.mark.parametrize("name", ["pick_dma_mm", "pick_dma_mm_bf16", "sched_mm", "sched_dma", "interleave4"])
def test_probe_bound_of_the_tensor_form(name):
    """The tensor form's bound: the slab tests at fp32, then per chain
    iteration the larger of the product at the tensor rate (bf16 MXU_FLOP
    per slot at 989 TFLOP/s; f32 three TF32 products of one k=8 step per
    column group, TF32_FLOP, at 495) and the 28-operation window at the fp32
    peak, against the bytes of the staged rows; the exact form's bound
    (products of the live rows at fp32) is never below it.  On an H100 the
    window paces both plane types: 28 operations at 67 TFLOP/s take longer
    than 128 FLOP at 989 or 192 at 495.  Without a product both agree."""
    v = lp.variant(name)
    n, k, c = 131072, 768, 512
    rays, boxes = torch.zeros((n, 8)), torch.zeros((8, k))
    planes = torch.zeros((k, 16, 4 * c), dtype=torch.bfloat16 if v.bf16 else torch.float32)
    tensor = chip_smoke.probe_bound(rays, boxes, planes, name, 16, 256, tensor=True)
    exact = chip_smoke.probe_bound(rays, boxes, planes, name, 16, 256)
    chain_iters = n * lp.trips(v, 16) * v.chains
    slab = n * chip_smoke.SLAB_OPS * k / chip_smoke.FP32_FLOPS
    if not v.mm:
        assert tensor == exact
        return
    window = chip_smoke.CHAIN_OPS / chip_smoke.FP32_FLOPS
    product = (chip_smoke.MXU_FLOP / chip_smoke.BF16_FLOPS if v.bf16
               else chip_smoke.TF32_FLOP / chip_smoke.TF32_FLOPS)
    assert window > product  # the window paces both
    assert tensor == (pytest.approx((slab + chain_iters * c * max(window, product)) * 1e3, rel=1e-12), "operations")
    assert exact[0] > tensor[0]


# ── phase 6k: the reading of tools/bench.py's standard output ──────────────

SMI = "NVIDIA H100 80GB HBM3, 700.00 W"
HEAD_RAYS = 31_457_280


@pytest.fixture
def bench_out(monkeypatch, capsys):
    """A well-formed ``bench --spp 8`` output (device line, trend line,
    headline), made by the bench's own main with run_config replaced, and
    the metrics phase 6k expects of it."""
    import copy

    from owl_path_tracer_tpu_torch.tools import bench

    n_tris = {"dragon": 81924, "dragon7": 327684}

    def run_config(args, scene_name, size, spp, depth, nee=False):
        rays = HEAD_RAYS if scene_name == "dragon7" else 4_000_000
        return 6.5, bench.label(args, scene_name, n_tris[scene_name], size, spp, depth, nee), rays, 1.25

    monkeypatch.setattr(bench, "run_config", run_config)
    monkeypatch.setattr(bench.pc, "generated_dragon", lambda sub: "dragon" if sub <= 6 else f"dragon{sub}")
    monkeypatch.setattr(bench.pc, "device_name", lambda device: SMI)
    print("a progress line before the records")
    bench.main(["--device", "cpu", "--spp", "8"])
    args = bench.parse_args(["--spp", "8"])
    targs = copy.copy(args)
    targs.intersector = "fused2"
    metrics = [f"trend Mrays/s (frozen: {bench.label(targs, 'dragon', 81924, 512, 4, 4)})",
               f"fwd Mrays/s ({bench.label(args, 'dragon7', 327684, 1024, 8, 4)})"]
    return capsys.readouterr().out, metrics


def _relines(out, edit):
    lines = out.strip().splitlines()
    return "\n".join(edit(lines)) + "\n"


def test_bench_lines_pass_a_well_formed_pair(bench_out):
    out, metrics = bench_out
    info, (trend, head) = chip_smoke.bench_lines(out, metrics, SMI, rays=HEAD_RAYS)
    assert info["configs"][-1]["rays"] == HEAD_RAYS and head["metric"] == metrics[-1]
    assert trend["value"] == head["value"] == 6.5
    # the headline alone (--quick's shape)
    chip_smoke.bench_lines(_relines(out, lambda ls: [ls[0], json.dumps({"device": SMI, "configs": [
        json.loads(ls[-3])["configs"][1]]}), ls[-1]]), metrics[1:], SMI)


@pytest.mark.parametrize("edit", [
    lambda ls: ls[:-2] + [ls[-1], ls[-2]],  # headline before the trend line
    lambda ls: ls + ['{"metric": "after", "value": 1, "unit": "Mrays/s", "vs_baseline": 1}'],
    lambda ls: ls + ["done"],
    lambda ls: ls[:-1],  # no headline
], ids=["swapped", "json_after", "text_after", "missing"])
def test_bench_lines_fail_when_the_headline_is_not_last(bench_out, edit):
    out, metrics = bench_out
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.bench_lines(_relines(out, edit), metrics, SMI, rays=HEAD_RAYS)


@pytest.mark.parametrize("line", [-1, -2], ids=["headline", "trend"])
@pytest.mark.parametrize("key", chip_smoke.BENCH_KEYS)
def test_bench_lines_fail_a_missing_key(bench_out, key, line):
    out, metrics = bench_out

    def drop(ls):
        rec = json.loads(ls[line])
        del rec[key]
        ls[line] = json.dumps(rec)
        return ls

    with pytest.raises(chip_smoke.SmokeFailure, match="lacks"):
        chip_smoke.bench_lines(_relines(out, drop), metrics, SMI, rays=HEAD_RAYS)


@pytest.mark.parametrize("value", [0, 0.0, -1.5, "6.5", None])
def test_bench_lines_fail_a_value_not_above_zero(bench_out, value):
    out, metrics = bench_out

    def set_value(ls):
        ls[-1] = json.dumps(dict(json.loads(ls[-1]), value=value))
        return ls

    with pytest.raises(chip_smoke.SmokeFailure, match="value"):
        chip_smoke.bench_lines(_relines(out, set_value), metrics, SMI, rays=HEAD_RAYS)


@pytest.mark.parametrize("delta", [-1, 1, -HEAD_RAYS // 2])
def test_bench_lines_fail_rays_unlike_phase_6c(bench_out, delta):
    out, metrics = bench_out
    with pytest.raises(chip_smoke.SmokeFailure, match="phase 6c"):
        chip_smoke.bench_lines(out, metrics, SMI, rays=HEAD_RAYS + delta)


def test_bench_lines_fail_another_card_or_config(bench_out):
    out, metrics = bench_out
    with pytest.raises(chip_smoke.SmokeFailure, match="device line"):
        chip_smoke.bench_lines(out, metrics, "NVIDIA H100 80GB HBM3, 500.00 W", rays=HEAD_RAYS)
    other = [metrics[0], metrics[1].replace("spp=8", "spp=64")]
    with pytest.raises(chip_smoke.SmokeFailure, match="expected"):
        chip_smoke.bench_lines(out, other, SMI, rays=HEAD_RAYS)


def test_bench_defaults_are_phase_6s_configuration():
    from owl_path_tracer_tpu_torch.tools import bench

    args = bench.parse_args(["--spp", "8"])
    assert (args.size, args.depth, args.lanes, args.fused2_block, args.dragon_sub) == (
        chip_smoke.SIZE, chip_smoke.DEPTH, chip_smoke.LANES, chip_smoke.BLOCK, chip_smoke.DRAGON_SUB)
    assert (args.intersector, args.renderer, args.no_sort, args.iters_per_launch) == (
        "fused2-bf16", "wavefront", False, 32)
