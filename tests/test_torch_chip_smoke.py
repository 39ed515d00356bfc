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

import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu_torch.ops import fused2
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
    bytes; never above the fp32-peak bound."""
    fb, (o, d, tmax) = chip_smoke.soup("cpu", plane_dtype=torch.float32)
    rays = fused2.pack_rays(*fused2._pad_rays(o, d, tmax, 128)[:3])
    want = fused2.fused2_traverse_packed_plain(rays, fb)
    closest = torch.zeros(rays.shape[0], dtype=torch.bool)
    (fp32_ms, _), need = chip_smoke.bound(rays, want, fb, closest)
    (tf32_ms, by), need_tf32 = chip_smoke.bound(rays, want, fb, closest, tf32=True)
    slots = fb.cluster_size * float(chip_smoke.needed_clusters(rays, want, fb, closest).sum())
    ops = max(3 * chip_smoke.MXU_FLOP * slots / chip_smoke.TF32_FLOPS,
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
