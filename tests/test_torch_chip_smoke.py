"""The near-tie rule of chip_smoke.py (``compare_near_tie``), which holds the
MXU-layout kernel (K1b, K4) against its plain version on the card, fails a
wrong winner.  Here the plain version with a planted fault stands in for a
faulty kernel, on the CPU at the soup's size (3000 triangles, C=64, 300 rays
padded to 384): a plain version that drops the t_min test (hits behind the
origin and self-hits), one that skips the nearest hits (a farther valid hit
wins), and winners copied from other rays (slots outside this ray's window).
"""
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
