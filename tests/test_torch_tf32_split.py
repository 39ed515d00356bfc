"""The bound that K1b's f32 tensor-core form (3xTF32) is held to on the card.

The kernel splits every ray feature f and plane value p into two TF32 terms,
hi = tf32(x) (round to nearest, ties away: ``cvt.rna.tf32.f32``) and lo =
tf32(x - hi), and sums lo*hi + hi*lo + hi*hi per column group in the tensor
cores.  A plain emulation of that split, accumulated in float64 (no
accumulator error of its own), must stay within chip_smoke.SUM_GAMMA_F32 of
the plain version's float32 sums (``fused2._feature_sums``) per unit of the
sum of the terms' magnitudes, with most of the bound left for the tensor
cores' accumulation: on random features and on the features and clusters of
primary rays into the dragon and cornell-box scenes.
"""
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu_torch.models.camera import primary_rays
from owl_path_tracer_tpu_torch.models.scene import compile_scene
from owl_path_tracer_tpu_torch.ops import fused2
from owl_path_tracer_tpu_torch.render import film
from owl_path_tracer_tpu_torch.render.film import make_accel

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


def tf32(x):
    """float32 -> float32 rounded to TF32's 10 mantissa bits, nearest with
    ties away from zero (the magnitude bits plus half an ulp of TF32,
    truncated)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, np.float32) - hi).astype(np.float32))


def emulated_sums(feat, planes, cid):
    """[n,10] features, MXU planes, [n] clusters -> per column group the
    3xTF32 sums over its live rows, in float64 ([n,C] each)."""
    c = planes.shape[2] // 4
    fh, fl = split(feat.numpy())
    out = []
    for g, r0, r1 in fused2.MXU_ROWS:
        ph, pl = split(planes[cid, r0:r1, g * c : (g + 1) * c].numpy())  # [n, rows, C]
        a_h, a_l = fh[:, r0:r1, None].astype(np.float64), fl[:, r0:r1, None].astype(np.float64)
        out.append((a_l * ph + a_h * pl + a_h * ph).sum(1))
    return out


def worst_ratio(ray_o, ray_d, fb, cid):
    """max over rays, slots and groups of |emulated - plain| / sum |terms|."""
    feat = fused2._ray_features(ray_o, ray_d, False)
    plain = fused2._feature_sums(feat, fb.planes, cid, slice(0, fb.cluster_size))
    absolute = fused2._feature_sums(feat, fb.planes, cid, slice(0, fb.cluster_size), absolute=True)
    worst = 0.0
    for emu, p, a in zip(emulated_sums(feat, fb.planes, cid), plain, absolute):
        a = a.double().numpy()
        live = a > 0
        worst = max(worst, float((np.abs(emu - p.double().numpy())[live] / a[live]).max()))
    return worst


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)
    assert tf32(np.array([one + ulp / 2], np.float32))[0] == one + ulp  # a tie rounds away
    assert tf32(np.array([-(one + ulp / 2)], np.float32))[0] == -(one + ulp)
    assert tf32(np.array([one + ulp / 4], np.float32))[0] == one
    x = np.random.default_rng(0).normal(size=10000).astype(np.float32)
    hi, lo = split(x)
    assert (np.abs(x - hi) <= 2.0**-11 * np.abs(x)).all()
    assert (np.abs(x - hi - lo) <= 2.0**-22 * np.abs(x)).all()


def test_split_within_gamma_on_random_features():
    fb, (o, d, _) = chip_smoke.soup("cpu")
    r = np.random.default_rng(1)
    cid = torch.as_tensor(r.integers(0, fb.num_clusters, o.shape[0]))
    worst = worst_ratio(o, d, fb, cid)
    # the split's own error and the plain version's roundings only (< 23 x
    # 2^-24): the rest of SUM_GAMMA_F32 is the tensor cores' accumulation
    assert 0.0 < worst < 23 * 2.0**-24 < chip_smoke.SUM_GAMMA_F32


@pytest.mark.parametrize("name", ["dragon", "cornell-box"])
def test_split_within_gamma_on_scene_features(name):
    size = 32
    scene = compile_scene(ASSETS, name, (size, size), device="cpu")
    fb = make_accel(scene, "fused2")
    assert fb.layout == "mxu_f32"
    grid = film._pixel_grid(size, size, "cpu")
    o, d = primary_rays(scene.camera, grid, torch.full((size * size, 2), 0.5), (size, size))
    out = fused2.fused2_traverse_packed_plain(fused2.pack_rays(o, d, 1e10), fb)
    hit = out[:, 4] > 0
    assert int(hit.sum()) > 50
    worst = worst_ratio(o[hit], d[hit], fb, out[hit, 7].long())
    assert 0.0 < worst < 23 * 2.0**-24 < chip_smoke.SUM_GAMMA_F32
