"""The port on a CUDA card: the fused2 kernel in its three modes (closest hit,
any-hit, mixed) on the component layout (K1-K3; its slot-parallel body
against the serial body bit for bit in every column, and the profile
entry's cycles and outputs) and the MXU feature layout
with f32 and bf16 planes (K1b, on the tensor cores), and without attributes
(K4; on f32 MXU planes on the tensor cores), every fused2 entry above
its old cluster limit and with its frontier rows forced into device
memory (bit-equal to the rows in shared memory; at C=512 above the old
limit, shared by 4 CTAs), the fused kernel (K5, also above the cluster
count one block's shared memory once held, with its heavy-first order) and
the latency probe (K6, its exact form bit-equal and its tensor form within
the sums' rounding), against their plain versions, and frames
(wavefront without and with NEE, stopped and resumed from a checkpoint, and
the scan renderer on the fused kernel) rendered on the card against the same
frames on the CPU or uninterrupted, the wavefront film rendered twice, and
the gradient path (material and camera gradients through K1b on f32 and
bf16 planes against the CPU's plain version, by chip_smoke.py's phase-5g
rule; the brute sweep against the cluster query), the per-ray-stack BVH on
the card against the CPU, the sharded wavefront at world size 1 over NCCL
against the unsharded one, the debug layer's checks on CUDA tensors,
a frame of each benchmark cell's path with every synchronising call inside
an ``owlpt.sync.*`` range and every bounce step shaded in one launch of the
shading kernel, each wavefront cell's frame ending at its last busy step
(bit-equal to launches that run all their steps), and that kernel against the plain ``_shade_bounce`` on
random bounces (every lobe and case; the lane's fate, depth, LCG state and
lobe exact, the rest to rtol 1e-5 / atol 1e-6), and the deferred NEE
shading kernel against the plain ``_shade_bounce_nee`` on random NEE
bounces (the same rule, the pending shadow ray's flag exact and its
geometry and contribution on the pending lanes).

Imports nothing of JAX (the card's machine has none).  Every test is marked
``cuda`` and skips where there is no CUDA device.  On the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances: winning
triangle, winner cluster/slot and attribute blob exact; t/u/v to rtol 5e-6
(both sides evaluate mt_components in the same op order without FMAs, so
they agree bit for bit in practice); images by the golden rule of
tests/test_golden.py.  K1b and K4 on MXU planes sum the feature products in
the tensor cores' order and rounding, so they are held to chip_smoke.py's
near-tie rule with the sums' rounding kind
(``compare_near_tie(..., tensor=True)``).
"""
import collections
import contextlib
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_frontier_row as frontier_row
from test_torch_shade import random_bounce, random_nee_bounce
from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import fused as tfu
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.ops import latency_probe as tlp
from owl_path_tracer_tpu_torch.ops import shade
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import integrator, wavefront
from owl_path_tracer_tpu_torch.render.film import make_accel
from owl_path_tracer_tpu_torch.render.wavefront import render_image_wavefront
from owl_path_tracer_tpu_torch.tools.probe_common import ensure_dragon

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def soup():
    """3000 random triangles (tests/test_fused2.py's soup), C=64, 512 rays
    with per-ray t_max on half of them."""
    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(9000, dtype=np.int32).reshape(3000, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    tc = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    mat = r.integers(0, 5, 3000).astype(np.int32)
    fb = tf2.build_fused2(verts, idx, 64, normals, tc, mat, mxu=False, device="cpu")
    n = 512
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.5, r.uniform(1.0, 8.0, n), 1e10).astype(np.float32)
    return fb, o, d, tmax


def assert_kernel_output_matches(got, want):
    assert (got[:, 5] == 1).all(), "a block left rays unresolved"
    for col in (3, 4, 7, 8):  # tri, hit, winner cluster, winner slot
        torch.testing.assert_close(got[:, col], want[:, col], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 0:3], want[:, 0:3], rtol=5e-6, atol=1e-6)
    torch.testing.assert_close(got[:, 16:32], want[:, 16:32], rtol=0, atol=0)


@pytest.mark.parametrize("block", [128, 256])
def test_kernel_matches_plain(soup, cuda_device, block):
    fb, o, d, tmax = soup
    fb = fb.to(cuda_device)
    args = [torch.as_tensor(x[:300], device=cuda_device) for x in (o, d, tmax)]
    rays = tf2.pack_rays(*tf2._pad_rays(*args, block)[:3])  # 300 rays, then padding rays
    launches = tf2.LAUNCHES["owlpt_fused2_closest_hit"]
    got = tf2.fused2_traverse_packed(rays, fb, block=block)
    assert tf2.LAUNCHES["owlpt_fused2_closest_hit"] == launches + 1
    want = tf2.fused2_traverse_packed_plain(rays, fb)
    torch.cuda.synchronize()
    assert_kernel_output_matches(got, want)
    assert (got[300:, 4] == 0).all()  # padding rays never hit


def test_overflow_matches_plain(soup, cuda_device):
    """max_steps=1 leaves blocks unresolved; the wrapper's answer equals the
    plain version's."""
    fb, o, d, tmax = soup
    fb = fb.to(cuda_device)
    args = [torch.as_tensor(x, device=cuda_device) for x in (o, d, tmax)]
    out = tf2.fused2_traverse_packed(tf2.pack_rays(*args), fb, block=128, max_steps=1)
    assert (out[:, 5] == 0).any()
    rec, blob = tf2.fused2_closest_hit(args[0], args[1], fb, t_max=args[2], max_steps=1)
    ref, ref_blob = tf2._hits_from_output(
        tf2.fused2_traverse_packed_plain(tf2.pack_rays(*args), fb), args[0], args[1], fb, 1e-3, args[2])
    torch.testing.assert_close(rec.tri, ref.tri, rtol=0, atol=0)
    torch.testing.assert_close(rec.t, ref.t, rtol=5e-6, atol=1e-6)
    torch.testing.assert_close(blob, ref_blob, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["morton", "cid2"])
def test_sorted_equals_unsorted(soup, cuda_device, mode):
    fb, o, d, tmax = soup
    fb = fb.to(cuda_device)
    args = [torch.as_tensor(x, device=cuda_device) for x in (o, d, tmax)]
    a, blob_a = tf2.fused2_closest_hit(args[0], args[1], fb, t_max=args[2])
    b, blob_b = tf2.fused2_closest_hit(args[0], args[1], fb, t_max=args[2], sort=mode)
    torch.testing.assert_close(a.tri, b.tri, rtol=0, atol=0)
    torch.testing.assert_close(a.t, b.t, rtol=0, atol=0)
    torch.testing.assert_close(blob_a, blob_b, rtol=0, atol=0)


def test_frame_on_card_matches_cpu(cuda_device):
    settings = RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3,
                              environment_auto=True)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), device="cpu")
    accel = tf2.build_fused2_scene(scene, mxu=False)
    want, rays_want = render_image_wavefront(scene, settings, accel, lanes=1024, fused2_sort=True)
    img, rays = render_image_wavefront(scene.to(cuda_device), settings, accel.to(cuda_device),
                                       lanes=1024, fused2_sort=True)
    img, want = img.cpu().numpy(), want.numpy()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want


def _mixed_inputs(soup, device):
    """The soup's rays, every other one a shadow lane with a light distance."""
    fb, o, d, tmax = soup
    r = np.random.default_rng(1)
    shadow = np.arange(len(o)) % 2 == 1
    dist = np.where(shadow, r.uniform(2.0, 20.0, len(o)), 1e10).astype(np.float32)
    return fb.to(device), [torch.as_tensor(x, device=device) for x in (o, d, tmax, dist, shadow)]


@pytest.mark.parametrize("block", [128, 256])
def test_any_hit_kernel_matches_plain(soup, cuda_device, block):
    fb, (o, d, tmax, _, _) = _mixed_inputs(soup, cuda_device)
    rays = tf2.pack_rays(*tf2._pad_rays(o[:300], d[:300], tmax[:300], block)[:3])
    launches = tf2.LAUNCHES["owlpt_fused2_occluded"]
    got = tf2.fused2_traverse_packed(rays, fb, block=block, mode="any_hit")
    assert tf2.LAUNCHES["owlpt_fused2_occluded"] == launches + 1
    want = tf2.fused2_traverse_packed_plain(rays, fb, mode="any_hit")
    torch.cuda.synchronize()
    assert (got[:, 5] == 1).all()
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 0], rays[:, 6], rtol=0, atol=0)  # t is never lowered
    assert 0 < int(got[:300, 4].sum()) < 300 and (got[300:, 4] == 0).all()


@pytest.mark.parametrize("block", [128, 256])
def test_mixed_kernel_matches_plain(soup, cuda_device, block):
    """Closest-hit lanes: K1's contract (winners, cluster/slot and blob exact,
    t/u/v to rtol 5e-6); shadow lanes: the occlusion flag exactly."""
    fb, (o, d, _, dist, shadow) = _mixed_inputs(soup, cuda_device)
    o_p, d_p, t_p, _ = tf2._pad_rays(o, d, dist, block)
    sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - len(o))])
    rays = tf2.pack_rays(o_p, d_p, t_p, sh_p)
    launches = tf2.LAUNCHES["owlpt_fused2_sweep_mixed"]
    got = tf2.fused2_traverse_packed(rays, fb, block=block, mode="mixed")
    assert tf2.LAUNCHES["owlpt_fused2_sweep_mixed"] == launches + 1
    want = tf2.fused2_traverse_packed_plain(rays, fb, mode="mixed")
    torch.cuda.synchronize()
    assert_kernel_output_matches(got[~sh_p], want[~sh_p])
    torch.testing.assert_close(got[sh_p, 4], want[sh_p, 4], rtol=0, atol=0)
    assert (got[sh_p, 5] == 1).all() and 0 < int(got[sh_p, 4].sum()) < int(sh_p.sum())


def test_new_modes_overflow_match_plain(soup, cuda_device):
    """max_steps=1 leaves blocks unresolved in both new modes; the wrappers'
    answers equal the CPU answers."""
    fb, (o, d, tmax, dist, shadow) = _mixed_inputs(soup, cuda_device)
    out = tf2.fused2_traverse_packed(tf2.pack_rays(o, d, tmax), fb, block=128, max_steps=1, mode="any_hit")
    assert (out[:, 5] == 0).any()
    out = tf2.fused2_traverse_packed(tf2.pack_rays(o, d, dist, shadow), fb, block=128, max_steps=1, mode="mixed")
    assert (out[shadow, 5] == 0).any() and (out[~shadow, 5] == 0).any()
    occ = tf2.fused2_occluded(o, d, fb, t_max=tmax, max_steps=1)
    cpu = [x.cpu() for x in (o, d, tmax, dist, shadow)]
    fb_cpu = fb.to("cpu")
    torch.testing.assert_close(occ.cpu(), tf2.fused2_occluded(cpu[0], cpu[1], fb_cpu, t_max=cpu[2]),
                               rtol=0, atol=0)
    rec, blob, occ_m = tf2.fused2_sweep_mixed(o, d, dist, shadow, fb, max_steps=1)
    ref, ref_blob, ref_occ = tf2.fused2_sweep_mixed(cpu[0], cpu[1], cpu[3], cpu[4], fb_cpu)
    ns = ~cpu[4]
    torch.testing.assert_close(rec.tri.cpu()[ns], ref.tri[ns], rtol=0, atol=0)
    torch.testing.assert_close(rec.t.cpu()[ns], ref.t[ns], rtol=5e-6, atol=1e-6)
    torch.testing.assert_close(blob.cpu()[ns], ref_blob[ns], rtol=0, atol=0)
    torch.testing.assert_close(occ_m.cpu()[cpu[4]], ref_occ[cpu[4]], rtol=0, atol=0)


# the component entries: K1 closest + attributes, K2 any-hit, K3 mixed, K4 closest without attributes
COMPONENT_MODES = {"K1": ("closest", True), "K2": ("any_hit", False), "K3": ("mixed", True), "K4": ("closest", False)}


@pytest.fixture(scope="module")
def component_soups():
    """chip_smoke's random soup (3000 triangles, 300 rays with per-ray t_max,
    every other ray a shadow lane with a light distance in the mixed sweep)
    and its tie soup (exact t ties between two copies of one triangle in one
    cluster), as numpy, and their component builds by C, made once."""
    mesh, (o, d, tmax) = chip_smoke.soup_arrays()
    r = np.random.default_rng(1)
    shadow = np.arange(len(o)) % 2 == 1
    dist = np.where(shadow, r.uniform(2.0, 20.0, len(o)), 1e10).astype(np.float32)
    tie_mesh, (to, td, ttmax, tshadow) = chip_smoke.tie_soup_arrays()
    return {"random": (mesh, o, d, tmax, shadow, dist), "ties": (tie_mesh, to, td, ttmax, tshadow, ttmax)}, {}


def _component_case(component_soups, which, c, mode, block, device):
    """(component build at C, packed rays padded to the block) of one soup."""
    soups, builds = component_soups
    mesh, o, d, tmax, shadow, dist = soups[which]
    if (which, c) not in builds:
        builds[(which, c)] = tf2.build_fused2(*mesh[:2], c, *mesh[2:], mxu=False, device="cpu")
    fb = builds[(which, c)].to(device)
    args = [torch.as_tensor(x, device=device) for x in (o, d, dist if mode == "mixed" else tmax)]
    o_p, d_p, t_p, n = tf2._pad_rays(*args, block)
    sh = None
    if mode == "mixed":
        sh = torch.as_tensor(shadow, device=device)
        sh = torch.cat([sh, sh.new_zeros(o_p.shape[0] - n)])
    return fb, tf2.pack_rays(o_p, d_p, t_p, sh)


@pytest.mark.parametrize("max_steps", [tf2.MAX_STEPS, 1], ids=["max_steps", "max_steps_1"])
@pytest.mark.parametrize("c", [8, 60, 64, 512, 1024, 2560])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kernel", list(COMPONENT_MODES))
@pytest.mark.parametrize("which", ["random", "ties"])
def test_component_entry_equals_the_serial_body(component_soups, cuda_device, which, kernel, block, c, max_steps):
    """The slot-parallel body equals the serial body (its entry for K1 and
    K3, the profile entry's serial body for K2 and K4) bit for bit in every
    column of every row: t/u/v, tri, hit, resolved, steps, winner cluster
    and slot, the attribute blob.  C=64 puts the tie soup's copies in one
    cluster on both sides of the slot halves; C=512 splits a cluster's slots
    over a thread block cluster of CTAs (any-hit: one CTA); C=1024 gives
    any-hit's one CTA more 32-slot chunks than warps, and C=2560 does that
    in every CTA of every mode's thread block cluster (any-hit's too, with
    the OR of its CTAs' flags)."""
    mode, attrs = COMPONENT_MODES[kernel]
    fb, rays = _component_case(component_soups, which, c, mode, block, cuda_device)
    entry = tf2._entry(fb, mode, attrs)
    launches = tf2.LAUNCHES[entry]
    got = tf2.fused2_traverse_packed(rays, fb, block=block, max_steps=max_steps, mode=mode, with_attrs=attrs)
    assert tf2.LAUNCHES[entry] == launches + 1
    serial, _ = tf2.fused2_traverse_profile(rays, fb, block, max_steps, mode=mode, with_attrs=attrs, serial=True)
    torch.cuda.synchronize()
    assert chip_smoke.differing_columns(got, serial) == {}
    if kernel in ("K1", "K3"):
        yardstick = tf2.fused2_traverse_packed(rays, fb, block=block, max_steps=max_steps, mode=mode, serial=True)
        assert chip_smoke.differing_columns(yardstick, serial) == {}
    if which == "ties" and c == 64 and max_steps > 1 and mode != "any_hit":
        tid = fb.planes[:, 9].long()
        (cid, lo), _ = torch.nonzero(tid >= 62).tolist()
        on_copy = (got[:, 7] == cid) & (got[:, 3] >= 62)
        assert int(on_copy.sum()) > 0 and (got[on_copy, 8] == lo).all()  # the lower slot wins the tie


@pytest.mark.parametrize("c, ctas, any_hit_ctas", [
    (8, 1, 1), (60, 1, 1), (512, 4, 1), (1024, 4, 1), (2048, 4, 1), (2080, 4, 4), (2560, 4, 4)])
def test_slot_body_launch_shape(cuda_device, c, ctas, any_hit_ctas):
    """512 threads per CTA; the 32-slot chunks split over up to 4 CTAs, at
    least 4 chunks each; any-hit keeps one CTA up to 2048 slots; every mode
    but any-hit orders its blocks."""
    tf2.build_kernels()
    for mode in tf2.MODES:
        want = any_hit_ctas if mode == "any_hit" else ctas
        assert tf2._slot_shape(c, mode) == (512, want, mode != "any_hit")
        assert frontier_row.slot_ctas(c, mode) == want  # the byte count's copy of the shape


# every fused2 entry by layout: (mode, with_attrs, serial, profile)
ROW_ENTRIES = {
    "component": [("closest", True, False, False), ("any_hit", False, False, False), ("mixed", True, False, False),
                  ("closest", False, False, False), ("closest", True, True, False), ("mixed", True, True, False),
                  ("closest", True, False, True), ("closest", True, True, True)],
    "mxu_f32": [("closest", True, False, False), ("any_hit", False, False, False), ("mixed", True, False, False),
                ("closest", False, False, False)],
    "mxu_bf16": [("closest", True, False, False), ("any_hit", False, False, False), ("mixed", True, False, False)],
}


@pytest.mark.parametrize("c", [8, 60, 64, 512, 1024, 2560])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("layout", list(ROW_ENTRIES))
def test_global_row_equals_shared_row(component_soups, cuda_device, layout, block, c):
    """Every fused2 entry with its blocks' frontier rows forced into device
    memory (the global form, through the private launch path; three
    launches) gives the shared form's outputs bit for bit in every column,
    at C where a slot-parallel block is a thread block cluster of 1 to 4
    CTAs that share one row in device memory (C 512, 1024, 2560); each
    form's resources report the library's count of its bytes, which is the
    Python count of tests/test_torch_frontier_row.py; where neither form
    fits (the MXU tensor-core ring at C=2560) the wrapper raises a
    ValueError naming K and the limit before any launch."""
    soups, builds = component_soups
    mesh, o, d, tmax, shadow, dist = soups["random"]
    key = (layout, c)
    if key not in builds:
        builds[key] = tf2.build_fused2(*mesh[:2], c, *mesh[2:], mxu=layout != "component", device="cpu",
                                       plane_dtype=torch.bfloat16 if layout == "mxu_bf16" else torch.float32)
    fb = builds[key].to(cuda_device)
    limit = tf2.smem_limit(cuda_device)
    for mode, attrs, serial, profile in ROW_ENTRIES[layout]:
        args = [torch.as_tensor(x, device=cuda_device) for x in (o, d, dist if mode == "mixed" else tmax)]
        o_p, d_p, t_p, n = tf2._pad_rays(*args, block)
        sh = torch.cat([torch.as_tensor(shadow, device=cuda_device), torch.zeros(o_p.shape[0] - n, dtype=torch.bool,
                                                                                 device=cuda_device)])
        rays = tf2.pack_rays(o_p, d_p, t_p, sh if mode == "mixed" else None)
        outs = {}
        for form in tf2.ROW_FORMS:
            nbytes = tf2.block_bytes(fb, mode, block, attrs, serial, form == "global")
            assert nbytes == frontier_row.block_bytes(fb.layout, mode, fb.num_clusters, c, block, serial,
                                                      form == "global")
            run = lambda: tf2._fused2_traverse_cuda(rays, fb, block, tf2.MAX_STEPS, mode, with_attrs=attrs,  # noqa
                                                    serial=serial, profile=profile, row=form)
            if nbytes > limit:
                with pytest.raises(ValueError, match=f"K={fb.num_clusters} .*{nbytes} bytes .*limit of {limit}"):
                    run()
                continue
            got = [run() for _ in range(3 if form == "global" else 1)]
            outs[form] = [x[0] for x in got] if profile else got
            if not profile:
                res = tf2.kernel_resources(fb, mode, block, attrs, serial, row=form)
                assert res["shared_bytes"] == nbytes and res["row"] == form
        torch.cuda.synchronize()
        if layout == "component" or c <= 1024:
            assert set(outs) == set(tf2.ROW_FORMS), (mode, attrs, serial)
        for form, got in outs.items():
            for other in got:
                assert chip_smoke.differing_columns(next(iter(outs.values()))[0], other) == {}, \
                    (form, mode, attrs, serial, profile)


def test_every_entry_above_the_old_cluster_limit(cuda_device):
    """Every fused2 entry renders a scene whose K is above its old shared-row
    limit (chip_smoke.py phase 4e: 480,000 random triangles in clusters of
    C=8, K about 81,000, 2048 rays in bundles of 256), and the outputs meet
    the plain version by the entry's usual rule; the serial yardsticks and
    the profile entry equal the slot-parallel body bit for bit."""
    results = {}
    chip_smoke.above_old_limit(cuda_device, results, 256)
    limits = results["limit"]["old_limits"]
    assert len(limits) == len(tf2._ENTRY) and all(results["limit"]["k"] > old for old in limits.values())


def test_four_ctas_share_one_row_above_the_old_limit(cuda_device):
    """K1, K3 and K4 at C=512 (a block of rays is a thread block cluster of
    4 CTAs sharing one frontier row in device memory) at K about 81,000,
    above their old limit of 49,052 (chip_smoke.py phase 4e: the limit soup's
    clusters widened by pad slots): on the bundles of three seeds, each of
    three launches equals the serial body at C=512 and the C=8 entry (one
    CTA, held to the plain version) bit for bit in every column."""
    results = {"limit": {}}
    mesh, _ = chip_smoke.limit_soup_arrays(256)
    comp = tf2.build_fused2(*mesh[:2], chip_smoke.LIMIT_C, *mesh[2:], mxu=False, device=cuda_device)
    assert comp.num_clusters > 49052
    chip_smoke.shared_rows(comp, results, 256)
    wide = results["limit"]["wide"]
    assert wide["ctas"] == 4 and wide["launches"] == 3 * 3 * len(chip_smoke.LIMIT_SEEDS)


@pytest.mark.parametrize("serial", [False, True], ids=["slot_parallel", "serial"])
@pytest.mark.parametrize("kernel", list(COMPONENT_MODES))
def test_profile_entry_adds_up_and_equals_the_plain_entry(component_soups, cuda_device, kernel, serial):
    """The profile entry's outputs equal its body's plain entry's bit for bit
    (the serial body's plain outputs: its entry for K1 and K3, else the slot
    body's, which equal them); per block its five phases add up to the
    total, none is negative, and the steps column is the block's retired
    clusters."""
    mode, attrs = COMPONENT_MODES[kernel]
    block = 256
    fb, rays = _component_case(component_soups, "random", 512, mode, block, cuda_device)
    launches = tf2.LAUNCHES[tf2.PROFILE_ENTRY]
    out, prof = tf2.fused2_traverse_profile(rays, fb, block, mode=mode, with_attrs=attrs, serial=serial)
    assert tf2.LAUNCHES[tf2.PROFILE_ENTRY] == launches + 1
    yardstick = serial and kernel in ("K1", "K3")
    plain = tf2.fused2_traverse_packed(rays, fb, block=block, mode=mode, with_attrs=attrs, serial=yardstick)
    torch.cuda.synchronize()
    assert chip_smoke.differing_columns(out, plain) == {}
    cols = tf2.PROFILE_COLS
    total = prof[:, cols.index("total")]
    assert prof.shape == (rays.shape[0] // block, len(cols))
    assert (prof[:, : cols.index("total")] >= 0).all() and (total > 0).all()
    assert torch.equal(prof[:, : cols.index("total")].sum(1), total)
    assert torch.equal(prof[:, cols.index("steps")], out[:, 6].reshape(-1, block)[:, 0].long())


@pytest.mark.parametrize("fused_nee", [False, True])
def test_nee_frame_on_card_matches_cpu(cuda_device, fused_nee):
    settings = RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3,
                              environment_auto=True, use_nee=True)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), env_map_path=None, device="cpu")
    accel = tf2.build_fused2_scene(scene, mxu=False)
    want, rays_want = render_image_wavefront(scene, settings, accel, lanes=1024, fused2_sort=True,
                                             fused_nee=fused_nee)
    img, rays = render_image_wavefront(scene.to(cuda_device), settings, accel.to(cuda_device),
                                       lanes=1024, fused2_sort=True, fused_nee=fused_nee)
    img, want = img.cpu().numpy(), want.numpy()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want


@pytest.fixture(scope="module")
def mxu_soups(soup):
    """The soup's clusters in the MXU feature layout, f32 and bf16 planes."""
    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(9000, dtype=np.int32).reshape(3000, 3)
    normals = r.normal(size=verts.shape).astype(np.float32)
    tc = r.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    mat = r.integers(0, 5, 3000).astype(np.int32)
    return {name: tf2.build_fused2(verts, idx, 64, normals, tc, mat, plane_dtype=dtype, device="cpu")
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}


@pytest.mark.parametrize("mode", ["closest", "any_hit", "mixed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block", [128, 256])
def test_mxu_kernel_matches_plain(soup, mxu_soups, cuda_device, block, dtype, mode):
    """K1b on the soup, tensor cores (bf16 products; f32 planes: 3xTF32)
    under the near-tie rule with the sums' rounding kind; any-hit flags
    equal; fanout 1 and 2 identical but for the steps column."""
    fb = mxu_soups[dtype].to(cuda_device)
    _, (o, d, tmax, dist, shadow) = _mixed_inputs(soup, cuda_device)
    t = dist if mode == "mixed" else tmax
    o_p, d_p, t_p, _ = tf2._pad_rays(o, d, t, block)
    sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - len(o))]) if mode == "mixed" else None
    rays = tf2.pack_rays(o_p, d_p, t_p, sh_p)
    name = tf2._entry(fb, mode, True)
    launches = tf2.LAUNCHES[name]
    got = {fo: tf2.fused2_traverse_packed(rays, fb, block=block, mode=mode, fanout=fo) for fo in (1, 2)}
    assert tf2.LAUNCHES[name] == launches + 2
    want = tf2.fused2_traverse_packed_plain(rays, fb, mode)
    torch.cuda.synchronize()
    keep = [c for c in range(32) if c != 6]
    torch.testing.assert_close(got[1][:, keep], got[2][:, keep], rtol=0, atol=0)
    got = got[2]
    assert (got[:, 5] == 1).all()
    if mode == "any_hit":
        torch.testing.assert_close(got[:, 4], want[:, 4], rtol=0, atol=0)
        return
    lanes = ~sh_p if mode == "mixed" else torch.ones_like(got[:, 0], dtype=torch.bool)
    chip_smoke.compare_near_tie(got[lanes], want[lanes], rays[lanes], fb, f"{name} soup", tensor=True)
    if mode == "mixed":
        torch.testing.assert_close(got[sh_p, 4], want[sh_p, 4], rtol=0, atol=0)


def test_f32_tensor_sums_within_gamma(soup, mxu_soups, cuda_device):
    """The f32 tensor-core feature sums (the diagnostic entry, the
    traversal's own staging and products) lie within SUM_GAMMA_F32 of the
    plain version's sums per unit of the sum of the terms' magnitudes, on
    every slot of each warp's cluster."""
    fb = mxu_soups["f32"].to(cuda_device)
    _, o, d, tmax = soup
    rays = tf2.pack_rays(*(torch.as_tensor(x, device=cuda_device) for x in (o, d, tmax)))
    want = tf2.fused2_traverse_packed_plain(rays, fb)
    worst, count = chip_smoke.tensor_sums_ratio(rays, want, fb, warps=rays.shape[0] // 32)
    assert count > 0 and 0.0 <= worst <= chip_smoke.SUM_GAMMA_F32


@pytest.mark.parametrize("mode", ["closest", "any_hit", "mixed"])
def test_bf16_tensor_kernel_ragged_cluster_size(soup, cuda_device, mode):
    """Clusters of C=60 slots (not a whole number of 8-slot n-tiles): the
    tensor-core entries stage the planes element by element with zero pad
    slots and hold to the same rule as at C=64."""
    _ragged_cluster_size(soup, cuda_device, mode, torch.bfloat16)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "mixed"])
def test_f32_tensor_kernel_ragged_cluster_size(soup, cuda_device, mode):
    """The same for the f32 tensor-core entries (3xTF32)."""
    _ragged_cluster_size(soup, cuda_device, mode, torch.float32)


def _ragged_cluster_size(soup, cuda_device, mode, dtype):
    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    fb = tf2.build_fused2(verts, np.arange(9000, dtype=np.int32).reshape(3000, 3), 60, plane_dtype=dtype,
                          device=cuda_device)
    assert fb.cluster_size == 60
    _, (o, d, tmax, dist, shadow) = _mixed_inputs(soup, cuda_device)
    t = dist if mode == "mixed" else tmax
    o_p, d_p, t_p, _ = tf2._pad_rays(o, d, t, 128)
    sh_p = torch.cat([shadow, shadow.new_zeros(o_p.shape[0] - len(o))]) if mode == "mixed" else None
    rays = tf2.pack_rays(o_p, d_p, t_p, sh_p)
    got = tf2.fused2_traverse_packed(rays, fb, block=128, mode=mode)
    want = tf2.fused2_traverse_packed_plain(rays, fb, mode)
    torch.cuda.synchronize()
    assert (got[:, 5] == 1).all()
    if mode == "any_hit":
        chip_smoke.compare_flags(got, want, "C=60 soup any-hit")
        return
    lanes = ~sh_p if mode == "mixed" else torch.ones_like(got[:, 0], dtype=torch.bool)
    chip_smoke.compare_near_tie(got[lanes], want[lanes], rays[lanes], fb, f"C=60 soup {mode}", tensor=True)
    if mode == "mixed":
        chip_smoke.compare_flags(got[sh_p], want[sh_p], "C=60 soup shadow lanes")


@pytest.fixture(scope="module")
def dragon_waves():
    """A dragon-like wave: the icosphere dragon at subdivision 5 on
    fused2-bf16, 4096 primary rays of a 64x64 frame and the bounce wave
    trace_bounce makes of them, and shadow rays from the bounce vertices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    size = 64
    scene = compile_scene(ASSETS, ensure_dragon(5), (size, size), device=dev)
    settings = RenderSettings(width=size, height=size, max_samples=1, max_path_depth=4, environment_auto=True)
    accel = make_accel(scene, "fused2-bf16")
    _, o, d, rng = wavefront._spawn(scene, settings, torch.arange(size * size, device=dev))
    n = o.shape[0]
    state = integrator.PathState(
        ray_o=o, ray_d=d, result=torch.zeros_like(o), throughput=torch.ones_like(o), rng=rng,
        alive=torch.ones(n, dtype=torch.bool, device=dev), prev_lobe=torch.full((n,), -1, dtype=torch.int64, device=dev),
        depth=torch.zeros(n, dtype=torch.int64, device=dev), prev_pdf=torch.zeros(n, device=dev),
    )
    isect, _ = integrator.make_intersectors(scene, accel)
    bounce = integrator.trace_bounce(scene, settings, state, isect, False)
    bounce_o = torch.where(bounce.alive[:, None], bounce.ray_o, wavefront.PARK)
    r = np.random.default_rng(3)
    target = torch.as_tensor(r.uniform(-2, 2, (n, 3)).astype(np.float32), device=dev)
    sh_d = torch.nn.functional.normalize(target - bounce_o, dim=-1)
    sh_t = torch.linalg.norm(target - bounce_o, dim=-1)
    return accel, {"primary": (o, d), "bounce": (bounce_o, bounce.ray_d)}, (bounce_o, sh_d, sh_t)


@pytest.fixture(scope="module")
def dragon_f32(dragon_waves):
    """dragon_waves' scene on fused2 (f32 planes)."""
    dev = torch.device("cuda")
    return make_accel(compile_scene(ASSETS, ensure_dragon(5), (64, 64), device=dev), "fused2")


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_f32_tensor_kernel_on_dragon_wave(dragon_waves, dragon_f32, block, wave):
    """K1b f32 (tensor cores, 3xTF32) closest hit on a sorted dragon wave
    under the near-tie rule with the sums' rounding kind (SUM_GAMMA_F32;
    explained rows at most 0.5%, rounded up); fanout 1 and 2 bit for bit."""
    _, waves, _ = dragon_waves
    o, d = waves[wave]
    t = torch.full((o.shape[0],), 1e10, device=o.device)
    rays, _ = chip_smoke.sorted_rays(o, d, t, dragon_f32, "morton")
    want = tf2.fused2_traverse_packed_plain(rays, dragon_f32)
    got = tf2.fused2_traverse_packed(rays, dragon_f32, block=block)
    chip_smoke.compare_near_tie(got, want, rays, dragon_f32, f"dragon {wave} f32", tensor=True)
    assert chip_smoke.same_outputs(tf2.fused2_traverse_packed(rays, dragon_f32, block=block, fanout=1), got)


@pytest.mark.parametrize("block", [128, 256])
def test_f32_tensor_any_hit_and_mixed_on_dragon_wave(dragon_waves, dragon_f32, block):
    """K1b f32 (tensor cores) any-hit on the shadow rays and the mixed sweep
    (closest-hit lanes under the rule with the sums' rounding kind); a flag
    that differs must be decided within the sums' rounding
    (``compare_flags`` with the rays): the fixture's dead lanes shoot shadow
    rays from the park point at 1e8, whose features' terms are ~1e8 and
    whose window sums cancel to far less, and a block tests them against
    every cluster it retires (measured: 4 flags of 4096 differ at block 128,
    132 at block 256); every differing flag is on such a ray."""
    _any_hit_and_mixed(dragon_waves, dragon_f32, block, tensor_flags=True)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("wave", ["primary", "bounce"])
def test_bf16_tensor_kernel_on_dragon_wave(dragon_waves, block, wave):
    """K1b bf16 (tensor cores) closest hit on a sorted dragon wave under the
    near-tie rule with the sums' rounding kind (explained rows at most 0.5%,
    rounded up)."""
    accel, waves, _ = dragon_waves
    o, d = waves[wave]
    t = torch.full((o.shape[0],), 1e10, device=o.device)
    rays, _ = chip_smoke.sorted_rays(o, d, t, accel, "morton")
    want = tf2.fused2_traverse_packed_plain(rays, accel)
    got = tf2.fused2_traverse_packed(rays, accel, block=block)
    chip_smoke.compare_near_tie(got, want, rays, accel, f"dragon {wave}", tensor=True)


@pytest.mark.parametrize("block", [128, 256])
def test_bf16_tensor_any_hit_and_mixed_on_dragon_wave(dragon_waves, block):
    """K1b bf16 (tensor cores) any-hit on the shadow rays (flags at least
    99.99% equal) and the mixed sweep of bounce and shadow rays (closest-hit
    lanes under the rule with the sums' rounding kind, shadow flags likewise)."""
    _any_hit_and_mixed(dragon_waves, dragon_waves[0], block)


def _any_hit_and_mixed(dragon_waves, accel, block, tensor_flags=False):
    _, waves, (sh_o, sh_d, sh_t) = dragon_waves
    rays, _ = chip_smoke.sorted_rays(sh_o, sh_d, sh_t, accel, "morton")
    got = tf2.fused2_traverse_packed(rays, accel, block=block, mode="any_hit")
    want = tf2.fused2_traverse_packed_plain(rays, accel, "any_hit")
    assert (got[:, 5] == 1).all() and 0 < int(want[:, 4].sum()) < rays.shape[0]
    rule = dict(rays=rays, fb=accel) if tensor_flags else {}
    chip_smoke.compare_flags(got, want, "dragon shadow wave", **rule)
    if tensor_flags:
        assert (rays[got[:, 4] != want[:, 4], 0:3] == wavefront.PARK).all()
    bo, bd = waves["bounce"]
    co, cd = torch.cat([bo, sh_o]), torch.cat([bd, sh_d])
    ct = torch.cat([torch.full((bo.shape[0],), 1e10, device=bo.device), sh_t])
    csh = torch.cat([torch.zeros_like(sh_t, dtype=torch.bool), torch.ones_like(sh_t, dtype=torch.bool)])
    rays, perm = chip_smoke.sorted_rays(co, cd, ct, accel, "morton", shadow=csh)
    sh = csh[perm]
    got = tf2.fused2_traverse_packed(rays, accel, block=block, mode="mixed")
    want = tf2.fused2_traverse_packed_plain(rays, accel, "mixed")
    chip_smoke.compare_near_tie(got[~sh], want[~sh], rays[~sh], accel, "dragon mixed wave", tensor=True)
    rule = dict(rays=rays[sh], fb=accel) if tensor_flags else {}
    chip_smoke.compare_flags(got[sh], want[sh], "dragon mixed wave shadow lanes", **rule)
    if tensor_flags:
        assert (rays[sh][got[sh, 4] != want[sh, 4], 0:3] == wavefront.PARK).all()


def test_no_attrs_kernel_matches_plain(soup, mxu_soups, cuda_device):
    """K4 on component planes: loop t/u/v and the in-plane tri id, a zero
    blob, counted under its own entry; bf16 planes refuse it."""
    fb = soup[0].to(cuda_device)
    _, o, d, tmax = soup
    args = [torch.as_tensor(x[:300], device=cuda_device) for x in (o, d, tmax)]
    rays = tf2.pack_rays(*tf2._pad_rays(*args, 128)[:3])
    name = tf2._entry(fb, "closest", False)
    launches = tf2.LAUNCHES[name]
    got = tf2.fused2_traverse_packed(rays, fb, block=128, with_attrs=False)
    assert tf2.LAUNCHES[name] == launches + 1
    want = tf2.fused2_traverse_packed_plain(rays, fb, with_attrs=False)
    torch.cuda.synchronize()
    assert_kernel_output_matches(got, want)
    assert (got[:, 16:32] == 0).all()
    with pytest.raises(ValueError, match="with_attrs"):
        tf2.fused2_traverse_packed(rays, mxu_soups["bf16"].to(cuda_device), block=128, with_attrs=False)


@pytest.mark.parametrize("block", [128, 256])
def test_no_attrs_tensor_kernel_matches_plain(soup, mxu_soups, cuda_device, block):
    """K4 on f32 MXU planes on the tensor cores (3xTF32): winners under the
    near-tie rule with the sums' rounding kind, the loop t/u/v within the
    sums' rounding of the plain version's, a zero blob; fanout 1 and 2
    identical."""
    fb = mxu_soups["f32"].to(cuda_device)
    _, o, d, tmax = soup
    args = [torch.as_tensor(x, device=cuda_device) for x in (o, d, tmax)]
    rays = tf2.pack_rays(*tf2._pad_rays(*args, block)[:3])
    name = "owlpt_fused2_mxu_closest_hit_noattr"
    launches = tf2.LAUNCHES[name]
    got = {fo: tf2.fused2_traverse_packed(rays, fb, block=block, with_attrs=False, fanout=fo) for fo in (1, 2)}
    assert tf2.LAUNCHES[name] == launches + 2
    want = tf2.fused2_traverse_packed_plain(rays, fb, with_attrs=False)
    torch.cuda.synchronize()
    keep = [c for c in range(32) if c != 6]
    assert torch.equal(got[1][:, keep], got[2][:, keep])
    got = got[2]
    assert (got[:, 16:32] == 0).all() and (got[:, 5] == 1).all()
    chip_smoke.compare_near_tie(got, want, rays, fb, "K4 f32 tensor soup", blob=False, tensor=True)


@pytest.mark.parametrize("kind", ["fused2", "fused2-bf16"])
def test_mxu_frame_on_card_matches_cpu(cuda_device, kind):
    settings = RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3,
                              environment_auto=True)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), device="cpu")
    accel = make_accel(scene, kind)
    want, rays_want = render_image_wavefront(scene, settings, accel, lanes=1024, fused2_sort=True)
    img, rays = render_image_wavefront(scene.to(cuda_device), settings, accel.to(cuda_device),
                                       lanes=1024, fused2_sort=True)
    img, want = img.cpu().numpy(), want.numpy()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want


@pytest.fixture(scope="module")
def fused_soup():
    """The soup's triangles as the fused kernel's clusters (C=64)."""
    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(9000, dtype=np.int32).reshape(3000, 3)
    return tfu.build_fused(tcl.build_clusters(verts, idx, 64, device="cpu"))


def _fused_soup_rays(soup, device, block, scalar):
    """The soup's first 300 rays padded to whole blocks as fused_closest_hit
    pads them (t_max T_MIN per ray, or the scalar)."""
    _, o, d, tmax = soup
    o, d, tmax = (torch.as_tensor(x[:300], device=device) for x in (o, d, tmax))
    pad = (-300) % block
    o = torch.cat([o, torch.zeros((pad, 3), device=device)])
    d = torch.cat([d, torch.tensor([0.0, 0.0, 1.0], device=device).expand(pad, 3)])
    t = 1e10 if scalar else torch.cat([tmax, torch.full((pad,), 1e-3, device=device)])
    return o, d, t


@pytest.mark.parametrize("scalar", [False, True], ids=["per_ray_tmax", "scalar_tmax"])
@pytest.mark.parametrize("block", [128, 256])
def test_fused_kernel_matches_plain(soup, fused_soup, cuda_device, block, scalar):
    """K5: columns 0-6 bit-equal to the plain version (same entries, picks
    and retirements; Moller-Trumbore in one op order without FMAs), with the
    wrapper's padding rays; each launch is counted under its entry."""
    fb = fused_soup.to(cuda_device)
    o, d, t = _fused_soup_rays(soup, cuda_device, block, scalar)
    launches = tfu.LAUNCHES[tfu.ENTRY]
    got = tfu.fused_traverse(o, d, t, fb, block)
    assert tfu.LAUNCHES == {tfu.ENTRY: launches + 1}
    want = tfu.fused_traverse_plain(o, d, t, fb, block)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :7], want[:, :7]) and (got[:, 7] == 0).all()
    assert (got[:, 5] == 1).all() and 0 < int(got[:300, 4].sum()) < 300


@pytest.mark.parametrize("max_steps", [0, 1, 3])
def test_fused_steps_cut_short_match_plain(soup, fused_soup, cuda_device, max_steps):
    """K5 at max_steps 0, 1 and 3 (rows left unresolved, steps capped):
    columns 0-6 bit-equal to the plain version, at blocks 128 and 256 with
    per-ray t_max."""
    fb = fused_soup.to(cuda_device)
    for block in (128, 256):
        o, d, t = _fused_soup_rays(soup, cuda_device, block, False)
        got = tfu.fused_traverse(o, d, t, fb, block, max_steps)
        want = tfu.fused_traverse_plain(o, d, t, fb, block, max_steps)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :7], want[:, :7])
        assert (got[:, 6] <= max_steps).all()
        if max_steps < 3:
            assert (got[:, 5] == 0).any()


def test_fused_block_with_no_active_ray(soup, fused_soup, cuda_device):
    """A block whose rays enter no box (every ray from far above, straight
    up) between two live blocks: it retires nothing (steps 0, every row
    resolved, no hit) while the others run, equal to the plain version."""
    fb = fused_soup.to(cuda_device)
    o, d, t = _fused_soup_rays(soup, cuda_device, 128, False)
    o, d, t = o[:256].clone(), d[:256].clone(), t[:256].clone()
    o[128:256] = torch.tensor([0.0, 0.0, 100.0], device=cuda_device)
    d[128:256] = torch.tensor([0.0, 0.0, 1.0], device=cuda_device)
    o, d, t = torch.cat([o, o[:128]]), torch.cat([d, d[:128]]), torch.cat([t, t[:128]])
    got = tfu.fused_traverse(o, d, t, fb, 128)
    want = tfu.fused_traverse_plain(o, d, t, fb, 128)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :7], want[:, :7])
    idle = got[128:256]
    assert (idle[:, 6] == 0).all() and (idle[:, 5] == 1).all() and (idle[:, 4] == 0).all()
    assert (got[:128, 6] > 0).all() and (got[256:, 6] > 0).all()


def test_fused_heavy_blocks_first(soup, cuda_device):
    """K5's pre-pass and order, on the soup's triangles in clusters of C=8
    (16 group boxes) with t_max growing block by block: the profile's
    weight per block equals block_weights, its launch ranks are a
    permutation of the blocks in block_order's order (heaviest first, ties
    in block order), and the outputs equal the plain version's."""
    r = np.random.default_rng(0)
    tri = r.uniform(-4, 4, (3000, 1, 3)) + r.normal(0, 0.4, (3000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    fb = tfu.build_fused(tcl.build_clusters(verts, np.arange(9000, dtype=np.int32).reshape(3000, 3), 8,
                                            device=cuda_device))
    assert fb.groups.shape[1] > 8
    _, o, d, _ = soup
    n = o.shape[0] // 32 * 32
    o, d = (torch.as_tensor(x[:n], device=cuda_device) for x in (o, d))
    # t_max grows block by block, so the blocks enter more and more group boxes
    tmax = torch.linspace(0.25, 6.0, n // 32, device=cuda_device).repeat_interleave(32)
    out, prof, _ = tfu.fused_traverse_profile(o, d, tmax, fb, 32)
    assert torch.equal(out[:, :7], tfu.fused_traverse_plain(o, d, tmax, fb, 32)[:, :7])
    weights = tfu.block_weights(o, d, tmax, fb, 32)
    rank, weight = prof[:, 6], prof[:, 7]
    assert torch.equal(weight, weights) and weights.unique().numel() > 2
    order = tfu.block_order(weights)
    assert torch.equal(torch.sort(rank).values, torch.arange(n // 32, device=cuda_device))
    assert torch.equal(order[rank], torch.arange(n // 32, device=cuda_device))


def test_fused_overflow_matches_cpu(soup, fused_soup, cuda_device):
    """max_steps=3 leaves rows unresolved; the wrapper answers them with the
    exact cluster query, equal to the CPU wrapper's answers."""
    _, o, d, tmax = soup
    args = [torch.as_tensor(x) for x in (o, d, tmax)]
    cuda = [x.to(cuda_device) for x in args]
    launches = tfu.LAUNCHES[tfu.ENTRY]
    raw = tfu.fused_traverse(*[x[:384] for x in cuda], fused_soup.to(cuda_device), 128, 3)
    assert (raw[:, 5] == 0).any() and tfu.LAUNCHES[tfu.ENTRY] == launches + 1
    got = tfu.fused_closest_hit(cuda[0], cuda[1], fused_soup.to(cuda_device), t_max=cuda[2], max_steps=3)
    want = tfu.fused_closest_hit(args[0], args[1], fused_soup, t_max=args[2], max_steps=3)
    assert torch.equal(got.tri.cpu(), want.tri) and torch.equal(got.t.cpu(), want.t)
    assert torch.equal(got.uv.cpu(), want.uv)


def test_fused_kernel_above_old_cluster_limit(cuda_device):
    """K5 reads the box rows from device memory and keeps one retired bit per
    cluster: 80,000 random triangles in clusters of C=8 give K above the
    9,280 clusters that one block's shared memory held at C=8 when the boxes
    lived there (K = 13,568), and columns 0-6 equal the plain version's on
    2048 rays, of which about half run out of steps (unresolved)."""
    r = np.random.default_rng(4)
    tri = r.uniform(-20, 20, (80000, 1, 3)) + r.normal(0, 0.3, (80000, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(240000, dtype=np.int32).reshape(80000, 3)
    fb = tfu.build_fused(tcl.build_clusters(verts, idx, 8, device=cuda_device))
    assert fb.num_clusters > 9500
    n = 2048
    o = torch.as_tensor(r.uniform(-25, 25, (n, 3)).astype(np.float32), device=cuda_device)
    d = torch.nn.functional.normalize(torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32), device=cuda_device),
                                      dim=-1)
    got = tfu.fused_traverse(o, d, 1e10, fb)
    want = tfu.fused_traverse_plain(o, d, 1e10, fb)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :7], want[:, :7])  # resolved (col 5) and steps (col 6) too
    assert 0 < int(got[:, 4].sum()) < n and 0 < int(got[:, 5].sum()) < n


@pytest.fixture(scope="module")
def rescan_scene():
    """Many small clusters along every ray: 80,000 small random triangles in
    a 2 x 2 x 40 column, in clusters of C=8 (K = 13,568, above the old
    cluster limit), and 16 blocks of 128 nearly parallel rays down the
    column, each block a narrow bundle; the plain version's outputs.  A ray
    enters ~46 boxes before its hit (measured on the CPU), so it uses up
    its list of KCAND entries several times; the blocks take 300-460 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    r = np.random.default_rng(4)
    n_t, length = 80000, 20
    base = np.stack([r.uniform(-1, 1, n_t), r.uniform(-1, 1, n_t), r.uniform(-length, length, n_t)], -1)[:, None]
    verts = (base + r.normal(0, 0.012, (n_t, 3, 3))).reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n_t, dtype=np.int32).reshape(n_t, 3)
    fb = tfu.build_fused(tcl.build_clusters(verts, idx, 8, device=dev))
    n = 2048
    centre = np.repeat(r.uniform(-0.8, 0.8, (n // 128, 2)), 128, 0)
    o = np.concatenate([centre + r.normal(0, 0.01, (n, 2)), np.full((n, 1), -length - 2.0)], 1)
    d = np.array([0.0, 0.0, 1.0]) + r.normal(0, 0.002, (n, 3))
    o = torch.as_tensor(o.astype(np.float32), device=dev)
    d = torch.nn.functional.normalize(torch.as_tensor(d.astype(np.float32), device=dev), dim=-1)
    return fb, o, d, tfu.fused_traverse_plain(o, d, 1e10, fb, max_steps=RESCAN_STEPS)


RESCAN_STEPS = 1024


def test_fused_scan_kinds_match_plain_with_rescans(rescan_scene):
    """K5 where rays rescan several times: columns 0-6 (steps and resolved
    too) bit-equal to the plain version; the profile entry gives the same
    outputs and steps, and its group skips slab-test fewer boxes than a
    scan of every box does in its set-up scans alone (K per ray)."""
    fb, o, d, want = rescan_scene
    assert fb.num_clusters > 9500
    got = tfu.fused_traverse(o, d, 1e10, fb, max_steps=RESCAN_STEPS)
    assert torch.equal(got[:, :7], want[:, :7])
    assert 0 < int(got[:, 4].sum()) and (got[:, 5] == 1).all()
    out, prof, counts = tfu.fused_traverse_profile(o, d, 1e10, fb, max_steps=RESCAN_STEPS)
    assert torch.equal(out[:, :7], got[:, :7])
    assert float(counts[:, 0].float().mean()) > 2.0, "several rescans per ray"
    assert (prof[:, 4] > 0).all() and torch.equal(prof[:, 5].float(), got.view(-1, tfu.BLOCK_RAYS, 8)[:, 0, 6])
    assert int(counts[:, 1].sum()) < fb.num_clusters * o.shape[0]


def test_fused_group_entered_with_no_member_entered(cuda_device):
    """chip_smoke.corner_groups: every ray enters group 0's box and none of
    its members; K5 gives the plain version's columns 0-6 (a hit on cluster
    32 at t = 4), and the group-skip set-up scan tests the plain list scan's
    boxes."""
    fb, o, d = chip_smoke.corner_groups(cuda_device)
    got = tfu.fused_traverse(o, d, 1e10, fb)
    want = tfu.fused_traverse_plain(o, d, 1e10, fb)
    assert torch.equal(got[:, :7], want[:, :7]) and (got[:, 0] == 4.0).all() and (got[:, 3] == 32).all()
    _, _, counts = tfu.fused_traverse_profile(o, d, 1e10, fb, max_steps=0)
    assert torch.equal(counts[:, 1].long(), tfu.nearest_lists(o, d, 1e10, fb, groups=True)[2])


@pytest.mark.parametrize("kind", ["fused2", "component"])
def test_wavefront_film_is_deterministic(cuda_device, kind):
    """The same frame rendered twice on the card banks the same film bit
    for bit (many lanes of one step bank into one pixel)."""
    settings = RenderSettings(width=32, height=32, max_samples=8, max_path_depth=3, environment_auto=True)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), device=cuda_device)
    accel = make_accel(scene, "fused2") if kind == "fused2" else tf2.build_fused2_scene(scene, mxu=False)
    (a, rays_a), (b, rays_b) = (render_image_wavefront(scene, settings, accel, lanes=1024, fused2_sort=True)
                                for _ in range(2))
    assert rays_a == rays_b and torch.equal(a, b)


@pytest.mark.parametrize("use_nee", [False, True])
def test_fused_scan_frame_on_card_matches_cpu(cuda_device, use_nee):
    settings = RenderSettings(width=32, height=32, max_samples=2, max_path_depth=3, environment_auto=True,
                              use_nee=use_nee)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), env_map_path=None, device="cpu")
    accel = make_accel(scene, "fused")
    want = tfilm.add_samples(scene, settings, tfilm.new_film(settings, device="cpu"), 2, pixel_chunk=1024,
                             accel=accel)
    got = tfilm.add_samples(scene.to(cuda_device), settings, tfilm.new_film(settings, device=cuda_device), 2,
                            pixel_chunk=1024, accel=accel.to(cuda_device))
    img, ref = tfilm.finalize(got).cpu().numpy(), tfilm.finalize(want).numpy()
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=1e-3)
    assert abs(got.rays_traced - want.rays_traced) <= 0.005 * want.rays_traced


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("name", [*tlp.VARIANTS, "interleave2", "interleave4"])
def test_latency_probe_matches_plain(soup, mxu_soups, cuda_device, name, block, monkeypatch):
    """K6's exact form (exact=True, the CUDA-core yardstick) on the soup's
    MXU clusters (C=64): column 0 bit-equal to the plain version (rtol 1e-6
    for the approximate reciprocal), columns 1-15 zero; copies in tiles of 8
    slots (a device with just the shared memory for them) change nothing."""
    _, o, d, tmax = soup
    v = tlp.variant(name)
    fb = mxu_soups["bf16" if v.bf16 else "f32"].to(cuda_device)
    rays = tf2.pack_rays(*(torch.as_tensor(x[:256], device=cuda_device) for x in (o, d, tmax)))
    small = tlp.shared_bytes(fb.boxes.shape[1], v.chains, block, tlp.TILE_ALIGN, v.bf16)
    for it in (0, 3, 8):
        launches = tlp.LAUNCHES[tlp.EXACT_ENTRY]
        got = tlp.latency_probe(rays, fb.boxes, fb.planes, name, it, block, exact=True)
        with monkeypatch.context() as mp:
            mp.setattr(tlp, "smem_limit", lambda device: small)
            assert tlp.kernel_tile(rays, fb.boxes, fb.planes, name, block, exact=True) == tlp.TILE_ALIGN
            tiled = tlp.latency_probe(rays, fb.boxes, fb.planes, name, it, block, exact=True)
        assert tlp.LAUNCHES[tlp.EXACT_ENTRY] == launches + 2
        want = tlp.latency_probe_plain(rays, fb.boxes, fb.planes, name, it, block)
        torch.cuda.synchronize()
        assert (got[..., 1:] == 0).all() and torch.equal(tiled, got)
        if v.recip:
            torch.testing.assert_close(got[..., 0], want[..., 0], rtol=1e-6, atol=0)
        else:
            assert torch.equal(got[..., 0], want[..., 0]), f"{name} iters {it}"
        if v.pick and v.mm and it == 8:
            assert (got[..., 0] < rays[:, 6].view(got.shape[:2])).any()


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("name", [*tlp.VARIANTS, "interleave2", "interleave4"])
def test_latency_probe_tensor_form_matches_plain(soup, mxu_soups, cuda_device, name, block, monkeypatch):
    """K6's tensor form (the default; the product on the tensor cores as K1b
    runs it) on the soup's MXU clusters (C=64): columns 1-15 zero, column 0
    within the sums' rounding of the plain version's
    (chip_smoke.compare_probe_tensor), equal where the product reads no
    planes; copies in tiles of 8 slots give the same bits."""
    _, o, d, tmax = soup
    v = tlp.variant(name)
    fb = mxu_soups["bf16" if v.bf16 else "f32"].to(cuda_device)
    rays = tf2.pack_rays(*(torch.as_tensor(x[:256], device=cuda_device) for x in (o, d, tmax)))
    small = tlp.shared_bytes(fb.boxes.shape[1], v.chains, block, tlp.TILE_ALIGN, v.bf16, v.mm)
    for it in (0, 3, 8):
        launches = tlp.LAUNCHES[tlp.ENTRY]
        got = tlp.latency_probe(rays, fb.boxes, fb.planes, name, it, block)
        with monkeypatch.context() as mp:
            mp.setattr(tlp, "smem_limit", lambda device: small)
            assert tlp.kernel_tile(rays, fb.boxes, fb.planes, name, block) == tlp.TILE_ALIGN
            tiled = tlp.latency_probe(rays, fb.boxes, fb.planes, name, it, block)
        assert tlp.LAUNCHES[tlp.ENTRY] == launches + 2
        want = tlp.latency_probe_plain(rays, fb.boxes, fb.planes, name, it, block)
        torch.cuda.synchronize()
        assert torch.equal(tiled, got)
        chip_smoke.compare_probe_tensor(got, want, rays, fb.boxes, fb.planes, name, it, block,
                                        f"{name} iters {it}")
        if v.pick and v.mm and it == 8:
            assert (got[..., 0] < rays[:, 6].view(got.shape[:2])).any()


def test_latency_probe_shared_memory(cuda_device):
    """The wrapper's count of a block's bytes is the kernel source's, for
    the exact form's whole planes and the tensor form's staging (K1b's ring
    buffers: bf16 10 rows of 4C, f32 the 19 non-zero rows, and a zero row);
    interleave4 on f32 planes at C=512 gets tiles of 128 slots in the exact
    form and whole clusters in the tensor form."""
    tlp.build_kernels()
    for args in ((768, 1, 256, 512, False), (768, 4, 256, 128, False), (300, 2, 128, 64, True),
                 (768, 4, 256, 512, False), (768, 16, 256, 64, True), (300, 2, 128, 8, False)):
        k, p, b, tile, bf16 = args
        for tensor in (False, True):
            assert tlp.shared_bytes(*args, tensor) == tlp._cuda_lib.owlpt_latency_probe_shared_bytes(
                k, p, b, tile, 2 if bf16 else 4, int(tensor))
    assert tlp.shared_bytes(768, 1, 256, 512, True, True) - tlp.shared_bytes(768, 1, 256, 512, True) == \
        10 * (8 * 512 + 16) + 16 - 16 * 4 * 512 * 2
    limit = tlp.smem_limit(cuda_device)
    assert limit >= 227 * 1024 and tlp.tile_cols(512, 768, 4, 256, False, limit) == 128
    assert tlp.tile_cols(512, 768, 4, 256, False, limit, tensor=True) == 512


def test_resume_on_card_gives_the_uninterrupted_frame(cuda_device, tmp_path):
    """A frame stopped after two launches (a drained checkpoint after each)
    and resumed traces the uninterrupted frame's rays (component layout:
    the kernel's winners do not depend on the rays beside them)."""
    settings = RenderSettings(width=32, height=32, max_samples=2, max_path_depth=4, environment_auto=True)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), device=cuda_device)
    accel = tf2.build_fused2_scene(scene, mxu=False)
    kw = dict(lanes=512, fused2_sort=True, iters_per_launch=2)
    want, rays_want = render_image_wavefront(scene, settings, accel, **kw)
    ck = str(tmp_path / "frame.ck")
    render_image_wavefront(scene, settings, accel, checkpoint_path=ck, checkpoint_every_s=0.0, max_launches=2, **kw)
    img, rays = render_image_wavefront(scene, settings, accel, checkpoint_path=ck, **kw)
    assert rays == rays_want
    img, want = img.cpu().numpy(), want.cpu().numpy()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


# ── the gradient path (render/diff.py) on the card ──


def _grad_settings(**kw):
    return RenderSettings(width=16, height=16, max_samples=2, max_path_depth=3, environment_color=(1.0, 0.9, 0.8),
                          environment_intensity=1.0, **kw)


@pytest.mark.parametrize("kind", ["fused2", "fused2-bf16"])
def test_material_gradients_card_vs_cpu(cuda_device, kind):
    """Material gradients through K1b (f32 and bf16 planes, under autograd)
    against the same call on CPU tensors (the plain version): chip_smoke's
    rule (phase 5g), every wave held to the plain version first."""
    import torch

    from owl_path_tracer_tpu_torch.render import diff

    sphere = chip_smoke.grad_sphere()
    settings = _grad_settings()
    px = tfilm._pixel_grid(16, 16, "cpu")

    def fn(scene, accel, px):
        return diff.loss_and_grad(scene, scene.materials, settings, px, torch.zeros((px.shape[0], 3), device=px.device),
                                  2, accel)

    s64 = chip_smoke.float64(sphere.to(cuda_device))
    counts, worst = chip_smoke.grads_card_vs_cpu(cuda_device, f"sphere materials, {kind}", fn, sphere,
                                                 make_accel(sphere, kind), px, exact=lambda p: fn(s64, None, p))
    entry = "owlpt_fused2_mxu_closest_hit" if kind == "fused2" else "owlpt_fused2_mxu_bf16_closest_hit"
    assert counts.get(entry, 0) > 0 and worst <= 1.0


@pytest.mark.parametrize("kind", ["fused2", "fused2-bf16"])
def test_camera_gradients_card_vs_cpu(cuda_device, kind):
    """Camera gradients through the refit of K1b's winners (the radius-2
    sphere fills the view), card vs CPU."""
    import torch

    from owl_path_tracer_tpu_torch.render import diff

    big = chip_smoke.grad_sphere(radius=2.0)
    settings = _grad_settings(environment_auto=True)
    px = tfilm._pixel_grid(16, 16, "cpu")

    def fn(scene, accel, px):
        return diff.camera_loss_and_grad(scene, scene.camera, settings, px,
                                         torch.zeros((px.shape[0], 3), device=px.device), 2, accel)

    b64 = chip_smoke.float64(big.to(cuda_device))
    counts, worst = chip_smoke.grads_card_vs_cpu(cuda_device, f"sphere camera, {kind}", fn, big,
                                                 make_accel(big, kind), px, exact=lambda p: fn(b64, None, p))
    assert sum(counts.values()) > 0 and worst <= 1.0


def test_brute_equals_cluster_on_the_card(cuda_device):
    """The brute sweep and the cluster query (both plain PyTorch) give the
    same hits, flags and frame bit for bit on the card."""
    import torch

    from owl_path_tracer_tpu_torch.ops.intersect import any_hit_brute, closest_hit_brute

    scene = compile_scene(ASSETS, "cornell-box", (24, 24), device=cuda_device)
    cb = make_accel(scene, "cluster", cluster_size=64)
    gen = torch.Generator(device="cpu").manual_seed(1)
    lo, hi = scene.vertices.min(0).values, scene.vertices.max(0).values
    o = lo + torch.rand((4096, 3), generator=gen).to(cuda_device) * (hi - lo)
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen), dim=-1).to(cuda_device)
    got, want = closest_hit_brute(o, d, scene.vertices, scene.tri_idx), tcl.cluster_closest_hit(o, d, cb)
    assert (got.tri >= 0).sum() > 1000
    assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t) and torch.equal(got.uv, want.uv)
    tmax = torch.full((4096,), 0.7, device=cuda_device)
    assert torch.equal(any_hit_brute(o, d, scene.vertices, scene.tri_idx, t_max=tmax),
                       tcl.cluster_occluded(o, d, cb, t_max=tmax))
    settings = RenderSettings(width=24, height=24, max_samples=2, max_path_depth=3, environment_auto=True)
    assert torch.equal(tfilm.render_image(scene, settings, intersector="brute"),
                       tfilm.render_image(scene, settings, accel=cb))


def test_bvh_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """The per-ray-stack BVH (plain PyTorch) on the card: hits, flags and a
    frame bit for bit equal to the same calls on the CPU, and to the
    cluster query on the card."""
    from owl_path_tracer_tpu_torch.ops import traverse

    scene = compile_scene(ASSETS, "cornell-box", (24, 24), device="cpu")
    bvh = tfilm.build_scene_bvh(scene, cache_dir=tmp_path)
    gen = torch.Generator(device="cpu").manual_seed(2)
    lo, hi = scene.vertices.min(0).values, scene.vertices.max(0).values
    o = lo + torch.rand((4096, 3), generator=gen) * (hi - lo)
    d = torch.nn.functional.normalize(torch.randn((4096, 3), generator=gen), dim=-1)
    tmax = torch.full((4096,), 0.7)
    want, want_occ = traverse.bvh_closest_hit(o, d, bvh), traverse.bvh_occluded(o, d, bvh, t_max=tmax)
    card = bvh.to(cuda_device)
    got = traverse.bvh_closest_hit(o.to(cuda_device), d.to(cuda_device), card)
    assert (want.tri >= 0).sum() > 1000
    for field in ("tri", "t", "uv"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    assert torch.equal(traverse.bvh_occluded(o.to(cuda_device), d.to(cuda_device), card,
                                             t_max=tmax.to(cuda_device)).cpu(), want_occ)
    cb = tcl.cluster_closest_hit(o.to(cuda_device), d.to(cuda_device),
                                 make_accel(scene.to(cuda_device), "cluster", cluster_size=64))
    assert torch.equal(got.tri, cb.tri) and torch.equal(got.t, cb.t)
    settings = RenderSettings(width=24, height=24, max_samples=2, max_path_depth=3, environment_auto=True)
    img = tfilm.render_image(scene.to(cuda_device), settings, accel=card)
    chip_smoke.golden(img.cpu(), tfilm.render_image(scene, settings, accel=bvh), 0, 0, "bvh frame, card vs CPU")


def test_sharded_wavefront_over_nccl_equals_unsharded(cuda_device, tmp_path):
    """World size 1 through an initialised NCCL group: the sharded wavefront
    frame (both work splits) equals render_image_wavefront's bit for bit on
    fused2-bf16 (K1b launched), and the sharded scan frame render_image's."""
    import dataclasses

    from owl_path_tracer_tpu_torch.parallel import shard

    scene = compile_scene(ASSETS, "cornell-box", (32, 32), device=cuda_device)
    accel = make_accel(scene, "fused2-bf16")
    settings = RenderSettings(width=32, height=32, max_samples=4, max_path_depth=3, environment_auto=True)
    mesh = shard.make_pixel_mesh(cuda_device, init_method=(tmp_path / "store").as_uri(), rank=0, world_size=1)
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        want, rays_want = render_image_wavefront(scene, settings, accel, lanes=4096, fused2_sort=True)
        for split in ("sample", "contiguous"):
            tf2.reset_counts()
            img, rays, stats = shard.render_image_wavefront_sharded(
                scene, settings, mesh=mesh, accel=accel, lanes_per_chip=4096, fused2_sort=True, work_split=split,
                return_stats=True)
            assert tf2.LAUNCHES["owlpt_fused2_mxu_bf16_closest_hit"] > 0
            assert torch.equal(img, want) and rays == rays_want and stats["per_chip_rays"] == [rays]
        cb = make_accel(scene, "cluster", cluster_size=64)
        scan = shard.render_image_sharded(scene, dataclasses.replace(settings, max_samples=2), mesh=mesh, accel=cb)
        assert torch.equal(scan, tfilm.render_image(scene, dataclasses.replace(settings, max_samples=2), accel=cb))
    finally:
        mesh.close()


def test_checked_gather_raises_in_debug_on_the_card(cuda_device):
    from owl_path_tracer_tpu_torch.ops import debug

    table = torch.arange(10.0, device=cuda_device)
    debug.set_debug(True)
    try:
        with pytest.raises(debug.DebugCheckError, match="out of bounds"):
            debug.checked_gather(table, torch.tensor([3, 12], device=cuda_device))
        with pytest.raises(debug.DebugCheckError, match="non-finite"):
            debug.assert_finite(torch.tensor([1.0, float("nan")], device=cuda_device))
        assert debug.checked_gather(table, torch.tensor([3, 9], device=cuda_device)).tolist() == [3.0, 9.0]
    finally:
        debug.set_debug(False)
    assert debug.checked_gather(table, torch.tensor([3, 12], device=cuda_device)).tolist() == [3.0, 9.0]


@contextlib.contextmanager
def _syncs_only_in_sync_spans():
    """Every synchronising CUDA call raises, except inside an
    ``owlpt.sync.*`` range: a wrap of ``record_function`` (as the benchmark's
    host clock wraps it) lifts the mode on such a range's enter and sets it
    again on its exit.  Yields a Counter of the ranges entered, by name."""
    cls = torch.profiler.record_function
    enter, exit_ = cls.__enter__, cls.__exit__
    entered = collections.Counter()

    def lift(rf):
        out = enter(rf)
        entered[rf.name] += 1
        if rf.name.startswith("owlpt.sync."):
            torch.cuda.set_sync_debug_mode(0)
        return out

    def restore(rf, *exc):
        if rf.name.startswith("owlpt.sync."):
            torch.cuda.set_sync_debug_mode("error")
        return exit_(rf, *exc)

    torch.cuda.synchronize()
    cls.__enter__, cls.__exit__ = lift, restore
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield entered
    finally:
        torch.cuda.set_sync_debug_mode(0)
        cls.__enter__, cls.__exit__ = enter, exit_


_CELLS = {"wavefront": "dragon7.wavefront", "scan": "dragon7.scan", "nee-deferred": "cornell.nee-deferred"}


def _cell_frame(kind, tmp_path):
    """A frame of the benchmark cell ``_CELLS[kind]``'s path at a small size
    (128x96; the dragon at subdivision 5; the wavefront on fused2 f32
    planes, sorted, 4,096 lanes, the cornell box's with the cell's deferred
    NEE; the scan on the fused kernel in chunks of 4,096 pixels) -> a
    function that renders it -> (image, rays)."""
    from benchmark import drive, scenes
    from benchmark.conftest import tiny_cell

    cell = tiny_cell(_CELLS[kind], subdivision=5, width=128, height=96, lanes=4096, pixel_chunk=4096)
    cell.traffic = dict(cell.traffic, cluster_size=drive.load_cell(cell.name).traffic["cluster_size"])
    prog = drive.Program(cell, scenes.materialize(cell.config, tmp_path), 0, "cuda")
    tr = cell.traffic

    def frame():
        if kind != "scan":
            return render_image_wavefront(prog.scene, prog.settings, prog.accel, lanes=tr["lanes"],
                                          fused2_block=tr["block"], fused2_sort=tr["sort"], sample_base=3,
                                          **tr.get("options", {}))
        f = tfilm.add_samples(prog.scene, prog.settings, prog.film_state, 1, pixel_chunk=tr["pixel_chunk"],
                              accel=prog.accel)
        return tfilm.finalize(f), f.rays_traced

    return frame


@pytest.mark.parametrize("kind", ["wavefront", "scan"])
def test_every_sync_of_a_cell_path_is_in_a_sync_span(cuda_device, tmp_path, kind):
    """A frame of each benchmark cell's path (``_cell_frame``) finishes with
    every synchronising call raising outside the ``owlpt.sync.*`` ranges, so
    ``host.syncs_per_pass`` counts every sync of both paths.  The frame
    renders once first (kernel builds and caches)."""
    frame = _cell_frame(kind, tmp_path)
    want, rays_want = frame()
    with _syncs_only_in_sync_spans():
        img, rays = frame()
    assert rays == rays_want > 0 and torch.equal(img, want)


@pytest.mark.parametrize("kind", ["wavefront", "scan", "nee-deferred"])
def test_cell_paths_shade_every_step_in_the_kernel(cuda_device, tmp_path, kind):
    """A frame of each benchmark cell's path (``_cell_frame``: the wavefront
    takes fused2's attribute blob, the scan the shade-blob gather, the
    cornell cell's deferred NEE fused2's blob) shades every bounce step in
    one launch of its shading kernel (the NEE kernel on the cornell cell's
    path, the other elsewhere) and never in a plain version, with every
    synchronising call outside the ``owlpt.sync.*`` ranges raising."""
    frame = _cell_frame(kind, tmp_path)
    frame()
    shade.reset_counts()
    with _syncs_only_in_sync_spans() as entered:
        frame()
    steps, nee = entered["owlpt.step"], kind == "nee-deferred"
    assert steps > 0
    assert shade.LAUNCHES == {shade.ENTRY: 0 if nee else steps, shade.PLAIN_CUDA: 0,
                              shade.ENTRY_NEE: steps if nee else 0, shade.PLAIN_CUDA_NEE: 0}
    assert entered["owlpt.sync.sky"] == entered["owlpt.sync.normal"] == entered["owlpt.sync.env_color"] == 0


@pytest.mark.parametrize("kind", ["wavefront", "nee-deferred"])
def test_cell_frame_ends_at_its_last_busy_step(cuda_device, tmp_path, monkeypatch, kind):
    """A frame of each wavefront cell's path (``_cell_frame``) runs no step
    past its last busy one (a lane alive or a shadow ray pending before
    it), with every synchronising call outside the ``owlpt.sync.*`` ranges
    raising; its image and rays equal, bit for bit, those of launches that
    each run all their steps until the status read after a launch says the
    frame is done."""
    frame = _cell_frame(kind, tmp_path)
    frame()
    busy, step = [], wavefront.wavefront_step

    def record(scene, settings, st, *a, **k):
        busy.append((st.alive | st.sh_active).any())  # read after the frame: no sync inside it
        return step(scene, settings, st, *a, **k)

    monkeypatch.setattr(wavefront, "wavefront_step", record)
    wavefront.reset_counts()
    with _syncs_only_in_sync_spans() as entered:
        img, rays = frame()
    ended = dict(wavefront.STEPS)
    busy = torch.stack(busy).tolist()
    last_busy = max(i for i, b in enumerate(busy) if b)
    assert entered["owlpt.step"] == len(busy) == ended["run"] == last_busy + 1
    monkeypatch.setattr(wavefront, "wavefront_step", step)
    run = wavefront._run_chunk
    monkeypatch.setattr(wavefront, "_run_chunk", lambda *a, stop_from=None, **k: run(*a, **k))
    wavefront.reset_counts()
    img_fixed, rays_fixed = frame()
    fixed = dict(wavefront.STEPS)
    print(f"{kind}: steps {ended['run']} (cut {ended['cut']}) against {fixed['run']} in "
          f"{ended['launches']} launches; status reads {entered['owlpt.sync.status']}")
    assert torch.equal(img, img_fixed) and rays == rays_fixed > 0
    assert fixed["cut"] == 0 and fixed["run"] == ended["run"] + ended["cut"]


_SHADE_INT = ("alive", "depth", "rng", "prev_lobe")
_SHADE_FLOAT = ("result", "ray_o", "throughput", "ray_d")


@pytest.mark.parametrize("textures", [False, True], ids=["plain", "textured"])
@pytest.mark.parametrize("surface", ["blob", "gather"])
@pytest.mark.parametrize("parity", [True, False], ids=["parity", "corrected"])
@pytest.mark.parametrize("env", ["auto", "map", "color"])
def test_shade_kernel_matches_plain(cuda_device, env, parity, surface, textures):
    """The shading kernel against the plain ``_shade_bounce`` from the same
    random bounce (tests/test_torch_shade.py ``random_bounce``: every lobe,
    glass's transmit, TIR and Fresnel reflect, the forced BTDF, sheen,
    emission, misses, dead lanes, the retry of a non-finite f, Russian
    roulette), on the card: the lane's fate, depth, LCG state and lobe equal
    on every lane, radiance, origin, throughput and direction to rtol 1e-5 /
    atol 1e-6.  Prints the share of lanes whose every output is bit-equal."""
    scene, settings, state, hit, blob = random_bounce(cuda_device, n=16384, seed=11, env=env, parity=parity)
    blob = blob if surface == "blob" else None
    launches = shade.LAUNCHES[shade.ENTRY]
    got = shade.shade_bounce(scene, settings, state, hit, blob, textures)
    assert shade.LAUNCHES[shade.ENTRY] == launches + 1
    want = integrator._shade_bounce(scene, settings, state, hit, blob, textures)
    torch.cuda.synchronize()
    for k in _SHADE_INT:
        assert torch.equal(got[k], getattr(want, k)), f"{k}: {(got[k] != getattr(want, k)).sum()} lanes differ"
    for k in _SHADE_FLOAT:
        torch.testing.assert_close(got[k], getattr(want, k), rtol=1e-5, atol=1e-6, equal_nan=True, msg=k)
    same = torch.stack([(got[k] == getattr(want, k)).view(len(got[k]), -1).all(-1) for k in (*_SHADE_INT,
                                                                                            *_SHADE_FLOAT)])
    print(f"shade kernel {env} {'parity' if parity else 'corrected'} {surface} textures={textures}: "
          f"{same.all(0).float().mean().item():.6f} of lanes bit-equal")


_NEE_FLOAT = (*_SHADE_FLOAT, "prev_pdf")
_PENDING = ("origin", "direction", "distance", "contribution")


@pytest.mark.parametrize("env", ["map", "color"])
@pytest.mark.parametrize("textures", [False, True], ids=["plain", "textured"])
@pytest.mark.parametrize("surface", ["blob", "gather"])
@pytest.mark.parametrize("parity", [True, False], ids=["parity", "corrected"])
def test_shade_nee_kernel_matches_plain(cuda_device, parity, surface, textures, env):
    """The deferred NEE shading kernel against the plain
    ``_shade_bounce_nee(..., deferred=True)`` from the same random NEE bounce
    (tests/test_torch_shade.py ``random_nee_bounce``: hits on lights and on
    emissive non-lights, depth 0 and prev_pdf 0 lanes, allow_nee off on some
    lanes, grazing light samples of pdf 0, non-finite contributions, and
    every case of ``random_bounce``), on the card: the lane's fate, depth,
    LCG state, lobe and pending flag equal on every lane; radiance, origin,
    throughput, direction and prev_pdf to rtol 1e-5 / atol 1e-6; the pending
    ray's origin, direction, distance and contribution so on the pending
    lanes.  With allow_nee False for every lane the state is the same and
    nothing is pending.  Prints the share of lanes whose every output is
    bit-equal."""
    scene, settings, lights, state, hit, blob, allow = random_nee_bounce(cuda_device, n=16384, seed=12, env=env,
                                                                        parity=parity)
    blob = blob if surface == "blob" else None
    launches = shade.LAUNCHES[shade.ENTRY_NEE]
    got, got_pend = shade.shade_bounce_nee(scene, settings, lights, state, hit, blob, textures, allow)
    assert shade.LAUNCHES[shade.ENTRY_NEE] == launches + 1
    want, want_pend = integrator._shade_bounce_nee(scene, settings, lights, state, hit, blob, None, textures, allow,
                                                   None, True)
    torch.cuda.synchronize()
    for k in _SHADE_INT:
        assert torch.equal(got[k], getattr(want, k)), f"{k}: {(got[k] != getattr(want, k)).sum()} lanes differ"
    for k in _NEE_FLOAT:
        torch.testing.assert_close(got[k], getattr(want, k), rtol=1e-5, atol=1e-6, equal_nan=True, msg=k)
    on = want_pend[4]
    assert torch.equal(got_pend[4], on), f"pending: {(got_pend[4] != on).sum()} lanes differ"
    assert on.any()
    for name, g, w in zip(_PENDING, got_pend, want_pend):
        torch.testing.assert_close(g[on], w[on], rtol=1e-5, atol=1e-6, equal_nan=True, msg=name)
    same = torch.stack([(got[k] == getattr(want, k)).view(len(got[k]), -1).all(-1) for k in (*_SHADE_INT,
                                                                                            *_NEE_FLOAT)]
                       + [(g == w).view(len(g), -1).all(-1) | ~on for g, w in zip(got_pend, want_pend)])
    print(f"shade NEE kernel {env} {'parity' if parity else 'corrected'} {surface} textures={textures}: "
          f"{same.all(0).float().mean().item():.6f} of lanes bit-equal, {int(on.sum())} pending")

    off, off_pend = shade.shade_bounce_nee(scene, settings, lights, state, hit, blob, textures, False)
    for k in got:
        assert torch.equal(off[k], got[k]), k
    assert not off_pend[4].any()

