"""The port on a CUDA card: the fused2 kernel against its plain version, and a
frame rendered on the card against the same frame on the CPU.

Imports nothing of JAX (the card's machine has none).  Every test is marked
``cuda`` and skips where there is no CUDA device.  On the card:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances: winning
triangle, winner cluster/slot and attribute blob exact; t/u/v to rtol 5e-6
(both sides evaluate mt_components in the same op order without FMAs, so
they agree bit for bit in practice); images by the golden rule of
tests/test_golden.py.
"""
import pathlib

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.render.film import make_accel
from owl_path_tracer_tpu_torch.render.wavefront import render_image_wavefront

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
    fb = tf2.build_fused2(verts, idx, 64, normals, tc, mat, device="cpu")
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
    launches = tf2.KERNEL_LAUNCHES
    got = tf2.fused2_traverse_packed(rays, fb, block=block)
    assert tf2.KERNEL_LAUNCHES == launches + 1
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
    accel = make_accel(scene, "fused2")
    want, rays_want = render_image_wavefront(scene, settings, accel, lanes=1024, fused2_sort=True)
    img, rays = render_image_wavefront(scene.to(cuda_device), settings, accel.to(cuda_device),
                                       lanes=1024, fused2_sort=True)
    img, want = img.cpu().numpy(), want.numpy()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.995, f"only {close.mean():.4%} pixels match"
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)
    assert abs(rays - rays_want) <= 0.005 * rays_want
