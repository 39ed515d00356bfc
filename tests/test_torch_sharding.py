"""The port's multi-device rendering (``parallel/shard.py`` on
``torch.distributed``) against the JAX package's on a 2-device mesh (two of
the conftest's 8 virtual CPU devices) and against the port's single-device
renderers.

* Two gloo processes (``shard.spawn_ranks``: a FileStore in ``tmp_path``, a
  timeout on each rank) run ``render_image_sharded``,
  ``render_image_wavefront_sharded`` with both work splits, and
  ``sharded_loss_and_grad`` on tests/test_sharding.py's scene.
* Against the port's single-device results: the scan image bit for bit;
  the wavefront images to tests/test_sharding.py's rtol 1e-5 / atol 1e-6
  (the "sample" split sums a pixel's samples in another order) with equal
  ray counts; loss and gradients to rtol 1e-5 (the mean of two shard means
  against the mean over all pixels).
* Against JAX's: images by the golden rule, ray counts within 0.5% in all
  and per rank; loss to rtol 1e-3 and gradients to rtol 1e-3 / atol 1e-5
  max|g| as in tests/test_torch_diff.py, over the pixels whose forward
  radiance agrees (the loss is taken over those pixels only: on this
  sphere XLA's jitted render sends one grazing bounce another way).
* World size 1 in this process (gloo): every entry point equals its
  single-device counterpart bit for bit.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from owl_path_tracer_tpu.ops import rng as jrng
from owl_path_tracer_tpu.parallel import shard as jshard
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import rng as rng_mod
from owl_path_tracer_tpu_torch.parallel import shard
from owl_path_tracer_tpu_torch.render import diff as tdiff
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.render import wavefront as twf
from test_integrator import make_sphere_mesh
from test_sharding import SETTINGS as JSETTINGS
from test_sharding import small_scene as jsmall_scene
from test_torch_film import assert_golden_rule
from torch_shard_worker import SETTINGS, run_all, small_scene

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
SPHERE = make_sphere_mesh(np.zeros(3), 1.0)


def _grad_pixels(agree):
    """The pixels (x, y) of the [H,W] top-row-first mask ``agree``, in
    launch order, trimmed to an even count."""
    ys, xs = np.nonzero(agree[::-1])  # rows bottom first, as the film's y
    px = np.stack([xs, ys], -1).astype(np.int32)
    return px[: len(px) // 2 * 2]


@pytest.fixture(scope="module")
def jax_mesh():
    return jshard.make_pixel_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def jax_results(jax_mesh):
    js = jsmall_scene()
    out = {"scan": jshard.render_image_sharded(js, JSETTINGS, mesh=jax_mesh)}
    for split in ("sample", "contiguous"):
        out[split] = jshard.render_image_wavefront_sharded(js, JSETTINGS, mesh=jax_mesh, lanes_per_chip=256,
                                                           iters_per_launch=4, work_split=split, return_stats=True)
    return out


@pytest.fixture(scope="module")
def grad_pixels(jax_results):
    """Pixels whose scan radiance agrees between the JAX package's 2-device
    render and the port's single-device one (all three channels)."""
    port = tfilm.render_image(small_scene(SPHERE), SETTINGS, pixel_chunk=256).numpy()
    agree = np.isclose(port, jax_results["scan"], rtol=1e-4, atol=1e-5).all(-1)
    assert agree.mean() > 0.99
    return _grad_pixels(agree)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, grad_pixels):
    """Both ranks' results of torch_shard_worker.run_all on two gloo processes."""
    store = tmp_path_factory.mktemp("store")
    res = shard.spawn_ranks(run_all, 2, device="cpu", args=(SPHERE, grad_pixels), timeout_s=600, store_dir=store)
    assert [r["rank"] for r in res] == [0, 1] and all(r["size"] == 2 for r in res)
    return res


@pytest.fixture(scope="module")
def single():
    """The port's single-device scan and wavefront images of the scene."""
    sc = small_scene(SPHERE)
    return {"scan": tfilm.render_image(sc, SETTINGS, pixel_chunk=256).numpy(),
            "wavefront": twf.render_image_wavefront(sc, SETTINGS, lanes=2048, iters_per_launch=4)}


def test_two_rank_scan_equals_single_device_and_jax(two_ranks, single, jax_results):
    for r in two_ranks:
        np.testing.assert_array_equal(r["scan"], single["scan"])
    assert_golden_rule(two_ranks[0]["scan"], np.asarray(jax_results["scan"]), "2-rank scan vs JAX 2-device")


@pytest.mark.parametrize("split", ["sample", "contiguous"])
def test_two_rank_wavefront_equals_single_device_and_jax(two_ranks, single, jax_results, split):
    img_1, rays_1 = single["wavefront"]
    img_j, rays_j, stats_j = jax_results[split]
    for r in two_ranks:
        img, rays, stats = r[split]
        np.testing.assert_allclose(img, img_1.numpy(), rtol=1e-5, atol=1e-6)
        assert rays == rays_1 == sum(stats["per_chip_rays"])
        assert stats == two_ranks[0][split][2]  # every rank returns the same stats
        assert stats["load_balance"] == np.mean(stats["per_chip_rays"]) / max(stats["per_chip_rays"])
    assert_golden_rule(two_ranks[0][split][0], np.asarray(img_j), f"2-rank {split} vs JAX 2-device")
    assert abs(rays_1 - rays_j) <= 0.005 * rays_j
    for got, want in zip(two_ranks[0][split][2]["per_chip_rays"], stats_j["per_chip_rays"]):
        assert abs(got - want) <= 0.005 * want, (split, got, want)
    if split == "sample":
        assert two_ranks[0][split][2]["load_balance"] > 0.9


def test_two_rank_loss_and_grad_equal_single_device_and_jax(two_ranks, grad_pixels, jax_mesh):
    sc = small_scene(SPHERE)
    px = torch.as_tensor(grad_pixels)
    target = torch.zeros((len(px), 3))
    loss_1, grads_1 = tdiff.loss_and_grad(sc, sc.materials, SETTINGS, px, target, 4, None)
    js = jsmall_scene()
    state = np.asarray(jrng.seed(jnp.asarray(grad_pixels[:, 0]), jnp.asarray(grad_pixels[:, 1])))
    sh = NamedSharding(jax_mesh, P("px"))
    loss_j, grads_j = jshard.sharded_loss_and_grad(jax_mesh, js, JSETTINGS, None, 4)(
        js.materials, jax.device_put(jnp.asarray(grad_pixels), sh), jax.device_put(jnp.asarray(state), sh),
        jax.device_put(jnp.zeros((len(grad_pixels), 3)), sh))
    for r in two_ranks:
        assert r["loss"] == two_ranks[0]["loss"]
        np.testing.assert_allclose(r["loss"], float(loss_1), rtol=1e-5)
        np.testing.assert_allclose(r["loss"], float(loss_j), rtol=1e-3)
        for f in dataclasses.fields(grads_1):
            g = r["grads"][f.name]
            np.testing.assert_array_equal(g, two_ranks[0]["grads"][f.name])
            want = getattr(grads_1, f.name).numpy()
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-7 * np.abs(want).max(), err_msg=f.name)
            gj = np.asarray(getattr(grads_j, f.name))
            np.testing.assert_allclose(g, gj, rtol=1e-3, atol=1e-5 * np.abs(gj).max(), err_msg=f.name)
    assert np.abs(two_ranks[0]["grads"]["base_color"]).max() > 0


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one rank in this process."""
    store = tmp_path_factory.mktemp("store1") / "store"
    mesh = shard.make_pixel_mesh("cpu", init_method=store.as_uri(), rank=0, world_size=1)
    yield mesh
    mesh.close()


def test_world1_equals_single_device(world1, single, grad_pixels):
    assert (world1.rank, world1.size, world1.backend, world1.device) == (0, 1, "gloo", torch.device("cpu"))
    out = run_all(world1, SPHERE, grad_pixels)
    np.testing.assert_array_equal(out["scan"], single["scan"])
    img_1, rays_1 = single["wavefront"]
    for split in ("sample", "contiguous"):
        img, rays, stats = out[split]
        np.testing.assert_array_equal(img, img_1.numpy())
        assert rays == rays_1 and stats == {"per_chip_rays": [rays_1], "load_balance": 1.0}
    sc = small_scene(SPHERE)
    px = torch.as_tensor(grad_pixels)
    loss_1, grads_1 = tdiff.loss_and_grad(sc, sc.materials, SETTINGS, px, torch.zeros((len(px), 3)), 4, None)
    assert out["loss"] == float(loss_1)
    for f in dataclasses.fields(grads_1):
        np.testing.assert_array_equal(out["grads"][f.name], getattr(grads_1, f.name).numpy(), err_msg=f.name)


def test_world1_nee_loss_and_grad_equal_single_device(world1):
    """NEE (the JAX package's sharded loss raises there): the port's light
    table is built outside the differentiated function, and the result is
    its own single-device loss_and_grad."""
    s = dataclasses.replace(SETTINGS, use_nee=True, environment_intensity=0.0)
    sc = tscene.compile_scene(ASSETS, "cornell-box", (8, 8), device="cpu")
    px = tfilm._pixel_grid(8, 8, "cpu")
    target = torch.zeros((64, 3))
    accel = tfilm.make_accel(sc, "cluster", cluster_size=64)
    loss, grads = shard.sharded_loss_and_grad(world1, sc, s, accel, 2)(
        sc.materials, px, rng_mod.seed(px[:, 0], px[:, 1]), target)
    loss_1, grads_1 = tdiff.loss_and_grad(sc, sc.materials, s, px, target, 2, accel)
    assert loss == loss_1 and loss > 0
    for f in dataclasses.fields(grads_1):
        assert torch.equal(getattr(grads, f.name), getattr(grads_1, f.name)), f.name
    assert grads.base_color.abs().sum() > 0


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("spp", [4, 12])
def test_work_split_arithmetic_equals_jax(n, spp):
    """``_work_range`` against the JAX package's arithmetic
    (``render_image_wavefront_sharded``'s work_lo / work_hi, shard.py:301-327,
    and ``sharded_wavefront_chunk``'s work_map, :223-229), and each split a
    partition of the frame's work ids."""
    total = 5 * 3 * spp
    edges = np.linspace(0, total, n + 1).round().astype(np.int32)  # the JAX package's contiguous ranges
    seen = []
    for k in range(n):
        mesh = shard.PixelMesh(rank=k, size=n, device=torch.device("cpu"), backend="gloo")
        lo, hi, work_map, local_spp = shard._work_range(mesh, total, spp, "contiguous")
        assert (lo, hi, work_map, local_spp) == (edges[k], edges[k + 1], None, None)
        if spp % n:
            with pytest.raises(ValueError, match="divisible"):
                shard._work_range(mesh, total, spp, "sample")
            continue
        lo, hi, work_map, local_spp = shard._work_range(mesh, total, spp, "sample")
        assert (lo, hi, local_spp) == (0, total // n, spp // n)
        ids = np.arange(lo, hi)
        want = np.asarray((jnp.asarray(ids) // local_spp) * spp + k * local_spp + (jnp.asarray(ids) % local_spp))
        got = work_map(torch.as_tensor(ids)).numpy()
        np.testing.assert_array_equal(got, want)
        seen.append(got)
    if seen:
        np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(total))


def test_mesh_and_split_arguments_are_checked(world1):
    sc = small_scene(SPHERE)
    with pytest.raises(ValueError, match="work_split"):
        shard.render_image_wavefront_sharded(sc, SETTINGS, mesh=world1, work_split="rows")
    with pytest.raises(ValueError, match="runs gloo, not the nccl"):
        shard.make_pixel_mesh("cpu", backend="nccl")
    mesh = dataclasses.replace(world1, device=torch.device("meta"))
    with pytest.raises(ValueError, match="this rank's device"):
        shard.render_image_wavefront_sharded(sc, SETTINGS, mesh=mesh)


def test_uninitialised_group_needs_init_arguments():
    """Before any group exists (a fresh process), a mesh needs the init
    arguments; nothing picks a backend or an address silently."""
    code = ("from owl_path_tracer_tpu_torch.parallel import shard\n"
            "try:\n    shard.make_pixel_mesh('cpu')\nexcept ValueError as e:\n    print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=ASSETS.parent)
    assert "refused: no process group is initialised" in out.stdout, out.stderr
