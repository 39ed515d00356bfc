"""Port scene compilation vs the JAX package's: arrays bit for bit, primary
rays to rtol 1e-6, and the numpy conversion round trip."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import camera as jcam
from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu_torch import convert
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import scene as tscene

torch.set_num_threads(2)

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


def as_numpy(x) -> dict:
    """A JAX NamedTuple (nested ones included) as a dict of numpy arrays."""
    return {f: as_numpy(v) if hasattr(v, "_fields") else np.asarray(v) for f, v in zip(x._fields, x)}


def assert_same_arrays(port, ref: dict, path=""):
    """Every field of a port dataclass equals the reference array bit for bit."""
    for name, want in ref.items():
        got = getattr(port, name)
        if isinstance(want, dict):
            assert_same_arrays(got, want, f"{path}{name}.")
            continue
        got = got.cpu().numpy()
        assert got.shape == want.shape, f"{path}{name}: {got.shape} vs {want.shape}"
        assert got.dtype.kind == want.dtype.kind, f"{path}{name}: {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{path}{name}")


@pytest.fixture(scope="module", autouse=True)
def ensure_assets():
    sys.path.insert(0, str(ASSETS))
    import generate

    generate.ensure_assets()


@pytest.mark.parametrize("name", ["sphere", "cornell-box"])
def test_compile_scene_bit_exact(name):
    ref = as_numpy(jscene.compile_scene(ASSETS, name, (40, 24)))
    port = tscene.compile_scene(ASSETS, name, (40, 24), device="cpu")
    assert_same_arrays(port, ref)


def test_primary_rays_match():
    ref_scene = jscene.compile_scene(ASSETS, "cornell-box", (40, 24))
    port_scene = tscene.compile_scene(ASSETS, "cornell-box", (40, 24), device="cpu")
    r = np.random.default_rng(0)
    px = np.stack([r.integers(0, 40, 1000), r.integers(0, 24, 1000)], -1).astype(np.int32)
    jit = r.uniform(0, 1, (1000, 2)).astype(np.float32)
    o_j, d_j = jax.jit(lambda p, j: jcam.primary_rays(ref_scene.camera, p, j, (40, 24)))(
        jnp.asarray(px), jnp.asarray(jit))
    o_t, d_t = tcam.primary_rays(port_scene.camera, torch.as_tensor(px), torch.as_tensor(jit), (40, 24))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6)
    # rtol 1e-6; components near zero carry the rounding of the unnormalized
    # vector (XLA may contract its sums into FMAs), hence atol = 2 ulp of 1.0
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=2.4e-7)


def test_scene_from_numpy_round_trip():
    ref = as_numpy(jscene.compile_scene(ASSETS, "sphere", (16, 16)))
    port = convert.scene_from_numpy(ref, device="cpu")
    assert_same_arrays(port, ref)
    assert_same_arrays(port.to("cpu"), ref)
    own = tscene.compile_scene(ASSETS, "sphere", (16, 16), device="cpu")
    assert_same_arrays(own, as_numpy_port(port))


def as_numpy_port(x) -> dict:
    import dataclasses

    return {
        f.name: as_numpy_port(getattr(x, f.name)) if dataclasses.is_dataclass(getattr(x, f.name))
        else getattr(x, f.name).cpu().numpy()
        for f in dataclasses.fields(x)
    }
