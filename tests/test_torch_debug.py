"""The port's debug layer (``ops/debug.py``) against the JAX package's:
tests/test_debug.py's four cases, ``validate_scene``'s problem strings equal
to JAX's on the same bad scenes, and ``OWLPT_DEBUG`` read at import."""
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.models import material as jmat
from owl_path_tracer_tpu.models.camera import make_camera as jcam
from owl_path_tracer_tpu.models.scene import scene_from_arrays as jscene_from_arrays
from owl_path_tracer_tpu.ops import debug as jdbg
from owl_path_tracer_tpu.utils.parser import CameraDesc as JCameraDesc
from owl_path_tracer_tpu_torch.models import camera as tcam
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.models.scene import scene_from_arrays
from owl_path_tracer_tpu_torch.ops import debug as dbg
from owl_path_tracer_tpu_torch.utils.parser import CameraDesc


@pytest.fixture
def debug_on():
    dbg.set_debug(True)
    yield
    dbg.set_debug(False)


def test_checked_gather_debug_raises(debug_on):
    table = torch.arange(10.0)
    with pytest.raises(dbg.DebugCheckError, match="out of bounds in buffer"):
        dbg.checked_call(lambda i: dbg.checked_gather(table, i), torch.tensor([3, 12]))
    with pytest.raises(dbg.DebugCheckError):
        dbg.checked_gather(table, torch.tensor([-1]))
    out = dbg.checked_call(lambda i: dbg.checked_gather(table, i), torch.tensor([3, 9]))
    np.testing.assert_allclose(out.numpy(), [3.0, 9.0])


def test_assert_finite(debug_on):
    with pytest.raises(dbg.DebugCheckError, match="non-finite value"):
        dbg.checked_call(lambda x: dbg.assert_finite(x), torch.tensor([1.0, np.nan]))
    with pytest.raises(dbg.DebugCheckError):
        dbg.assert_finite(torch.tensor([np.inf]))
    out = dbg.checked_call(lambda x: dbg.assert_finite(x) * 2, torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])


def test_assert_unit(debug_on):
    v = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.6, 0.8]])
    assert dbg.assert_unit(v) is v
    with pytest.raises(dbg.DebugCheckError, match="direction not normalized"):
        dbg.assert_unit(v * 1.01)


def test_release_mode_zero_cost_clamp():
    """Release mode: out-of-range indices clamp (as JAX's), and the checks
    read nothing: a non-finite value passes through untouched."""
    dbg.set_debug(False)
    table = torch.arange(10.0)
    out = dbg.checked_gather(table, torch.tensor([3, 12, -4]))
    want = jdbg.checked_gather(jnp.arange(10.0), jnp.asarray([3, 12, -4]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_allclose(out.numpy(), [3.0, 9.0, 0.0])
    x = torch.tensor([np.nan])
    assert dbg.assert_finite(x) is x and dbg.assert_unit(x) is x


def _scenes():
    """The one-triangle scene of tests/test_debug.py in both packages."""
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    desc = ((0, 0, 3), (0, 0, 0), (0, 1, 0), 45)
    js = jscene_from_arrays(v, idx, jmat.single(), np.zeros(1, np.int32), jcam(JCameraDesc(*desc), (8, 8)))
    ts = scene_from_arrays(v, idx, tmat.single(device="cpu"), np.zeros(1, np.int32),
                           tcam.make_camera(CameraDesc(*desc), (8, 8), device="cpu"), device="cpu")
    return js, ts


BAD = {
    "ok": ({}, {}),
    "tri_idx": ({"tri_idx": [[0, 1, 7]]}, {}),
    "tri_mat": ({"tri_mat": [2]}, {}),
    "normals": ({"normals": [[0, 0, 2.0]] * 3}, {}),
    "materials": ({}, {"roughness": [1.7], "metallic": [-0.1], "specular_transmission": [2.0], "ior": [0.5]}),
    "env_map": ({"env_map": [[[np.inf, 0, 0]]]}, {}),
    "all": ({"tri_idx": [[-1, 1, 2]], "tri_mat": [-3], "env_map": [[[np.nan, 0, 0]]]}, {"roughness": [-1.0]}),
}


@pytest.mark.parametrize("case", list(BAD))
def test_validate_scene_strings_equal_jax(case):
    scene_kw, mat_kw = BAD[case]
    js, ts = _scenes()
    dtypes = {"tri_idx": (jnp.int32, torch.int32), "tri_mat": (jnp.int32, torch.int32)}
    jkw = {k: jnp.asarray(v, dtypes.get(k, (jnp.float32,))[0]) for k, v in scene_kw.items()}
    tkw = {k: torch.as_tensor(np.asarray(v), dtype=dtypes.get(k, (None, torch.float32))[1])
           for k, v in scene_kw.items()}
    js = js._replace(materials=js.materials._replace(**{k: jnp.asarray(v, jnp.float32) for k, v in mat_kw.items()}),
                     **jkw)
    ts = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, **{k: torch.tensor(v) for k, v in mat_kw.items()}), **tkw)
    want = jdbg.validate_scene(js)
    assert dbg.validate_scene(ts) == want
    assert (want == []) == (case == "ok")


def test_owlpt_debug_is_read_at_import(monkeypatch):
    monkeypatch.setenv("OWLPT_DEBUG", "1")
    try:
        assert importlib.reload(dbg).debug_enabled()
        monkeypatch.setenv("OWLPT_DEBUG", "0")
        assert not importlib.reload(dbg).debug_enabled()
    finally:
        monkeypatch.delenv("OWLPT_DEBUG")
        importlib.reload(dbg)
    code = ("from owl_path_tracer_tpu_torch.ops import debug; import torch\n"
            "debug.checked_gather(torch.arange(3.0), torch.tensor([5]))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OWLPT_DEBUG": "1"},
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode != 0 and "index out of bounds in buffer (size 3)" in proc.stderr
