"""Port Disney BSDF sampling vs the JAX package's ``disney.sample``.

Lobe ids and final LCG states must be exact (draw accounting).  wi, f and pdf
are compared on lanes where both sides are finite, at the tolerances of
tests/test_disney.py's oracle comparison for f and pdf (rtol 5e-3 / atol
1e-4) and tighter ones for wi (rtol 1e-4 / atol 5e-5, where the reference
test allows 2e-3): the two frameworks' transcendental functions (atan, tan,
sin, cos, pow, log) differ in their last bits, and a sampled direction feeds
them again in the same call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.ops import disney as jd
from owl_path_tracer_tpu_torch.models import material as tmat
from owl_path_tracer_tpu_torch.ops import disney as td
from test_disney import rand_dir_upper, random_material, to_jax_mat

torch.set_num_threads(2)

N = 2000


def to_port_mat(vals_list):
    mats = [tmat.single(device="cpu", **v) for v in vals_list]
    return tmat.Materials(**{
        f.name: torch.cat([getattr(m, f.name) for m in mats]) for f in dataclasses.fields(tmat.Materials)
    })


@pytest.fixture(scope="module")
def inputs():
    """The domain of tests/test_disney.py: wo above the surface with any
    previous lobe, and wo below it when leaving glass (the forced-BTDF case)."""
    r = np.random.default_rng(11)
    vals = [random_material(r) for _ in range(N)]
    wo = rand_dir_upper(r, N)
    prev = r.choice([-1, 0, 1, 2, 3], N).astype(np.int32)
    exit_glass = np.arange(N) % 4 == 0
    wo[exit_glass, 2] *= -1.0
    prev[exit_glass] = jd.LOBE_GLASS
    states = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return vals, wo, states, prev


@pytest.mark.parametrize("corrected", [False, True])
def test_sample_matches_jax(inputs, corrected):
    vals, wo, states, prev = inputs
    fn = jax.jit(lambda mt, w, s, p: jd.sample(mt, w, s, p, corrected=corrected))
    ref = fn(to_jax_mat(vals), jnp.asarray(wo), jnp.asarray(states), jnp.asarray(prev))
    got = td.sample(to_port_mat(vals), torch.as_tensor(wo), torch.as_tensor(states.astype(np.int64)),
                    torch.as_tensor(prev.astype(np.int64)), corrected=corrected)

    lobe = np.asarray(ref.lobe)
    assert len(np.unique(lobe)) == 4  # every lobe exercised
    np.testing.assert_array_equal(got.lobe.numpy(), lobe)
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(ref.state).astype(np.int64))

    f_j, wi_j, pdf_j = np.asarray(ref.f), np.asarray(ref.wi), np.asarray(ref.pdf)
    f_t, wi_t, pdf_t = got.f.numpy(), got.wi.numpy(), got.pdf.numpy()
    fin = (np.isfinite(f_j).all(-1) & np.isfinite(f_t).all(-1)
           & np.isfinite(pdf_j) & np.isfinite(pdf_t) & (pdf_j > 1e-6))
    assert fin.mean() > 0.5
    np.testing.assert_allclose(wi_t[fin], wi_j[fin], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(pdf_t[fin], pdf_j[fin], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(f_t[fin], f_j[fin], rtol=5e-3, atol=1e-4)
    # the finite/non-finite split itself agrees
    np.testing.assert_array_equal(np.isfinite(f_t).all(-1), np.isfinite(f_j).all(-1))
