"""Why a sampled GTR2 direction may differ between the port and the JAX
package by more than tests/test_torch_integrator.py's rtol 1e-4 / atol 1e-5.

Both packages' ``sample_gtr2_ndf`` compute ``cos_t = 1 / sqrt(1 + tan^2)``
and then ``sin_t = sqrt(1 - cos_t^2)``, the same operations in the same
order.  For a narrow lobe cos_t lies a few ulps below 1, and the subtraction
cancels: one ulp of cos_t (2^-24) moves sin_t by about cos_t / sin_t ulps of
cos_t, ~3e-4 of sin_t at cos_t = 0.9999.  XLA's CPU code does not round
``1 / sqrt`` the way torch does (nor one host as another), so the two
packages' cos_t may lie an ulp or two apart, and the direction built from it
a few 1e-5 apart.  These tests pin that cause: the cancellation itself, and
that the port equals the reference wherever the two ``1 / sqrt`` results
agree.  :func:`ndf_direction_allowance` is the per-lane margin the
integrator parity tests add for it.
"""
import jax.numpy as jnp
import numpy as np
import torch

from owl_path_tracer_tpu.ops import disney as jd
from owl_path_tracer_tpu_torch.ops import disney as td

# ulps of cos_t near 1 by which the two packages' 1/sqrt may differ
# (measured: at most 2, in eager and jitted XLA on the CPU)
COS_T_ULPS = 4


def _sin_t(c):
    """The reference's sin_t of cos_t ``c``, in float64 (no rounding of its own)."""
    return np.sqrt(np.maximum(0.0, 1.0 - np.square(c.astype(np.float64))))


def ndf_direction_allowance(cos_t, ulps: int = COS_T_ULPS):
    """[N] largest change of a half vector built from ``cos_t`` (float32)
    when cos_t moves by up to ``ulps`` ulps (a scalar or [N]; clamped to
    [0, 1]): the change of sin_t plus that of cos_t.  A direction reflected about that half
    vector turns by twice its angle, so a sampled direction gets twice this."""
    c = np.abs(np.asarray(cos_t, np.float32))
    s = _sin_t(c)
    worst = np.zeros(c.shape, np.float64)
    for sign in (-1.0, 1.0):
        c2 = np.clip(c.astype(np.float64) + sign * ulps * np.spacing(c).astype(np.float64), 0.0, 1.0)
        worst = np.maximum(worst, np.abs(_sin_t(c2) - s) + np.abs(c2 - c))
    return 2.0 * worst


class _RecordSqrt:
    """A module proxy that records every ``sqrt`` result (the first call in
    ``sample_gtr2_ndf`` is the ``sqrt(1 + tan^2)`` whose reciprocal is cos_t)."""

    def __init__(self, mod):
        self._mod = mod
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def sqrt(self, x):
        y = self._mod.sqrt(x)
        self.calls.append(y)
        return y


def test_one_ulp_of_cos_t_moves_sin_t_by_its_cancellation():
    # cos_t of the two lanes of the cornell NEE parity case that once fell
    # outside the fixed tolerance (rows 664 and 794: metallic, pdf ~41)
    for c in (np.float32(0.99991787), np.float32(0.99991155)):
        up = np.nextafter(c, np.float32(2.0))
        cs = np.array([c, up], np.float32)
        s_t = torch.sqrt(torch.clamp(1.0 - torch.as_tensor(cs) ** 2, min=0.0)).numpy()
        s_j = np.asarray(jnp.sqrt(jnp.maximum(0.0, 1.0 - jnp.asarray(cs) ** 2)))
        # the same cos_t gives sin_t within an ulp of sin_t in both
        # frameworks (XLA's CPU sqrt is not always correctly rounded either),
        # a few thousand times less than the move of one ulp of cos_t below
        assert (np.abs(s_t - s_j) <= np.spacing(s_t)).all()
        moved = abs(float(s_t[1]) - float(s_t[0]))
        assert moved > 1000 * float(np.spacing(s_t[0]))
        predicted = float(c) / float(s_t[0]) * float(np.spacing(c))  # first order: cos_t / sin_t per ulp
        assert 0.5 * predicted < moved < 2.0 * predicted, (moved, predicted)
        # far beyond the parity tests' rtol of 1e-4 of sin_t
        assert moved / float(s_t[0]) > 2e-4
        # and within the allowance the parity tests add (twice, for the reflection)
        assert moved <= ndf_direction_allowance(np.array([c]), ulps=1)[0] / 2.0


def test_port_equals_reference_wherever_the_reciprocal_sqrt_agrees(monkeypatch):
    r = np.random.default_rng(3)
    n = 40000
    wo = r.normal(size=(n, 3)).astype(np.float32)
    wo[:, 2] = np.abs(wo[:, 2])
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    ax = r.uniform(0.001, 0.05, n).astype(np.float32)  # narrow lobes: cos_t near 1
    ay = r.uniform(0.001, 0.05, n).astype(np.float32)
    u = r.random((n, 2), dtype=np.float32)
    j_rec, t_rec = _RecordSqrt(jnp), _RecordSqrt(torch)
    monkeypatch.setattr(jd, "jnp", j_rec)
    monkeypatch.setattr(td, "torch", t_rec)
    wh_j = np.asarray(jd.sample_gtr2_ndf(*(jnp.asarray(x) for x in (wo, ax, ay, u))))
    wh_t = td.sample_gtr2_ndf(*(torch.as_tensor(x) for x in (wo, ax, ay, u))).numpy()
    monkeypatch.undo()
    cos_j = np.asarray(1.0 / j_rec.calls[0])
    cos_t = (1.0 / t_rec.calls[0]).numpy()
    same = cos_j == cos_t
    diff = np.abs(wh_j - wh_t).max(-1)
    # most rows agree; there the other transcendentals' last bits are all
    # that is left (a few 1e-8)
    assert same.mean() > 0.5 and (~same).sum() > 100
    assert diff[same].max() < 1e-6
    # elsewhere cos_t lies apart, by at most a few ulps where it is near 1
    # (where the cancellation amplifies them), and the half vector moves by
    # no more than that distance does through the formula
    ulps = np.abs(cos_j.view(np.int32).astype(np.int64) - cos_t.view(np.int32))
    assert ulps[cos_t > 0.99].max() <= COS_T_ULPS
    moved = ndf_direction_allowance(cos_t[~same], ulps[~same]) / 2.0
    assert (diff[~same] <= moved + 1e-6).all()
    # and those moves are the ones that exceed a fixed rtol 1e-4 / atol 1e-5
    # (in eager XLA only a few; jitted XLA on the CPU rounds further apart)
    beyond = (np.abs(wh_j - wh_t) > 1e-5 + 1e-4 * np.abs(wh_j)).any(-1)
    assert not (beyond & same).any()
