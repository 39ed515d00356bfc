"""Port LCG stream vs the JAX package's: bit-exact on random uint32 inputs,
including values near 2^32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_path_tracer_tpu.ops import rng as jrng
from owl_path_tracer_tpu_torch.ops import rng as trng

torch.set_num_threads(2)


def _inputs(seed, n=4096):
    r = np.random.default_rng(seed)
    u = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)
    u[: len(edge)] = edge
    v[: len(edge)] = edge[::-1]
    return u, v


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_seed_bit_exact(seed):
    u, v = _inputs(seed)
    want = np.asarray(jax.jit(jrng.seed)(jnp.asarray(u), jnp.asarray(v)))
    got = trng.seed(_t(u), _t(v)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_next_f32_bit_exact():
    u, _ = _inputs(2)
    # states near 2^32 round to 1.0 in float32, as in the reference
    val_j, st_j = jax.jit(jrng.next_f32)(jnp.asarray(u))
    val_t, st_t = trng.next_f32(_t(u))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j).astype(np.int64))
    np.testing.assert_array_equal(val_t.numpy().view(np.uint32), np.asarray(val_j).view(np.uint32))
    np.testing.assert_array_equal(
        trng.to_float(_t(u)).numpy().view(np.uint32),
        np.asarray(jax.jit(jrng.to_float)(jnp.asarray(u))).view(np.uint32),
    )


def test_next_f32_n_bit_exact():
    u, v = _inputs(3, n=512)
    fn = jax.jit(lambda a, b: jrng.next_f32_n(jrng.seed(a, b), 6))
    vals_j, st_j = fn(jnp.asarray(u), jnp.asarray(v))
    vals_t, st_t = trng.next_f32_n(trng.seed(_t(u), _t(v)), 6)
    assert vals_t.shape == (6, 512) and st_t.shape == (6, 512)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j).astype(np.int64))
    np.testing.assert_array_equal(vals_t.numpy().view(np.uint32), np.asarray(vals_j).view(np.uint32))
