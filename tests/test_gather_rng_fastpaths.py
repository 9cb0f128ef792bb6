"""Unit tests for the counter-mode threefry fast path (core/rng.py).

It exists purely for speed; these tests pin it to the slow,
obviously-correct implementation so perf work can't drift semantics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oppositerenderer.core.rng import (LaneSampler, make_root_key,
                                           set_rng_mode, threefry2x32)


def test_threefry_matches_jax_internal():
    """Our explicit-counter threefry2x32 is bit-identical to the one JAX's
    PRNG uses (jax._src.prng.threefry_2x32)."""
    from jax._src import prng as jprng
    k = jnp.array([0x12345678, 0x9ABCDEF0], dtype=jnp.uint32)
    x = jnp.arange(64, dtype=jnp.uint32)
    ref = jprng.threefry_2x32(k, x)
    r0, r1 = threefry2x32(k[0], k[1], x[:32], x[32:])
    assert bool(jnp.all(ref == jnp.concatenate([r0, r1])))


@pytest.mark.parametrize("mode", ["threefry", "cheap"])
def test_lane_sampler_stream_properties(mode):
    set_rng_mode(mode)
    try:
        key = make_root_key(7)
        lanes = jnp.arange(4096, dtype=jnp.int32)
        s = LaneSampler(key, lanes)
        u = np.asarray(jnp.concatenate(
            [s.next1()[:, None], s.next2(), s.next3()], axis=1))
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.02
        # columns decorrelated
        c = np.corrcoef(u.T)
        off = c[~np.eye(6, dtype=bool)]
        assert np.abs(off).max() < 0.06
        # sharding invariance: a lane's draws don't depend on batch slicing
        s_full = LaneSampler(key, lanes)
        full = np.asarray(s_full.next3())
        s_half = LaneSampler(key, lanes[2048:])
        half = np.asarray(s_half.next3())
        np.testing.assert_array_equal(full[2048:], half)
    finally:
        set_rng_mode("threefry")
