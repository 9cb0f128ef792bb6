"""Counter-based RNG for the wavefront renderer.

The reference threads a per-pixel curand state through every kernel
(``renderer/RandomState.h``, seeded in ``OptixRenderer_SpatialHash.cu:300-334``).
Here JAX's counter-based threefry takes its place: one key per
(iteration, pass), with whole-array draws — a single vectorized threefry call
per decision point instead of a per-lane mutable state. Determinism falls out
for free (reference needed DEBUG_RANDOM_SEED for that).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def make_root_key(seed: int) -> Array:
    return jax.random.PRNGKey(seed)


def iteration_key(root: Array, iteration: Array | int, pass_id: int) -> Array:
    """Key for one (iteration, pass). ``iteration`` may be traced."""
    return jax.random.fold_in(jax.random.fold_in(root, pass_id), iteration)


class Sampler:
    """Stateful convenience wrapper used inside traced code.

    Each ``next*`` call folds an incrementing counter into the base key, so a
    sampler constructed from the same key yields a reproducible stream. This
    is trace-time state (the counter is a Python int), so under ``jit`` each
    draw site gets its own fixed fold — exactly the counter-based pattern.
    """

    def __init__(self, key: Array):
        self._key = key
        self._n = 0

    def _next_key(self) -> Array:
        k = jax.random.fold_in(self._key, self._n)
        self._n += 1
        return k

    def next1(self, shape=()) -> Array:
        return jax.random.uniform(self._next_key(), shape, dtype=jnp.float32)

    def next2(self, shape=()) -> Array:
        return jax.random.uniform(self._next_key(), tuple(shape) + (2,),
                                  dtype=jnp.float32)

    def next3(self, shape=()) -> Array:
        return jax.random.uniform(self._next_key(), tuple(shape) + (3,),
                                  dtype=jnp.float32)

    def split_key(self) -> Array:
        """Hand out an independent key (e.g. to carry into a scan body)."""
        return self._next_key()


# RNG mode: "threefry" (crypto-strength counter RNG, default — the analog
# of the reference's curand) or "cheap" (integer-hash RNG, the analog of
# USE_CHEAP_RANDOM's xorshift/wang-hash, config.h:39 + RandomState.h:9-16).
# The cheap mode is ~10 int ops/draw vs threefry's ~100; quality is
# adequate for rendering.
_RNG_MODE = "threefry"


def set_rng_mode(mode: str) -> None:
    global _RNG_MODE
    assert mode in ("threefry", "cheap"), mode
    _RNG_MODE = mode


def get_rng_mode() -> str:
    return _RNG_MODE


def _lowbias32(x: Array) -> Array:
    """Excellent 32-bit integer hash (lowbias32, Chris Wellons)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7feb352d)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846ca68b)
    x = x ^ (x >> 16)
    return x


_TF_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Array, r: int) -> Array:
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0: Array, k1: Array, x0: Array, x1: Array):
    """Threefry-2x32 (20 rounds), explicit counter mode.

    Same construction JAX's PRNG uses, but applied directly to
    (lane_id, column) counters: ONE pass yields two independent uint32
    streams, vs. ~2 full passes per draw when going through
    ``fold_in`` + ``uniform`` per decision point.
    """
    k0 = k0.astype(jnp.uint32)
    k1 = k1.astype(jnp.uint32)
    x0 = x0.astype(jnp.uint32)
    x1 = x1.astype(jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for d in range(5):
        for r in _TF_ROTS[d % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(d + 1) % 3]
        x1 = x1 + ks[(d + 2) % 3] + jnp.uint32(d + 1)
    return x0, x1


def _key_words(key) -> tuple[Array, Array]:
    """(k0, k1) uint32 words of ``key``. ``key`` may also be a pre-split
    ``(k0, k1)`` tuple of (possibly per-lane) word arrays — the form
    :func:`lane_key_words` produces for iteration-batched wavefronts."""
    if isinstance(key, tuple):
        k0, k1 = key
        return k0.astype(jnp.uint32), k1.astype(jnp.uint32)
    kd = jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key.astype(jnp.uint32)
    kd = kd.reshape(-1)
    return kd[0], kd[-1]


def lane_key_words(keys: Array, lanes_per_key: int) -> tuple[Array, Array]:
    """Expand a [G]-batched key array to per-lane (k0, k1) words where lane
    ``l`` uses key ``l // lanes_per_key`` — the RNG plumbing for stacking G
    independent iterations into one wavefront (each group of lanes draws
    exactly the stream the unstacked iteration would). Feed the result to
    :class:`LaneSampler` as its ``key``."""
    kd = jax.vmap(jax.random.key_data)(keys).astype(jnp.uint32)  # [G, W]
    k0 = jnp.repeat(kd[:, 0], lanes_per_key)
    k1 = jnp.repeat(kd[:, -1], lanes_per_key)
    return k0, k1


def _bits_to_uniform(bits: Array) -> Array:
    """Top 24 bits -> [0, 1) float32."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


class LaneSampler:
    """Per-lane counter-based sampler: draw *i* for lane *l* is a pure
    function of ``(key, lane_id, i)``.

    This makes every random decision **sharding-invariant**: a lane produces
    the same stream no matter which device of the mesh owns it, so a
    tile-sharded render is bit-comparable to the single-device one (the
    reference gets cross-machine decorrelation from per-pixel curand states
    seeded by iteration, OptixRenderer_SpatialHash.cu:300-334; here it falls
    out of counter-based hashing).
    """

    def __init__(self, key: Array, lane_ids: Array,
                 cheap: bool | None = None):
        # ``cheap`` threads RenderConfig.use_cheap_random explicitly (the
        # integrators pass it); None falls back to the process default set
        # by set_rng_mode (tests/benchmarks).
        self._cheap = (_RNG_MODE == "cheap") if cheap is None else bool(cheap)
        lane_u32 = lane_ids.astype(jnp.uint32)
        if self._cheap:
            k0, k1 = _key_words(key)
            base = k0 ^ (k1 * jnp.uint32(0x9E3779B9))
            self._lane_base = _lowbias32(
                lane_u32 * jnp.uint32(0x85ebca6b) ^ base)
        else:
            self._k0, self._k1 = _key_words(key)
            self._lanes = lane_u32
        self._n = 0  # column counter; draw i = f(key, lane, column)

    # --- threefry path: one 2x32 pass per two columns ---
    def _tf_uniform(self, cols: int) -> Array:
        n_pairs = (cols + 1) // 2
        ctr = jnp.arange(n_pairs, dtype=jnp.uint32) + jnp.uint32(self._n)
        self._n += n_pairs
        # per-lane key words (iteration-batched wavefronts) broadcast over
        # the column axis; scalar words broadcast over everything
        k0 = self._k0[:, None] if jnp.ndim(self._k0) == 1 else self._k0
        k1 = self._k1[:, None] if jnp.ndim(self._k1) == 1 else self._k1
        b0, b1 = threefry2x32(k0, k1,
                              self._lanes[:, None],
                              jnp.broadcast_to(ctr, (1, n_pairs)))
        u = _bits_to_uniform(jnp.stack([b0, b1], axis=-1)
                             .reshape(self._lanes.shape[0], 2 * n_pairs))
        return u[:, :cols]

    # --- cheap path ---
    def _cheap_uniform(self, cols: int) -> Array:
        ctr = jnp.uint32(self._n)
        self._n += cols
        c = jnp.arange(cols, dtype=jnp.uint32)
        bits = _lowbias32(self._lane_base[:, None]
                          ^ ((ctr + c) * jnp.uint32(0x9E3779B9)))
        return _bits_to_uniform(bits)

    def _uniform(self, cols: int) -> Array:
        return self._cheap_uniform(cols) if self._cheap \
            else self._tf_uniform(cols)

    def next1(self) -> Array:
        return self._uniform(1)[:, 0]

    def next2(self) -> Array:
        return self._uniform(2)

    def next3(self) -> Array:
        return self._uniform(3)
