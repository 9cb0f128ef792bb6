"""Sweep the quantized-traversal schedule knobs on the current backend.

Knobs: _Q_SCHEDULE / dynamic phase selection / pend capacity /
compaction-ladder shape. Times closest-hit and any-hit traversal on an
incoherent 1M-ray wave over the full Atrium BVH for each variant, plus the
compile cost of the closest kernel, and prints one ns/ray table.

Usage: python scripts/q_sweep.py [--scene Atrium] [--n 1048576] [--reps 3]
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def med(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax_block(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def jax_block(x):
    import jax
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="Atrium")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="only the dynamic-K sweep")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.accel import bvh as B
    from oppositerenderer.scene import get_scene_by_name

    scene, cam = get_scene_by_name(args.scene)
    assert scene.bvh is not None and scene.bvh.q_rows is not None
    bvh, geom = scene.bvh, scene.geometry
    n = args.n
    print(f"device={jax.devices()[0]} scene={args.scene} n={n} "
          f"rows={tuple(bvh.rows.shape)} q_rows={tuple(bvh.q_rows.shape)}")

    rng = np.random.default_rng(11)
    mn, mx = np.asarray(scene.aabb_min), np.asarray(scene.aabb_max)
    o = jnp.asarray(rng.uniform(mn, mx, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e30)

    ref = {}

    def run_variant(tag, *, dynamic, k=2.0, schedule=None,
                    ladder_min=None, ladder_div=None, check=True):
        B._Q_DYNAMIC = dynamic
        B._Q_FLUSH_K = k
        if schedule is not None:
            B._Q_SCHEDULE = schedule
        if ladder_min is not None:
            B._LADDER_MIN_SAVE = getattr(B, "LADDER_MIN", None)
            B.LADDER_MIN = ladder_min
        if ladder_div is not None:
            B._LADDER_DIV = ladder_div

        fc = jax.jit(lambda o, d, tmin, tmax: B._traverse_impl(
            bvh, geom, o, d, tmin, tmax, any_hit=False))
        fa = jax.jit(lambda o, d, tmin, tmax: B._traverse_impl(
            bvh, geom, o, d, tmin, tmax, any_hit=True))
        t0 = time.perf_counter()
        out = fc(o, d, tmin, tmax)
        jax_block(out)
        compile_s = time.perf_counter() - t0
        tc = med(lambda: fc(o, d, tmin, tmax), args.reps)
        outa = fa(o, d, tmin, tmax)
        jax_block(outa)
        ta = med(lambda: fa(o, d, tmin, tmax), args.reps)
        if check:
            if not ref:
                ref["t"] = np.asarray(out[0])
                ref["i"] = np.asarray(out[1])
                ref["f"] = np.asarray(out[4])
                ref["fa"] = np.asarray(outa[4])
            else:
                np.testing.assert_array_equal(np.asarray(out[4]), ref["f"])
                np.testing.assert_array_equal(np.asarray(out[0]), ref["t"])
                np.testing.assert_array_equal(np.asarray(outa[4]),
                                              ref["fa"])
        print(f"{tag:34s} closest {tc*1e3:7.1f} ms ({tc/n*1e9:6.1f} ns/ray)"
              f"  anyhit {ta*1e3:7.1f} ms  compile {compile_s:6.1f} s",
              flush=True)
        return tc, ta

    # defaults snapshot
    SCHED0 = B._Q_SCHEDULE
    LM0, LD0 = B.LADDER_MIN, B._LADDER_DIV

    run_variant("static 2:1 (r3 baseline)", dynamic=False, schedule=SCHED0)
    for k in ([2.0] if args.quick else [1.0, 1.5, 2.0, 3.0]):
        run_variant(f"dynamic k={k}", dynamic=True, k=k)
    if not args.quick:
        run_variant("static 3:1", dynamic=False,
                    schedule=("i", "i", "i", "f", "i", "i", "i", "f"))
        B._Q_SCHEDULE = SCHED0
        run_variant("dynamic k=2 ladder_div=4", dynamic=True, k=2.0,
                    ladder_div=4)
        B._LADDER_DIV = LD0
        run_variant("dynamic k=2 ladder_min=8k", dynamic=True, k=2.0,
                    ladder_min=8192)
        B.LADDER_MIN = LM0
        run_variant("dynamic k=2 ladder_min=65k", dynamic=True, k=2.0,
                    ladder_min=65536)
        B.LADDER_MIN = LM0
    B._Q_SCHEDULE = SCHED0
    B.LADDER_MIN, B._LADDER_DIV = LM0, LD0


if __name__ == "__main__":
    main()
