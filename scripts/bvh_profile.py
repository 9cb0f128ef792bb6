"""Diagnose the wide-BVH traversal cost: step counts vs per-step cost.

Instruments a copy of the traversal loop with round/lane counters and
ablates components (row gather only / no stack / no leaf MT) to attribute
per-step time. Drives the decisions recorded in accel/bvh.py + PERF.md.

Usage: python scripts/bvh_profile.py [--scene Atrium] [--n 1048576]
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def med(fn, reps=3):
    out = fn()
    jax_block(out)
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
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.accel import bvh as B
    from oppositerenderer.scene import get_scene_by_name

    scene, cam = get_scene_by_name(args.scene)
    bvh = scene.bvh
    geom = scene.geometry
    n = args.n
    print(f"device={jax.devices()[0]} scene={args.scene} n={n} "
          f"arity={bvh.arity} L={bvh.leaf_size} stack={bvh.max_stack} "
          f"rows={bvh.rows.shape}")

    rng = np.random.default_rng(0)
    mn = np.asarray(scene.aabb_min)
    mx = np.asarray(scene.aabb_max)
    o = jnp.asarray(rng.uniform(mn, mx, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e30)

    # per-lane visited counts from a python reference over a SAMPLE of
    # rays (algorithmic step counts, incl. re-visits)
    rows = np.asarray(bvh.rows)
    A = bvh.arity
    L = bvh.leaf_size
    m = 4096
    os_ = np.asarray(o[:m])
    ds_ = np.asarray(d[:m])
    steps = np.zeros(m, np.int32)
    leaf_steps = np.zeros(m, np.int32)
    for i in range(m):
        oi, di = os_[i], ds_[i]
        inv = 1.0 / np.where(np.abs(di) < 1e-12, 1e-12, di)
        t_best = 1e30
        stack = [(bvh.root_code, (1 << A) - 1)]
        while stack:
            code, mask = stack.pop()
            steps[i] += 1
            if code < 0:
                leaf_steps[i] += 1
                dec = -code - 1
                # skip actual MT; just cost accounting
                continue
            row = rows[code]
            ch = row[:6 * A].reshape(A, 6)
            valid = int(np.float32(row[7 * A]).view(np.int32))
            t0 = (ch[:, 0:3] - oi) * inv
            t1 = (ch[:, 3:6] - oi) * inv
            tn = np.maximum(np.minimum(t0, t1).max(axis=1), 1e-3)
            tf = np.minimum(np.maximum(t0, t1).min(axis=1), t_best)
            hit = (tn <= tf) & (((mask & valid) >> np.arange(A)) & 1
                                ).astype(bool)
            if not hit.any():
                continue
            codes = row[6 * A:7 * A].view(np.int32)
            jn = int(np.where(hit, tn, 1e30).argmin())
            if hit.sum() >= 2:
                rem = 0
                for k in range(A):
                    if hit[k] and k != jn:
                        rem |= 1 << k
                stack.append((code, rem))
            stack.append((int(codes[jn]), (1 << A) - 1))
    print(f"algorithmic steps/ray (no leaf-MT pruning): "
          f"p50={np.percentile(steps,50):.0f} p95={np.percentile(steps,95):.0f} "
          f"mean={steps.mean():.1f}  leaf p50={np.percentile(leaf_steps,50):.0f}"
          f" mean={leaf_steps.mean():.1f}")

    # ---- ablations on the real compiled loop ---------------------------
    # NB: everything must be jitted — eager dispatch pays the per-op
    # dispatch latency hundreds of times
    f_closest = jax.jit(lambda o, d: B.traverse(bvh, geom, o, d, tmin,
                                                tmax)[0])
    base = med(lambda: f_closest(o, d), args.reps)
    print(f"full closest {base*1e3:9.2f} ms ({base*1e9/n:.0f} ns/ray)")

    # gather-only floor: same wave shape, K rounds of just the row gather
    # + a cheap mix, K = measured mean steps
    K = int(steps.mean()) + 1
    R = bvh.rows.shape[0]
    W = bvh.rows.shape[1]
    idx0 = jnp.asarray((np.arange(n, dtype=np.int64) * 2654435761 % R
                        ).astype(np.int32))

    def gather_only(idx0):
        def body(k, c):
            idx, acc = c
            row = bvh.rows[idx]
            s = jnp.nan_to_num(jnp.sum(row[:, ::8], axis=1))
            # idx stream is a fixed LCG; the (s>1e30) term (always 0) keeps
            # the data dependency so XLA cannot hoist the gathers
            idx = (idx * 5 + 1 + (s > 1e30).astype(jnp.int32)) % R
            return idx, acc + s

        _, acc = jax.lax.fori_loop(0, K, body,
                                   (idx0, jnp.zeros((n,), jnp.float32)))
        return acc

    t = med(lambda: jax.jit(gather_only)(idx0), args.reps)
    print(f"gather-only floor ({K} rounds, full wave, no ladder) "
          f"{t*1e3:9.2f} ms -> {t*1e9/(n*K):.2f} ns/lane/step")

    # compute-only floors: leaf Moller-Trumbore block and inner slab block
    # on resident data (no gather), K rounds each
    L = bvh.leaf_size
    A = bvh.arity
    rng2 = np.random.default_rng(1)
    rowdat = jnp.asarray(rng2.normal(size=(n, W)).astype(np.float32))

    def mt_only(row):
        ob = o[:, None, :]
        db = d[:, None, :]

        def body(k, acc):
            tri = (row[:, :9 * L] + acc[:, None]).reshape(n, L, 9)
            v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
            pvec = jnp.cross(db, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
            tvec = ob - v0
            u = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1)
            v = jnp.sum(db * qvec, axis=-1) * inv_det
            t = jnp.sum(e2 * qvec, axis=-1) * inv_det
            ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
            tb = jnp.min(jnp.where(ok, t, 1e30), axis=1)
            return acc + jnp.where(tb < 1e30, tb, 0.0) * 1e-9

        return jax.lax.fori_loop(0, K, body, jnp.zeros((n,), jnp.float32))

    t = med(lambda: jax.jit(mt_only)(rowdat), args.reps)
    print(f"leaf-MT-only floor ({K} rounds) {t*1e3:9.2f} ms "
          f"-> {t*1e9/(n*K):.2f} ns/lane/step")

    def slab_only(row):
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        ob = o[:, None, :]

        def body(k, acc):
            ch = (row[:, :6 * A] + acc[:, None]).reshape(n, A, 6)
            t0 = (ch[..., 0:3] - ob) * inv_d[:, None, :]
            t1 = (ch[..., 3:6] - ob) * inv_d[:, None, :]
            tn = jnp.max(jnp.minimum(t0, t1), -1)
            tf = jnp.min(jnp.maximum(t0, t1), -1)
            key = jnp.where(tn <= tf, tn, 1e30)
            j = jnp.argmin(key, axis=1)
            return acc + j.astype(jnp.float32) * 1e-9

        return jax.lax.fori_loop(0, K, body, jnp.zeros((n,), jnp.float32))

    t = med(lambda: jax.jit(slab_only)(rowdat), args.reps)
    print(f"slab-only floor ({K} rounds)    {t*1e3:9.2f} ms "
          f"-> {t*1e9/(n*K):.2f} ns/lane/step")

    # stack-ops floor: one-hot read + write on [n, S]
    S = bvh.max_stack

    def stack_only(idx0):
        stack = jnp.zeros((n, S), jnp.int32)
        sp = idx0 % S

        def body(k, c):
            stack, sp = c
            m = jnp.arange(S)[None, :] == sp[:, None]
            top = jnp.sum(jnp.where(m, stack, 0), axis=1)
            stack = jnp.where(m, (top + k)[:, None], stack)
            sp = (sp + 1) % S
            return stack, sp

        stack, sp = jax.lax.fori_loop(0, K, body, (stack, sp))
        return stack[:, 0]

    t = med(lambda: jax.jit(stack_only)(idx0), args.reps)
    print(f"stack-ops floor ({K} rounds)    {t*1e3:9.2f} ms "
          f"-> {t*1e9/(n*K):.2f} ns/lane/step")


if __name__ == "__main__":
    main()
