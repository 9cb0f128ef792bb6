"""Count REAL lockstep rounds of the quantized traversal on-chip.

Runs _solve with _COUNT_ROUNDS=True: every lane carries the number of
while-loop rounds executed while it was resident (across ladder levels),
so max(rounds) = total rounds the dispatch paid and the distinct values
mark ladder-level boundaries. Combined with wall time this yields
ms/round per level — the attribution the round-5 traversal work needs.
"""
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.accel import bvh as B
    from oppositerenderer.scene import get_scene_by_name

    code_stack = "--mask" not in sys.argv
    B._CODE_STACK = code_stack
    B._COUNT_ROUNDS = True
    scene0, cam = get_scene_by_name("Atrium")
    scene, bvh = B.build_scene_bvh(scene0, collapse="sah")
    geom = scene.geometry

    n = 1 << 20
    rng = np.random.default_rng(0)
    g = scene.geometry
    mn = np.asarray(g.tri_v0).min(0)
    mx = (np.asarray(g.tri_v0) + np.asarray(g.tri_e1)).max(0)
    o = jnp.asarray(rng.uniform(mn, mx, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e30)

    @jax.jit
    def run(o, d):
        st = B._init_state(bvh, o, d, tmin, tmax)
        st = B._solve(bvh, st, any_hit=False)
        return st["rounds"], st["t_best"]

    rounds, t = run(o, d)
    jax.block_until_ready(rounds)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(o, d))
        ts.append(time.perf_counter() - t0)
    ms = statistics.median(ts) * 1e3
    r = np.asarray(rounds)
    uniq, cnt = np.unique(r, return_counts=True)
    total = int(r.max())
    print(f"code_stack={code_stack} wall={ms:.1f} ms  total_rounds={total} "
          f"-> {ms / total * 1e3:.0f} us/round avg")
    # level boundaries: lanes dropped at a ladder boundary share a count
    print("rounds histogram (value: lanes)")
    for u, c in zip(uniq, cnt):
        if c > 50 or u == uniq[-1]:
            print(f"  {int(u):5d}: {int(c)}")


if __name__ == "__main__":
    main()
