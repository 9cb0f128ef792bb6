"""A/B attribution of BVH traversal variants on the current backend.

Toggles {collapse sah/greedy} x {_CODE_STACK} x {_FLUSH_AT_LADDER} on a
1M-ray incoherent Atrium wave.
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

    configs = []
    for arg in sys.argv[1:]:
        f = arg.split(",")
        configs.append((f[0], f[1] == "1", f[2] == "1",
                        int(f[3]) if len(f) > 3 else 8,
                        int(f[4]) if len(f) > 4 else 4096,
                        int(f[5]) if len(f) > 5 else 8))   # arity
    if not configs:
        configs = [("greedy", False, False, 8, 4096, 8),  # round-4 baseline
                   ("sah", False, False, 8, 4096, 8),     # +DP collapse
                   ("sah", True, False, 8, 4096, 8),      # +hybrid stack
                   ("sah", True, True, 8, 4096, 8)]       # +ladder flush

    # re-permuting an already-permuted scene is fine; each config builds
    # its own tree from the same triangle soup
    scene0, cam = get_scene_by_name("Atrium")

    n = 1 << 20
    rng = np.random.default_rng(0)
    g = scene0.geometry
    mn = np.asarray(g.tri_v0).min(0)
    mx = (np.asarray(g.tri_v0) + np.asarray(g.tri_e1)).max(0)
    o = jnp.asarray(rng.uniform(mn, mx, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full((n,), 1e-3)
    tmax = jnp.full((n,), 1e30)

    ref = None
    for coll, cs, fl, div, lm, A in configs:
        B._CODE_STACK = cs
        B._FLUSH_AT_LADDER = fl
        B._LADDER_DIV = div
        B.LADDER_MIN = lm
        t0 = time.perf_counter()
        scene, bvh = B.build_scene_bvh(scene0, collapse=coll, arity=A)
        bt = time.perf_counter() - t0
        geom = scene.geometry
        f = jax.jit(lambda o, d: B.traverse(bvh, geom, o, d, tmin, tmax))
        t0 = time.perf_counter()
        out = f(o, d)
        jax.block_until_ready(out)
        ct = time.perf_counter() - t0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(o, d))
            ts.append(time.perf_counter() - t0)
        ms = statistics.median(ts) * 1e3
        t_np = np.asarray(out[0])
        if ref is None:
            ref = (np.asarray(scene.geometry.tri_v0), t_np)
            eq = "ref"
        else:
            # same geometry permutation not guaranteed across collapses;
            # compare hit distances only
            eq = ("t==" if np.allclose(ref[1], t_np, rtol=1e-5, atol=1e-5)
                  else "t DIFFERS")
        print(f"collapse={coll:6s} code_stack={int(cs)} flush_ladder="
              f"{int(fl)} div={div} lmin={lm} arity={A:2d} "
              f"stack={bvh.max_stack:2d} "
              f"build={bt:4.1f}s compile={ct:5.1f}s  {ms:7.1f} ms/M  "
              f"[{eq}]", flush=True)


if __name__ == "__main__":
    main()
