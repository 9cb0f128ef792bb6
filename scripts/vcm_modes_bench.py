"""VCM estimator-mode cost table (round-3 verdict weak/next #8).

Times one fused CornellSmall 512^2 VCM iteration on the current backend
for the 4 combinations of vertex merging x uniform vertex sampling, and
reports the gathered-store bytes the sharded path would all_gather in the
global-store regimes (parallel/render.py).

Usage: python scripts/vcm_modes_bench.py [--size 512] [--reps 3]
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def jax_block(x):
    import jax
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import vcm
    from oppositerenderer.scene import get_scene_by_name

    scene, cam = get_scene_by_name("CornellSmall")
    key = make_root_key(0)
    print(f"device={jax.devices()[0]} CornellSmall {args.size}^2")

    for use_vm in (False, True):
        for uniform in (False, True):
            cfg = RenderConfig(
                width=args.size, height=args.size,
                render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
                vcm_use_vm=use_vm,
                vcm_uniform_vertex_sampling=uniform)
            f = jax.jit(lambda it, k, r2: vcm.render_iteration(
                scene, cam, cfg, it, k, r2)[0])
            t0 = time.perf_counter()
            out = f(jnp.int32(1), key, jnp.float32(0.0004))
            jax_block(out)
            compile_s = time.perf_counter() - t0
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax_block(f(jnp.int32(1), key, jnp.float32(0.0004)))
                ts.append(time.perf_counter() - t0)
            med = statistics.median(ts)
            # store bytes the SHARDED global-store regimes gather per
            # device: n_pixels paths x (max_path_length - 1) slots
            n = args.size * args.size
            slots = n * (cfg.vcm_max_path_length - 1)
            # LightVertexStore columns: pos3+wo3+thr3+dVCM+dVC+dVM+
            # mat+ns3+ng3+depth+valid ~= 20 f32
            store_mb = slots * 20 * 4 / 1e6
            print(f"vm={int(use_vm)} uniform={int(uniform)}: "
                  f"{med*1e3:7.1f} ms/iter  compile {compile_s:6.1f}s  "
                  f"(global-store regime gathers ~{store_mb:.0f} MB/device)"
                  if (use_vm or uniform) else
                  f"vm={int(use_vm)} uniform={int(uniform)}: "
                  f"{med*1e3:7.1f} ms/iter  compile {compile_s:6.1f}s  "
                  f"(local store, no gather)", flush=True)


if __name__ == "__main__":
    main()
