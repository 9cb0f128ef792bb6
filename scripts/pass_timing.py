"""Per-pass device timing for PPM / VCM on the current backend.

Times each pass of the hot loop jitted in isolation (compile excluded,
median of N reps) so optimization effort goes where the milliseconds are.
Usage: python scripts/pass_timing.py [--size 512] [--reps 5] [--scene
CornellSmall] [--method ppm|vcm|both]
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


_printed = set()


def report(results):
    for k, v in results.items():
        if k not in _printed:
            print(f"{k:24s} {v * 1e3:9.2f} ms", flush=True)
            _printed.add(k)


def timeit(fn, reps):
    out = fn()            # compile + warm
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
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scene", default="CornellSmall")
    ap.add_argument("--method", default="ppm", choices=["ppm", "vcm", "both"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import (LaneSampler, iteration_key,
                                               make_root_key)
    from oppositerenderer.integrators import ppm, vcm
    from oppositerenderer.integrators.common import (pixel_coords,
                                                         scene_epsilon)
    from oppositerenderer.photon_map import (build_photon_grid,
                                                 gather_photons,
                                                 min_cell_size_for_window)
    from oppositerenderer.scene import get_scene_by_name

    scene, cam = get_scene_by_name(args.scene)
    W = H = args.size
    key = make_root_key(0)
    r2 = jnp.float32(0.002)
    radius = jnp.sqrt(r2)
    print(f"device={jax.devices()[0]} scene={args.scene} {W}x{H}")

    results = {}

    if args.method in ("ppm", "both"):
        cfg = RenderConfig(width=W, height=H,
                           render_method=RenderMethod.
                           PROGRESSIVE_PHOTON_MAPPING)
        sc = scene
        eps = scene_epsilon(sc)
        px, py = pixel_coords(W, H)
        lanes = jnp.arange(W * H, dtype=jnp.int32)
        plane = jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32)
        ekey = iteration_key(key, jnp.int32(0), ppm.PASS_PPM_EYE)
        pkey = iteration_key(key, jnp.int32(0), ppm.PASS_PPM_PHOTON)
        gkey = iteration_key(key, jnp.int32(0), ppm.PASS_PPM_ESTIMATE)

        eye_f = jax.jit(lambda k: ppm.trace_eye_pass(sc, cam, cfg, k, eps,
                                                     px, py, lanes))
        results["ppm_eye"] = timeit(lambda: eye_f(ekey), args.reps)
        report(results)

        photon_f = jax.jit(lambda k: ppm.trace_photon_pass(sc, cfg, k, eps,
                                                           plane))
        results["ppm_photon"] = timeit(lambda: photon_f(pkey), args.reps)
        report(results)

        photons, _vol, _stats = photon_f(pkey)
        mcs = min_cell_size_for_window(radius, 4)
        build_f = jax.jit(lambda ph: build_photon_grid(
            ph, cfg.photon_grid_resolution, min_cell_size=mcs))
        results["ppm_grid_build"] = timeit(lambda: build_f(photons),
                                           args.reps)
        report(results)

        grid = build_f(photons)
        hp = eye_f(ekey)
        s_g = LaneSampler(jax.random.fold_in(gkey, 55), lanes)
        us = s_g.next1()
        gather_f = jax.jit(lambda g, p, ns, u: gather_photons(
            g, p, ns, radius, max_cells_per_axis=4,
            budget_total=cfg.gather_photon_budget, u_stride=u))
        results["ppm_gather"] = timeit(
            lambda: gather_f(grid, hp.position, hp.ns, us), args.reps)
        report(results)

        full_f = jax.jit(lambda k: ppm.render_iteration(sc, cam, cfg,
                                                        jnp.int32(0), k, r2))
        results["ppm_full_iteration"] = timeit(lambda: full_f(key),
                                               args.reps)
        report(results)

    if args.method in ("vcm", "both"):
        cfg = RenderConfig(width=W, height=H,
                           render_method=RenderMethod.
                           VCM_BIDIRECTIONAL_PATH_TRACING)
        sc = scene
        eps = scene_epsilon(sc)
        px, py = pixel_coords(W, H)
        lanes = jnp.arange(W * H, dtype=jnp.int32)
        n = W * H
        eta = float(n) * jnp.pi * r2
        vc_w = vcm._mis(1.0 / eta)
        vm_w = jnp.zeros(())
        lkey = iteration_key(key, jnp.int32(0), vcm.PASS_VCM_LIGHT)
        ckey = iteration_key(key, jnp.int32(0), vcm.PASS_VCM_CAMERA)

        light_f = jax.jit(lambda k: vcm.trace_light_pass(
            sc, cam, cfg, k, eps, vc_w, vm_w, lanes, n))
        results["vcm_light"] = timeit(lambda: light_f(lkey), args.reps)
        report(results)

        store, _splat, _ = light_f(lkey)
        pair = jnp.arange(n, dtype=jnp.int32)
        camp_f = jax.jit(lambda k, s: vcm.trace_camera_pass(
            sc, cam, cfg, k, eps, vc_w, vm_w, s, n, px, py, lanes, pair))
        results["vcm_camera"] = timeit(lambda: camp_f(ckey, store),
                                       args.reps)
        report(results)

        full_f = jax.jit(lambda k: vcm.render_iteration(sc, cam, cfg,
                                                        jnp.int32(0), k, r2))
        results["vcm_full_iteration"] = timeit(lambda: full_f(key),
                                               args.reps)
        report(results)

    report(results)


if __name__ == "__main__":
    main()
