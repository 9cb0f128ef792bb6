"""Per-pass cold-compile attribution for the CornellSmall 512^2 PPM
iteration. Run with the compile cache off (JAX_COMPILATION_CACHE_DIR
pointing at an empty directory) to see cold times:

    python scripts/ppm_compile_profile.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def t(name, build):
    t0 = time.perf_counter()
    build()
    print(f"{name:28s} {time.perf_counter() - t0:7.1f} s", flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import ppm
    from oppositerenderer.integrators.common import (pixel_coords,
                                                         scene_epsilon)
    from oppositerenderer.scene import get_scene_by_name

    scene, cam = get_scene_by_name("CornellSmall")
    cfg = RenderConfig(width=512, height=512,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    key = make_root_key(0)
    eps = scene_epsilon(scene)
    n = cfg.n_pixels
    px, py = pixel_coords(cfg.width, cfg.height)
    lanes = jnp.arange(n, dtype=jnp.int32)

    # warm the process (first jit absorbs backend init)
    t("warmup (trivial jit)", lambda: jax.jit(
        lambda x: x * 2).lower(jnp.ones((8, 8))).compile())

    sc = scene

    t("eye pass", lambda: jax.jit(
        lambda k: ppm.trace_eye_pass(sc, cam, cfg, k, eps, px, py, lanes)
    ).lower(key).compile())

    plane = jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32)
    t("photon pass", lambda: jax.jit(
        lambda k: ppm.trace_photon_pass(sc, cfg, k, eps, plane)
    ).lower(key).compile())

    from oppositerenderer.photon_map import (PhotonBatch,
                                                 build_photon_grid,
                                                 min_cell_size_for_window)
    P = cfg.photons_per_iteration * cfg.max_photon_deposits_per_emitted
    batch = PhotonBatch(position=jnp.zeros((P, 3)), power=jnp.zeros((P, 3)),
                        direction=jnp.zeros((P, 3)),
                        valid=jnp.zeros((P,), jnp.bool_))
    t("grid build", lambda: jax.jit(
        lambda b: build_photon_grid(b, cfg.photon_grid_resolution,
                                    min_cell_size=min_cell_size_for_window(
                                        jnp.float32(0.05), 4))
    ).lower(batch).compile())

    grid = build_photon_grid(batch, cfg.photon_grid_resolution,
                             min_cell_size=min_cell_size_for_window(
                                 jnp.float32(0.05), 4))
    from oppositerenderer.accel.pallas_gather import (
        gather_mode, gather_photons_tiled, ROWS, TILE)
    u = jnp.zeros((n // TILE, ROWS + 2))
    interpret = gather_mode(True, cfg.width, cfg.height) == "interpret"
    t("tiled gather (Triton)", lambda: jax.jit(
        lambda g, q: gather_photons_tiled(
            g, q, q, jnp.float32(0.05), u_rows=u, interpret=interpret)
    ).lower(grid, jnp.zeros((n, 3))).compile())

    t("FULL iteration", lambda: jax.jit(
        lambda k: ppm.render_iteration(sc, cam, cfg, jnp.int32(0), k,
                                       jnp.float32(0.0025))
    ).lower(key).compile())


if __name__ == "__main__":
    main()
