"""Intra-iteration sharding cost model on the 8-device virtual CPU mesh.

Times one sharded iteration per regime and reports wall + bytes moved:

* PPM, photon exchange ALL_TO_ALL (cell-owner partition, O(P/D)/chip)
* PPM, photon exchange ALL_GATHER (replicated grid, O(P)/chip)
* VCM, 1:1 paired stores (device-local light subpaths, no store traffic)
* VCM, uniform vertex sampling (global-store all_gather regime)

CPU wall times model RELATIVE phase costs only (a virtual mesh shares one
host's cores); the bytes columns are exact and are what the device
interconnect would carry. Writes the table to stdout as markdown.
"""
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def time_case(step, args, reps=3):
    out = step(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def main():
    from oppositerenderer.config import (PhotonExchange, RenderConfig,
                                             RenderMethod)
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.parallel import (make_mesh,
                                               make_sharded_render_fn)
    from oppositerenderer.scene import make_cornell_small

    scene, cam = make_cornell_small()
    mesh = make_mesh(8)
    key = make_root_key(0)
    size = 128
    photons = 1 << 16

    rows = []

    for name, exchange in (("ppm all_to_all", PhotonExchange.ALL_TO_ALL),
                           ("ppm all_gather", PhotonExchange.ALL_GATHER)):
        cfg = RenderConfig(width=size, height=size,
                           render_method=(
                               RenderMethod.PROGRESSIVE_PHOTON_MAPPING),
                           photons_per_iteration=photons,
                           photon_exchange=exchange)
        step = make_sharded_render_fn(scene, cam, cfg, mesh)
        dt, (img, stats) = time_case(step, (jnp.int32(0), key,
                                            jnp.float32(0.002)))
        # photon row = pos+pow+dir+valid ~ 37 B; all_to_all moves ~(D-1)/D
        # of P rows once, all_gather moves (D-1) copies of P rows
        row_b = 37
        moved = (photons * row_b * 7 // 8 if exchange ==
                 PhotonExchange.ALL_TO_ALL else photons * row_b * 7)
        rows.append((name, dt, moved / 1e6,
                     {k: int(v) for k, v in stats.items()
                      if "overflow" in k or "bytes" in k}))

    for name, uniform in (("vcm paired (local stores)", False),
                          ("vcm uniform (global store)", True)):
        cfg = RenderConfig(width=size, height=size,
                           render_method=(
                               RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING),
                           vcm_max_path_length=6,
                           vcm_uniform_vertex_sampling=uniform)
        step = make_sharded_render_fn(scene, cam, cfg, mesh)
        dt, (img, stats) = time_case(step, (jnp.int32(0), key,
                                            jnp.float32(0.002)))
        rows.append((name, dt, float(stats.get(
            "vcm_gathered_store_bytes_per_device", 0)) / 1e6,
            {k: int(v) for k, v in stats.items() if "bytes" in k}))

    print("| regime | wall/iter (8-dev virtual mesh) | data moved | "
          "stats |")
    print("|---|---|---|---|")
    for name, dt, mb, extra in rows:
        print(f"| {name} | {dt * 1e3:.0f} ms | {mb:.1f} MB | {extra} |")


if __name__ == "__main__":
    main()
