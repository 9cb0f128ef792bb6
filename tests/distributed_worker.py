"""Worker process for the real multi-process jax.distributed test.

Launched by tests/test_multiprocess.py (and scripts/scaling_bench.py) as
``python tests/distributed_worker.py <pid> <nproc> <port> <out.npz>
[iters] [size] [method]``. Each process joins the coordinator, renders its
strided share of iterations, merges across processes (an all-reduce),
and process 0 writes the merged film + timing.

JAX_PLATFORMS picks the backend (default cpu, one virtual device per
process). On the GPU each worker sees only card ``pid``: one process per
card, since a JAX process reserves most of a card's memory.
"""
import os
import sys
import time


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    out = sys.argv[4]
    iters = int(sys.argv[5]) if len(sys.argv) > 5 else 8
    size = int(sys.argv[6]) if len(sys.argv) > 6 else 32
    method_name = sys.argv[7] if len(sys.argv) > 7 else "pt"

    if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=1")
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = str(pid)
    import jax
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import numpy as np

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.parallel.distributed import MultiHostRenderer
    from oppositerenderer.scene import make_cornell_small

    method = {"pt": RenderMethod.PATH_TRACING,
              "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
              "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[method_name]
    scene, cam = make_cornell_small()
    cfg = RenderConfig(width=size, height=size, render_method=method,
                       photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       gather_photon_budget=64)
    mhr = MultiHostRenderer(scene, cam, cfg, seed=5)
    # compile + execute the exact run() paths (fused dispatch + merge)
    # outside the timed region (the reference also excludes its 60 s OptiX
    # JIT from render timing), then barrier so the timed window starts
    # simultaneously on every worker (compile skew otherwise counts
    # against the slowest starter)
    mhr.warmup()
    if nproc > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("bench_start")
    t0 = time.perf_counter()
    mine = tuple(range(pid, iters, nproc))
    mhr.render_iterations(mine)
    # materialize before splitting the clock: JAX dispatch is async, and
    # the local film is otherwise lazy (the multi-process merge blocks —
    # timing them differently would make the scaling number meaningless)
    mhr.local_film().accum.block_until_ready()
    render_dt = time.perf_counter() - t0
    film = mhr.merged_film()
    accum_host = np.asarray(film.accum)
    dt = time.perf_counter() - t0
    merge_dt = dt - render_dt
    if pid == 0:
        np.savez(out, accum=accum_host,
                 iterations=int(film.iterations), seconds=dt,
                 nproc=nproc, local_iterations=mhr.stats["iterations"],
                 render_seconds=render_dt, merge_seconds=merge_dt)


if __name__ == "__main__":
    main()
