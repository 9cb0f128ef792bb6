#!/usr/bin/env python3
"""Run the renderer's main path once on a GPU and check what comes out.

    python chip_smoke.py                 # phases 0-4 on one card
    python chip_smoke.py --four-cards    # phase 5 only: sharded PPM and VCM
                                         # on four cards vs one card
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
                                         # tiny sizes on the CPU, kernels in
                                         # the Pallas interpreter, no result

Phases (each prints its own lines; any failure ends the run non-zero):

0. device: JAX's device, the card's name and power limit, JAX version,
   XLA_FLAGS and the compile-cache directory;
1. kernel: the Triton tile photon gather compiled at 512^2 queries and
   1M photons, checked against its plain reference and timed against the
   XLA budgeted gather, then the whole PPM iteration on each route through
   the fused render path (times in ABBA pairs, image means must agree);
2. main path: ``cli.main`` for PT, PPM and VCM on CornellSmall at 512^2
   (PNG written), PT-vs-VCM energy agreement, one VCM iteration with
   vertex merging;
3. flagship: Conference (185k triangles, BVH wavefront) at 1024^2 under
   PT, and PPM on each gather route as in phase 1;
4. goldens and gradients: the 64^2 goldens against the CPU goldens through
   tests/test_goldens.py's cross-backend comparator; jax.grad of PT, and
   of a PPM iteration on the tile-gather route, vs finite differences.

The last line of standard output is the result as one JSON object. It is
printed only when JAX's first device is a GPU and every phase passed.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"
SEED = 7


# PT (5 segments with NEE) and VCM (paths up to 10) estimate the same
# integral on CornellSmall; the gap beyond 5 bounces is bounded at 4% by
# tests/test_vcm.py on this scene, and the image-mean noise of a few
# 512^2 iterations is well under 1%.
PT_VCM_RTOL = 0.06

# Tile vs XLA gather route, image means: both renderers share the seed, so
# chunk i of each uses the same eye and photon paths and only the gather's
# subsampling differs. The paired difference of chunk means must be noise:
# |t| <= 4 over the pairs (t with pairs-1 = 9 degrees of freedom: a false
# alarm about 3 runs in 1000), and the two means within 1%.
ROUTE_T_MAX = 4.0
ROUTE_MEAN_RTOL = 0.01



class Sizes:
    """Full sizes are the reference's (512^2 frames, 1M photons per
    iteration, the 1024^2 flagship); rehearsal sizes only exercise the
    control flow."""

    def __init__(self, rehearse: bool):
        self.frame = 32 if rehearse else 512
        self.photons = (1 << 12) if rehearse else (1 << 20)
        self.flagship = 32 if rehearse else 1024
        self.iters = 2 if rehearse else 4
        self.reps = 3 if rehearse else 10
        self.golden_scenes = 1 if rehearse else None
        # PT-vs-VCM energy tolerance (PT_VCM_RTOL); two 32^2 iterations
        # are too noisy for the full-size bound
        self.pt_vcm_rtol = 0.3 if rehearse else PT_VCM_RTOL
        # ROUTE_T_MAX, ROUTE_MEAN_RTOL: at 32^2 one 16x16 tile spans a
        # quarter of the frame, and the tile estimate, unbiased, is so
        # heavy-tailed that three pairs of chunks bound nothing
        self.route_bounds = ((float("inf"), float("inf")) if rehearse
                             else (ROUTE_T_MAX, ROUTE_MEAN_RTOL))


def log(*a):
    print(*a, flush=True)


def block(x):
    import jax
    return jax.tree_util.tree_map(lambda a: a.block_until_ready(), x)


def median_ms(fn, reps: int) -> float:
    """Median wall time of ``fn()`` in ms over ``reps`` runs, each ended
    with block_until_ready; the caller has warmed ``fn`` up."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not reported"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, None)}"
        for f in fields)


def gpu_name_and_power() -> str:
    """nvidia-smi in a child process that does not use JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device(rehearse: bool):
    import jax
    d = jax.devices()
    log(f"platform={d[0].platform} device_kind={d[0].device_kind} "
        f"count={len(d)}")
    if not rehearse:
        log(f"nvidia-smi: {gpu_name_and_power()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

# Kernel vs plain reference: the same intervals and weights summed in
# float32 in another order (up to 64 x 256 positive terms per query; the
# typical rounding is sqrt(n) * 6e-8 ~ 1e-5 relative, the bound n * 6e-8
# ~ 1e-3). 2e-4 of the query's own sum, plus 1e-6 of the largest sum for
# queries whose sum is ~0.
KERNEL_RTOL = 2e-4
KERNEL_ATOL_FRAC = 1e-6


def gather_inputs(frame: int, photons: int):
    """One real PPM iteration's gather inputs on CornellSmall: the photon
    grid, the eye pass's hitpoints and the gather uniforms."""
    import jax
    import jax.numpy as jnp

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import (LaneSampler, iteration_key,
                                           make_root_key)
    from oppositerenderer.integrators import ppm
    from oppositerenderer.integrators.common import (pixel_coords,
                                                     scene_epsilon)
    from oppositerenderer.photon_map import (build_photon_grid,
                                             min_cell_size_for_window)
    from oppositerenderer.renderer import Renderer, ppm_radius_sq_at_iteration
    from oppositerenderer.scene import get_scene_by_name

    W = H = frame
    n = W * H
    scene, cam = get_scene_by_name("CornellSmall")
    cfg = RenderConfig(width=W, height=H,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=photons,
                       photon_grid_sort="cosort")
    r0 = Renderer(scene, cam, cfg, seed=SEED).ppm_initial_radius
    radius = jnp.float32(ppm_radius_sq_at_iteration(r0, cfg.ppm_alpha, 0)
                         ** 0.5)

    @jax.jit
    def inputs(key):
        eps = scene_epsilon(scene)
        px, py = pixel_coords(W, H)
        lanes = jnp.arange(n, dtype=jnp.int32)
        hp = ppm.trace_eye_pass(
            scene, cam, cfg, iteration_key(key, 0, ppm.PASS_PPM_EYE), eps,
            px, py, lanes)
        photons, _, _ = ppm.trace_photon_pass(
            scene, cfg, iteration_key(key, 0, ppm.PASS_PPM_PHOTON), eps,
            jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32))
        grid = build_photon_grid(photons, cfg.photon_grid_resolution,
                                 min_cell_size=min_cell_size_for_window(
                                     radius, 4), sort_form="cosort")
        u = LaneSampler(jax.random.fold_in(key, 55), lanes).next1()
        return grid, hp.position, hp.ns, hp.found, u

    grid, pos, nrm, found, u = block(inputs(make_root_key(SEED)))
    return scene, cam, cfg, radius, grid, pos, nrm, found, u


def phase_kernel(sz: Sizes, interpret: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.accel import pallas_gather as tg
    from oppositerenderer.photon_map import gather_photons

    W = H = sz.frame
    n = W * H
    scene, cam, cfg, radius, grid, pos, nrm, found, u = gather_inputs(
        sz.frame, sz.photons)
    log(f"photons stored {int(grid.n_valid)} of capacity "
        f"{grid.position.shape[0]}; queries {n}; radius {float(radius):.5g}")
    perm = jnp.asarray(tg.tile_block_order(W, H)[0])
    u_rows = u.reshape(n // tg.TILE, tg.TILE)[:, :tg.ROWS + 2]
    args = (grid, pos[perm], nrm[perm], found[perm], u_rows)

    kernel = jax.jit(lambda g, p, q, v, ur: tg.gather_photons_tiled(
        g, p, q, radius, u_rows=ur, valid=v, interpret=interpret)[0])
    reference = jax.jit(lambda g, p, q, v, ur:
                        tg.gather_photons_tiled_reference(
                            g, p, q, radius, u_rows=ur, valid=v))
    xla = jax.jit(lambda g, p, q, uu: gather_photons(
        g, p, q, radius, max_cells_per_axis=4,
        budget_total=cfg.gather_photon_budget, u_stride=uu)[0])

    t0 = time.perf_counter()
    got = np.asarray(block(kernel(*args)))
    log(f"kernel compile+first run {time.perf_counter() - t0:.2f} s")
    want = np.asarray(block(reference(*args)))
    assert got.shape == (n, 3) and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert scale > 0, "reference gathered no power"
    err = np.abs(got - want)
    bound = KERNEL_RTOL * np.abs(want) + KERNEL_ATOL_FRAC * scale
    worst = float((err / bound).max())
    log(f"kernel vs reference: max abs err {float(err.max()):.3e} "
        f"(max |ref| {scale:.3e}); worst err/tolerance {worst:.3f} "
        f"(tolerance {KERNEL_RTOL:g} rel + {KERNEL_ATOL_FRAC:g} of max)")
    assert worst <= 1.0, "tile gather disagrees with its plain reference"

    x_out = np.asarray(block(xla(grid, pos, nrm, u)))
    inv = tg.tile_block_order(W, H)[1]
    ratio = float(got[inv][np.asarray(found)].sum()
                  / max(x_out[np.asarray(found)].sum(), 1e-30))
    log(f"tile-gather / XLA-gather total power on this input: {ratio:.4f} "
        "(equal in expectation only: different subsampling)")

    t_k = median_ms(lambda: kernel(*args), sz.reps)
    t_x = median_ms(lambda: xla(grid, pos, nrm, u), sz.reps)
    log(f"gather alone, median of {sz.reps}: tile kernel {t_k:.3f} ms, "
        f"XLA budget-{cfg.gather_photon_budget} gather {t_x:.3f} ms")

    gather_routes(scene, cam, cfg, sz, f"CornellSmall {W}^2", per_call=4,
                  fused=True)


def step_times(r, n: int) -> list[float]:
    """ms of ``n`` render_next_iteration calls (the per-iteration step
    the CLI dispatches; each blocks on the film). The first includes the
    compile."""
    ms = []
    for _ in range(n):
        ms.append(r.render_next_iteration()["iteration_seconds"] * 1e3)
    return ms


def gather_routes(scene, cam, cfg, sz: Sizes, label: str, per_call: int,
                  fused: bool):
    """The whole PPM iteration on each gather route, timed in ABBA pairs
    of calls. ``fused``: ``Renderer.render(per_call)`` with the co-sort grid
    (the path batch renders run), its step compiled ahead of time and
    handed to the renderer; else ``render_next_iteration`` (the
    per-iteration step; at flagship sizes it is the co-sort graph too).
    Asserts that the routes agree on the image mean (ROUTE_T_MAX)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.renderer import Renderer

    cfg = cfg.replace(photon_grid_sort="cosort", dispatch_seconds_budget=0.0,
                      iterations_per_dispatch=per_call)
    rs = {}
    for name, flag in (("tile", True), ("xla", False)):
        r = Renderer(scene, cam, cfg.replace(use_pallas_gather=flag),
                     seed=SEED)
        t0 = time.perf_counter()
        if fused:
            compiled = jax.jit(r._build_fused(r.cfg)).lower(
                r.camera, jnp.int32(0), r.root_key, jnp.int32(1),
                jnp.int32(1)).compile()
            r._compiled[("multi", r.cfg)] = compiled
            block(r.render(1).accum)
        else:
            compiled = r._step_fn().lower(
                r.camera, jnp.int32(0), r.root_key,
                jnp.float32(0.0)).compile()
            r._compiled[("single", r.cfg)] = compiled
            r.render_next_iteration()
        log(f"{label} ppm ({name} gather): compile + first iteration "
            f"{time.perf_counter() - t0:.1f} s; {memory_line(compiled)}")
        rs[name] = r
    ms = {name: [] for name in rs}
    means = {name: [] for name in rs}
    for i in range(sz.reps):
        for name in (("tile", "xla") if i % 2 == 0 else ("xla", "tile")):
            r = rs[name]
            before = r.film.accum
            t0 = time.perf_counter()
            if fused:
                r.render(per_call)
            else:
                r.render_next_iteration()
            ms[name].append((time.perf_counter() - t0) * 1e3 / per_call)
            means[name].append(float(jnp.mean(r.film.accum - before))
                               / per_call)
    for name, r in rs.items():
        q1, q2, q3 = statistics.quantiles(ms[name], n=4)
        log(f"{label} ppm ({name} gather): ms/iteration quartiles "
            f"{q1:.2f} / {q2:.2f} / {q3:.2f} over {sz.reps} calls of "
            f"{per_call}")
        img = np.asarray(r.film.mean_radiance())
        assert np.isfinite(img).all() and img.mean() > 1e-3, name
    d_ms = [t - x for t, x in zip(ms["tile"], ms["xla"])]
    log(f"{label} ppm: tile minus xla per pair, median "
        f"{statistics.median(d_ms):.3f} ms (min {min(d_ms):.3f}, max "
        f"{max(d_ms):.3f}); tile faster in {sum(d < 0 for d in d_ms)} of "
        f"{sz.reps}")
    d = np.asarray(means["tile"]) - np.asarray(means["xla"])
    m_x = float(np.mean(means["xla"]))
    t = float(d.mean() / max(d.std(ddof=1) / np.sqrt(d.size), 1e-30))
    rel = float(d.mean()) / m_x
    t_max, mean_rtol = sz.route_bounds
    log(f"{label} ppm: image mean tile {float(np.mean(means['tile'])):.6f} "
        f"vs xla {m_x:.6f}: rel {rel:.2e} (bound {mean_rtol}), paired "
        f"t {t:.2f} (bound {t_max})")
    assert abs(t) <= t_max and abs(rel) <= mean_rtol, \
        "the tile and XLA gathers disagree on the image mean"
    peak = peak_bytes()
    log(f"{label} ppm: device peak_bytes_in_use so far {peak}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def run_cli(argv: list[str]) -> list[float]:
    """cli.main in this process; echoes its output and returns the
    per-iteration milliseconds it printed."""
    from oppositerenderer import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log("  cli| " + line)
    assert rc == 0, f"cli returned {rc}"
    return [float(m) for m in re.findall(r"^iter\s+\d+\s+([\d.]+) ms",
                                         text, re.M)]


def report_step(label: str, r, ms: list[float]):
    """Steady ms/iteration, compile seconds, memory of the step."""
    import jax.numpy as jnp

    steady = statistics.median(ms[1:]) if len(ms) > 1 else float("nan")
    compile_s = (ms[0] - steady) / 1e3 if len(ms) > 1 else float("nan")
    compiled = r._step_fn().lower(
        r.camera, jnp.int32(0), r.root_key, jnp.float32(0.0)).compile()
    log(f"{label}: {steady:.2f} ms/iteration (median of {len(ms) - 1}), "
        f"compile ~{compile_s:.1f} s (first iteration minus steady)")
    log(f"{label}: {memory_line(compiled)}")
    log(f"{label}: device peak_bytes_in_use so far {peak_bytes()}")


def phase_main_path(sz: Sizes):
    import numpy as np

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.film import load_checkpoint
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name

    OUT.mkdir(parents=True, exist_ok=True)
    methods = {"pt": RenderMethod.PATH_TRACING,
               "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
               "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}
    scene, cam = get_scene_by_name("CornellSmall")
    means = {}
    for m, method in methods.items():
        png, ckpt = OUT / f"cornell_{m}.png", OUT / f"cornell_{m}.npz"
        ms = run_cli(["--scene", "CornellSmall", "--method", m,
                      "--size", str(sz.frame), "--iterations", str(sz.iters),
                      "--photons", str(sz.photons), "--seed", str(SEED),
                      "--preview-every", "0", "--output", str(png),
                      "--checkpoint", str(ckpt)])
        assert len(ms) == sz.iters, ms
        film, _, _, _ = load_checkpoint(ckpt)
        img = np.asarray(film.mean_radiance())
        assert img.shape == (sz.frame, sz.frame, 3)
        assert np.isfinite(img).all(), f"{m}: non-finite radiance"
        assert img.mean() > 1e-3, f"{m}: black image"
        assert png.stat().st_size > 0
        means[m] = float(img.mean())
        log(f"{m}: mean radiance {means[m]:.5f}, wrote {png.name}")
        cfg = RenderConfig(width=sz.frame, height=sz.frame,
                           render_method=method,
                           photons_per_iteration=sz.photons)
        report_step(f"CornellSmall {sz.frame}^2 {m}",
                    Renderer(scene, cam, cfg, seed=SEED), ms)
    rel = abs(means["vcm"] - means["pt"]) / means["pt"]
    log(f"PT vs VCM mean radiance: {means['pt']:.5f} vs {means['vcm']:.5f},"
        f" rel diff {rel:.4f} (tolerance {sz.pt_vcm_rtol})")
    assert rel <= sz.pt_vcm_rtol, "PT and VCM disagree on the image energy"

    cfg_vm = RenderConfig(width=sz.frame, height=sz.frame,
                          render_method=methods["vcm"], vcm_use_vm=True,
                          photons_per_iteration=sz.photons)
    r = Renderer(scene, cam, cfg_vm, seed=SEED)
    t0 = time.perf_counter()
    r.render(1)
    t1 = time.perf_counter()
    r.render(1)
    t2 = time.perf_counter()
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all() and img.mean() > 1e-3
    log(f"VCM with vertex merging (XLA merge): first {t1 - t0:.2f} s, "
        f"second {(t2 - t1) * 1e3:.1f} ms, mean {float(img.mean()):.5f}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_flagship(sz: Sizes):
    import numpy as np

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name

    t0 = time.perf_counter()
    scene, cam = get_scene_by_name("Conference")
    log(f"Conference: {scene.geometry.n_triangles} triangles, BVH "
        f"{'built' if scene.bvh is not None else 'MISSING'} "
        f"({time.perf_counter() - t0:.1f} s to load)")
    assert scene.bvh is not None
    S = sz.flagship
    cfg = RenderConfig(width=S, height=S,
                       render_method=RenderMethod.PATH_TRACING)
    r = Renderer(scene, cam, cfg, seed=SEED)
    ms = step_times(r, sz.iters)
    img = np.asarray(r.film.mean_radiance())
    assert np.isfinite(img).all() and img.mean() > 1e-3
    report_step(f"Conference {S}^2 pt", r, ms)
    log(f"Conference pt: mean radiance {float(img.mean()):.5f}")
    gather_routes(scene, cam, cfg.replace(
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
        photons_per_iteration=sz.photons), sz, f"Conference {S}^2",
        per_call=1, fused=False)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def precompile(jobs, threads: int = 8):
    """Run the ``jobs`` (thunks that lower and compile) on ``threads``
    threads, so the sequential renders after them find their executables
    in the persistent compile cache: XLA compiles release the GIL. Without
    a cache directory there is nothing to share, and it does nothing."""
    import jax
    from concurrent.futures import ThreadPoolExecutor

    if not jax.config.jax_compilation_cache_dir:
        return
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        for f in [ex.submit(job) for job in jobs]:
            f.result()
    log(f"precompiled {len(jobs)} executables on {threads} threads in "
        f"{time.perf_counter() - t0:.1f} s")


def fused_step_compile(scene_name: str, cfg):
    """Thunk: compile Renderer.render's fused step for one scene/config."""
    def job():
        import jax
        import jax.numpy as jnp

        from oppositerenderer.renderer import Renderer
        from oppositerenderer.scene import get_scene_by_name

        scene, cam = get_scene_by_name(scene_name)
        r = Renderer(scene, cam, cfg, seed=SEED)
        jax.jit(r._build_fused(r.cfg)).lower(
            r.camera, jnp.int32(0), r.root_key, jnp.int32(1),
            jnp.int32(1)).compile()
    return job


def phase_goldens_and_grads(sz: Sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(REPO / "tests"))
    import test_goldens as tgold

    from oppositerenderer import diff
    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import ppm, pt
    from oppositerenderer.scene import make_cornell_small

    scenes = tgold.SCENES[:sz.golden_scenes]
    precompile([fused_step_compile(name, tgold.golden_config(m))
                for m in ("pt", "ppm", "vcm") for name in scenes])
    goldens = np.load(tgold.GOLDENS)
    for method in ("pt", "ppm", "vcm"):
        t0 = time.perf_counter()
        worst_off, worst_rel = 0, 0.0
        for scene_name in scenes:
            want = goldens[f"{scene_name}__{method}"].astype(np.float32)
            off, rel = tgold.assert_matches_golden_across_backends(
                tgold._render(scene_name, method), want, method,
                f"{scene_name} {method}")
            log(f"  golden {scene_name} {method}: {off} pixels off, image "
                f"mean rel diff {rel:.2e}")
            worst_off, worst_rel = max(worst_off, off), max(worst_rel, rel)
        share, mean_rtol = tgold.CROSS_BACKEND_BOUNDS[method]
        log(f"goldens {method}: every scene matches the CPU goldens; worst "
            f"{worst_off} pixels off (bound {share:.1%} of the pixels), "
            f"image mean {worst_rel:.2e} (bound {mean_rtol:g}); "
            f"{time.perf_counter() - t0:.1f} s")

    scene, cam = make_cornell_small()
    key = make_root_key(12)
    cfg = RenderConfig(width=24, height=24,
                       render_method=RenderMethod.PATH_TRACING,
                       pt_max_segments_nee=3, path_rr_start_depth=9)

    def pt_loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        return sum(jnp.mean(pt.render_iteration(s, cam, cfg, jnp.int32(i),
                                                key)) for i in range(2)) / 2

    g = float(jax.grad(pt_loss)(1.0))
    fd = float((pt_loss(1.0 + 1e-3) - pt_loss(1.0 - 1e-3)) / 2e-3)
    log(f"PT d(mean)/d(kd scale): grad {g:.6f} vs finite difference "
        f"{fd:.6f} (tolerance 2% as tests/test_grad.py)")
    assert g > 0 and abs(g - fd) <= 0.02 * abs(fd)

    cfg_ppm = RenderConfig(width=32, height=32,
                           render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                           photons_per_iteration=1 << 12,
                           photon_grid_resolution=16,
                           photon_rr_start_depth=9, max_photon_trace_depth=4)

    @jax.jit
    def ppm_loss(kd_scale):
        s = diff.set_material_param(scene, "kd", 0,
                                    scene.materials.kd[0] * kd_scale)
        img, _ = ppm.render_iteration(
            s, cam, cfg_ppm.replace(use_pallas_gather=True), jnp.int32(0),
            key, jnp.float32(0.003))
        return jnp.mean(img)

    g = float(jax.grad(ppm_loss)(1.0))
    fd = float((ppm_loss(1.0 + 1e-3) - ppm_loss(1.0 - 1e-3)) / 2e-3)
    log(f"PPM d(mean)/d(kd scale) through the tile gather: grad {g:.6f} vs "
        f"finite difference {fd:.6f} (tolerance 3% as tests/test_grad.py)")
    assert g > 0 and abs(g - fd) <= 0.03 * abs(fd)


# ---------------------------------------------------------------------------
# phase 5 (--four-cards)
# ---------------------------------------------------------------------------

# Sharded PPM (cell-owner all_to_all, tile gather on each device's partial
# grid) subsamples over-full tiles per partition, so it equals the
# one-card render only in expectation: image means within 3%. Sharded VCM
# uses the same per-lane random streams as one card: equal up to float
# noise except at silhouette pixels where a shadow-ray decision flips
# (tests/test_sharding.py bounds those at 0.3% of pixels).
SHARDED_PPM_MEAN_RTOL = 0.03


def phase_four_cards(sz: Sizes, n_cards: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.core.rng import make_root_key
    from oppositerenderer.integrators import ppm, vcm
    from oppositerenderer.parallel import make_mesh, make_sharded_render_fn
    from oppositerenderer.scene import make_cornell_small

    assert len(jax.devices()) >= n_cards, jax.devices()
    scene, cam = make_cornell_small()
    key = make_root_key(SEED)
    it = jnp.int32(2)
    r2 = jnp.float32(2e-4)
    mesh = make_mesh(n_cards)
    for m, method, one in (
            ("ppm", RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
             ppm.render_iteration),
            ("vcm", RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
             vcm.render_iteration)):
        cfg = RenderConfig(width=sz.frame, height=sz.frame,
                           render_method=method,
                           photons_per_iteration=sz.photons,
                           photon_grid_sort="cosort")
        step = make_sharded_render_fn(scene, cam, cfg, mesh)
        t0 = time.perf_counter()
        sharded, _ = block(step(it, key, r2))
        log(f"sharded {m} on {n_cards} cards: compile+first "
            f"{time.perf_counter() - t0:.2f} s")
        devs = {s.device for s in sharded.addressable_shards}
        assert len(devs) == n_cards, f"output on {devs}"
        rows = {s.data.shape[0] for s in sharded.addressable_shards}
        assert rows == {sz.frame // n_cards}, rows
        t_sh = median_ms(lambda: step(it, key, r2), sz.reps)
        single = jax.jit(lambda i, k, r: one(scene, cam, cfg, i, k, r))
        ref, _ = block(single(it, key, r2))
        t_one = median_ms(lambda: single(it, key, r2), sz.reps)
        a, b = np.asarray(sharded), np.asarray(ref)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        diff_max = float(np.abs(a - b).max())
        rel_mean = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        log(f"{m} {sz.frame}^2: sharded {t_sh:.2f} ms vs one card "
            f"{t_one:.2f} ms per iteration; largest pixel difference "
            f"{diff_max:.4g} (max {float(b.max()):.4g}); image means "
            f"{float(a.mean()):.5f} vs {float(b.mean()):.5f} "
            f"(rel {rel_mean:.4f})")
        if m == "ppm":
            assert rel_mean <= SHARDED_PPM_MEAN_RTOL
        else:
            viol = ~np.isclose(a, b, rtol=2e-3, atol=2e-4)
            flipped = int(np.any(viol.reshape(-1, 3), axis=-1).sum())
            log(f"vcm pixels off float tolerance: {flipped} of "
                f"{a.size // 3} (bound {a.size // 3 // 333})")
            assert flipped <= max(3, a.size // 3 // 333)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 4-card phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes; prints no result")
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (default 0-4)")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: JAX found no GPU (platform {platform!r})",
              file=sys.stderr)
        return 1
    interpret = platform != "gpu"
    sz = Sizes(args.rehearse)
    if args.four_cards:
        phases = [("sharded PPM and VCM on four cards vs one",
                   lambda: phase_four_cards(sz, 4))]
        count = 4
    else:
        wanted = {int(p) for p in args.phases.split(",")}
        table = {0: ("device", lambda: phase_device(args.rehearse)),
                 1: ("tile photon gather", lambda: phase_kernel(sz, interpret)),
                 2: ("main path (cli)", lambda: phase_main_path(sz)),
                 3: ("flagship Conference", lambda: phase_flagship(sz)),
                 4: ("goldens and gradients",
                     lambda: phase_goldens_and_grads(sz))}
        phases = [(f"{i} {table[i][0]}", table[i][1]) for i in sorted(wanted)]
        count = len(devices)
    t_all = time.perf_counter()
    for name, fn in phases:
        log(f"== phase {name}")
        t0 = time.perf_counter()
        fn()
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    log(f"all phases ok in {time.perf_counter() - t_all:.1f} s")
    if args.rehearse:
        return 0
    log(f"card: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
