"""Explain where a GPU render of a golden leaves the CPU golden.

The CPU goldens (tests/goldens/goldens.npz) are rendered on the CPU. On the
GPU, transcendentals and FMA contraction differ in the last bits, and the
hypothesis is that this flips rare discrete decisions (Russian roulette,
a ray grazing an edge) on a few photon or eye paths, and that only pixels
whose gather box holds such a photon (or whose own eye path moved) leave
the golden. This script checks that for one scene and method (PPM):

    # on the GPU: render the golden and dump every pass's photons and
    # hitpoints
    python scripts/golden_flip_witness.py --dump chiprun_out/flip_witness.npz
    # on the CPU: recompute the same passes and explain the differing pixels
    JAX_PLATFORMS=cpu python scripts/golden_flip_witness.py \\
        --compare chiprun_out/flip_witness.npz

A pixel off the golden comparator's tolerance is explained when, in some
iteration, its eye hitpoint differs between the backends, or a photon
that differs between them (stored on one only, moved, or in another grid
cell) lies within the pixel's gather box (the radius plus one grid cell,
in every axis). The report gives, per cause, how many pixels it reaches
and how many of those are off.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from make_goldens import GOLDENS, ITERS, SEED, golden_config  # noqa: E402

# a photon "moved" when it is stored on one backend only or sits more than
# this share of a grid cell away (last-bit noise at coordinates of ~500
# units is ~1e-4, far below)
MOVED_CELL_FRACTION = 0.01


def passes(scene_name: str, method: str = "ppm"):
    """Per-iteration eye hitpoints, photons and grid geometry of the golden
    render, as numpy arrays, plus the golden image itself."""
    import jax
    import jax.numpy as jnp

    from oppositerenderer.core.rng import iteration_key
    from oppositerenderer.integrators import ppm
    from oppositerenderer.integrators.common import (pixel_coords,
                                                     scene_epsilon)
    from oppositerenderer.photon_map import (build_photon_grid,
                                             min_cell_size_for_window)
    from oppositerenderer.renderer import (Renderer,
                                           ppm_radius_sq_at_iteration)
    from oppositerenderer.scene import get_scene_by_name

    cfg = golden_config(method)
    scene, cam = get_scene_by_name(scene_name)
    r = Renderer(scene, cam, cfg, seed=SEED)
    W, H = cfg.width, cfg.height
    lanes = jnp.arange(W * H, dtype=jnp.int32)
    px, py = pixel_coords(W, H)

    @jax.jit
    def one(it, radius):
        eps = scene_epsilon(scene)
        hp = ppm.trace_eye_pass(
            scene, cam, cfg, iteration_key(r.root_key, it, ppm.PASS_PPM_EYE),
            eps, px, py, lanes)
        photons, _, _ = ppm.trace_photon_pass(
            scene, cfg, iteration_key(r.root_key, it, ppm.PASS_PPM_PHOTON),
            eps, jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32))
        grid = build_photon_grid(photons, cfg.photon_grid_resolution,
                                 min_cell_size=min_cell_size_for_window(
                                     radius, 4), sort_form="argsort")
        return (hp.position, hp.found, photons.position, photons.valid,
                grid.origin, grid.cell_size)

    out = {}
    for it in range(ITERS[method]):
        radius = ppm_radius_sq_at_iteration(r.ppm_initial_radius,
                                            cfg.ppm_alpha, it) ** 0.5
        names = ("hp_pos", "hp_found", "ph_pos", "ph_valid", "origin",
                 "cell")
        for name, a in zip(names, one(jnp.int32(it), jnp.float32(radius))):
            out[f"{name}_{it}"] = np.asarray(a)
        out[f"radius_{it}"] = np.float32(radius)
    out["image"] = np.asarray(r.render(ITERS[method]).mean_radiance())
    return out


def off_pixels(img: np.ndarray, want: np.ndarray) -> np.ndarray:
    """[H*W] bool: pixels outside tests/test_goldens.py's tolerance."""
    atol = 5e-3 * max(float(want.mean()), 0.01)
    bad = np.abs(img - want) > atol + 5e-3 * np.abs(want)
    return bad.reshape(-1, 3).any(axis=-1)


def explain(gpu: dict, cpu: dict, want: np.ndarray, iters: int) -> dict:
    """Per cause, the pixels a backend difference can reach and the off
    pixels it reaches: photons stored on one backend only or moved
    ("moved"), photons whose grid cell differs ("recelled": the grid's
    sorted order and so the gather's stride subsample change for every box
    holding that cell), and eye hitpoints that differ ("eye")."""
    off = off_pixels(gpu["image"], want)
    causes = {c: np.zeros_like(off) for c in ("moved", "recelled", "eye")}
    report = {"off": int(off.sum()), "pixels": int(off.size)}
    for it in range(iters):
        g = {k: gpu[f"{k}_{it}"] for k in ("hp_pos", "hp_found", "ph_pos",
                                          "ph_valid", "origin", "cell")}
        c = {k: cpu[f"{k}_{it}"] for k in g}
        cell = float(c["cell"])
        both = g["ph_valid"] & c["ph_valid"]
        dist = np.abs(g["ph_pos"] - c["ph_pos"]).max(-1)
        moved = (g["ph_valid"] != c["ph_valid"]) | (
            both & (dist > MOVED_CELL_FRACTION * cell))
        cells = [np.floor((x["ph_pos"] - x["origin"]) / float(x["cell"]))
                 for x in (g, c)]
        recelled = both & ~moved & (cells[0] != cells[1]).any(-1)
        reach = float(cpu[f"radius_{it}"]) + cell
        q = c["hp_pos"][c["hp_found"]]
        lanes = np.flatnonzero(c["hp_found"])
        for name, sel in (("moved", moved), ("recelled", recelled)):
            pts = np.concatenate([g["ph_pos"][sel & g["ph_valid"]],
                                  c["ph_pos"][sel & c["ph_valid"]]])
            for k in range(0, len(pts), 256):
                cheb = np.abs(q[:, None, :] - pts[None, k:k + 256]).max(-1)
                causes[name][lanes[(cheb <= reach).any(1)]] = True
        causes["eye"] |= (g["hp_found"] != c["hp_found"]) | (
            np.abs(g["hp_pos"] - c["hp_pos"]).max(-1) > MOVED_CELL_FRACTION
            * cell)
        report[f"iter{it}"] = dict(
            photons=int((g["ph_valid"] | c["ph_valid"]).sum()),
            moved=int(moved.sum()), recelled=int(recelled.sum()),
            grid_same=bool(np.allclose(g["origin"], c["origin"])
                           and np.isclose(g["cell"], c["cell"])))
    for name, reached in causes.items():
        report[f"reached_by_{name}"] = (f"{int(reached.sum())} pixels, "
                                        f"{int((reached & off).sum())} off")
    explained = np.logical_or.reduce(list(causes.values()))
    report["off_unexplained"] = int((off & ~explained).sum())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="Cornell")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", help="render on the GPU, write this .npz")
    mode.add_argument("--compare", help="recompute on the CPU against the "
                                        "GPU dump in this .npz")
    args = ap.parse_args(argv)
    import jax
    if args.dump:
        if jax.default_backend() != "gpu":
            raise SystemExit("--dump: JAX found no GPU")
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.dump, scene=args.scene, **passes(args.scene))
        print("wrote", args.dump)
        return 0
    if jax.default_backend() != "cpu":
        raise SystemExit("--compare runs on the CPU (JAX_PLATFORMS=cpu)")
    gpu = dict(np.load(args.compare))
    scene = str(gpu.pop("scene"))
    want = np.load(GOLDENS)[f"{scene}__ppm"].astype(np.float32)
    cpu = passes(scene)
    assert np.array_equal(off_pixels(cpu["image"], want),
                          np.zeros(want.shape[0] * want.shape[1], bool)), \
        "the CPU does not reproduce its own golden"
    report = explain(gpu, cpu, want, ITERS["ppm"])
    for k, v in report.items():
        print(f"{k}: {v}")
    return 0 if report["off_unexplained"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
