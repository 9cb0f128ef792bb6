"""Milestone config 4 (BASELINE.md): Sponza-class scene through the REAL
Collada file path at 1024^2 with BVH + textures, PPM and VCM-VC.

Two steps:

1. Vendor the asset: export the procedural Atrium (Sponza-class geometry,
   scene/atrium.py) to ``scenes/atrium_lite.dae`` + PNG textures — a real
   COLLADA file on disk, re-imported through the full loader
   (scene/collada.py: XML parse, material priority rules Scene.cpp:178-267,
   texture files, smooth normals Scene.cpp:96-108).
2. Render it at 1024^2 on the available device (PPM + VCM), write the
   images and a timing JSON under chiprun_out/milestone4/ (gitignored).

The intra-iteration tile/photon sharding of the same integrators is
equality-tested on the 8-device virtual mesh (tests/test_sharding.py) and
dry-run by the driver (__graft_entry__.dryrun_multichip); this script
covers the remaining pieces: the real file path and the 1024^2 scale.

Usage: python scripts/milestone4.py [--iters 16] [--size 1024] [--detail 0.25]
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def ensure_asset(base: str, detail: float) -> Path:
    """Vendored .dae for the flagship scenes. Full-detail exports are
    ~40-60 MB so they are .gitignored and re-exported deterministically
    on demand (the procedural factories are the source of truth)."""
    if base == "Atrium":
        name = "atrium_lite.dae" if detail < 1.0 else "atrium_full.dae"
        factory = f"Atrium:{detail}" if detail < 1.0 else "Atrium"
    else:
        name = "conference_full.dae"
        factory = "Conference" if detail >= 1.0 else f"Conference:{detail}"
    dae = REPO / "scenes" / name
    if dae.exists():
        return dae
    from oppositerenderer.scene import get_scene_by_name
    from oppositerenderer.scene.collada_export import export_collada
    scene, _cam = get_scene_by_name(factory)
    dae.parent.mkdir(exist_ok=True)
    export_collada(scene, dae)
    return dae


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--scene", default="Atrium",
                    choices=["Atrium", "Conference"])
    ap.add_argument("--methods", default="ppm,vcm")
    args = ap.parse_args()

    dae = ensure_asset(args.scene, args.detail)
    print(f"asset: {dae} ({dae.stat().st_size / 1e6:.1f} MB)")

    import jax

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.film import save_png
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name

    # per-phase load budget (round-2 verdict weak #8: 187.9 s unexplained)
    from oppositerenderer.scene import collada as _col
    t0 = time.perf_counter()
    scene, _file_cam = get_scene_by_name(str(dae))
    load_s = time.perf_counter() - t0
    load_phases = dict(getattr(_col, "LAST_LOAD_PHASES", {}))
    print("load phases:", {k: round(v, 2) for k, v in load_phases.items()})
    # the .dae carries no camera; use the factory viewpoint
    if args.scene == "Atrium":
        from oppositerenderer.scene.atrium import make_atrium
        _tiny, camera = make_atrium(0.1)
    else:
        from oppositerenderer.scene.conference import make_conference
        _tiny, camera = make_conference(0.1)
    del _tiny
    print(f"loaded {scene.geometry.n_triangles} tris in {load_s:.1f}s "
          f"(BVH: {scene.bvh is not None})")

    methods = {"ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
               "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
               "pt": RenderMethod.PATH_TRACING}
    art = REPO / "chiprun_out" / "milestone4"
    art.mkdir(parents=True, exist_ok=True)
    # merge into an existing record so `--methods vcm` refreshes one
    # method without clobbering the others' entries
    report_path = art / f"milestone4_{args.scene.lower()}.json"
    report = (json.loads(report_path.read_text())
              if report_path.exists() else {})
    report |= {"asset": str(dae.relative_to(REPO)),
              "triangles": int(scene.geometry.n_triangles),
              "resolution": f"{args.size}x{args.size}",
              "device": str(jax.devices()[0]), "load_seconds": round(load_s, 2),
              "load_phases": {k: round(v, 2)
                              for k, v in load_phases.items()}}
    for name in args.methods.split(","):
        # single-iteration dispatches: runtimes kill long single
        # dispatches, and a 30 s budget keeps every dispatch at one
        # iteration here
        cfg = RenderConfig(width=args.size, height=args.size,
                           render_method=methods[name],
                           iterations_per_dispatch=2,
                           dispatch_seconds_budget=30.0)
        r = Renderer(scene, camera, cfg, seed=0)
        t0 = time.perf_counter()
        r.render(1)
        compile_s = time.perf_counter() - t0
        # let any background throughput-tier compile land so the timed
        # iterations measure steady state (Renderer tiering)
        r.wait_for_compile_upgrade()
        t0 = time.perf_counter()
        r.render(args.iters - 1)
        dt = time.perf_counter() - t0
        out = art / f"{args.scene.lower()}_{args.size}_{name}.png"
        save_png(r.film, out)
        report[name] = {"iterations": args.iters,
                        "compile_seconds": round(compile_s, 1),
                        "seconds_per_iteration": round(dt / max(
                            1, args.iters - 1), 3),
                        "artifact": str(out.relative_to(REPO))}
        print(f"{name}: {report[name]}")
        # write after every method: a device fault in a later method must
        # not lose the finished ones
        (art / f"milestone4_{args.scene.lower()}.json").write_text(
            json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
