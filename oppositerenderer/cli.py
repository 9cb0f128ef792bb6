"""Command-line renderer — the Standalone application analog.

The reference's Standalone.exe (Qt GUI + render thread,
``Standalone/standalone.cpp``, ``StandaloneRenderManager.cpp``) maps to a
headless progressive loop: pick scene + method, render iterations, write a
preview image every few iterations (the reference displays every 5th frame,
StandaloneRenderManager.cpp:91-124), print the RenderStatisticsModel-style
stats line, checkpoint/resume. Camera overrides stand in for the mouse
interactions (util/Mouse.cpp orbit/pan/dolly -> --eye/--lookat/--fov,
--dolly/--pan).

Usage examples:
  python -m oppositerenderer.cli --scene CornellSmall --method vcm \
      --size 256 --iterations 64 --output out.png
  python -m oppositerenderer.cli --scene scenes/sponza.obj --method ppm \
      --checkpoint run.npz --resume
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opposite-renderer",
        description="progressive renderer (PT / PPM / VCM)")
    p.add_argument("--scene", default="CornellSmall",
                   help="built-in scene name or .dae/.obj path")
    p.add_argument("--method", default="vcm",
                   choices=["pt", "ppm", "vcm"],
                   help="render method (reference default is VCM)")
    p.add_argument("--size", type=int, default=512,
                   help="square output resolution (default 512, ref default)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--iterations", "-n", type=int, default=32)
    p.add_argument("--output", "-o", default="render.png",
                   help=".png or .tga output")
    p.add_argument("--preview-every", type=int, default=5,
                   help="write the output every N iterations (0 = end only)")
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--photons", type=int, default=1 << 20,
                   help="photons per PPM iteration")
    p.add_argument("--ppm-radius", type=float, default=None,
                   help="initial PPM radius (default: scene heuristic)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save to after rendering")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    # device pick (the reference's console device prompt,
    # Standalone/standalone.cpp + ComputeDeviceRepository)
    p.add_argument("--list-devices", action="store_true",
                   help="print the compute-device table and exit")
    p.add_argument("--device", type=int, default=None,
                   help="render on this device ordinal (default: first)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler trace of the render loop "
                        "into LOGDIR (view with TensorBoard/Perfetto)")
    # camera overrides (Mouse.cpp interaction analogs)
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--aperture", type=float, default=None)
    p.add_argument("--dolly", type=float, default=None,
                   help="move eye toward lookat by this fraction")
    p.add_argument("--pan", type=float, nargs=2, default=None,
                   help="pan in image plane (u, v)")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live progressive viewer on this port "
                        "instead of batch rendering (the Gui analog: image, "
                        "stats, settings, camera pad)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.list_devices:
        from .devices import ComputeDeviceRepository
        print(ComputeDeviceRepository.enumerate().table())
        return 0
    if args.device is not None:
        import jax
        from .devices import ComputeDeviceRepository
        desc, dev = ComputeDeviceRepository.enumerate().pick(args.device)
        if not args.quiet:
            print(f"rendering on {desc.summary()}")
        jax.config.update("jax_default_device", dev)

    from .camera import Camera
    from .config import RenderConfig, RenderMethod
    from .film import save_png, save_tga
    from .renderer import Renderer
    from .scene import get_scene_by_name

    method = {"pt": RenderMethod.PATH_TRACING,
              "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
              "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
              }[args.method]
    w = args.width or args.size
    h = args.height or args.size
    cfg = RenderConfig(width=w, height=h, render_method=method,
                       photons_per_iteration=args.photons,
                       gamma=args.gamma)

    t0 = time.perf_counter()
    scene, camera = get_scene_by_name(args.scene)
    if not args.quiet:
        print(f"scene '{scene.name}': {scene.geometry.n_triangles} tris, "
              f"{scene.geometry.n_spheres} spheres, "
              f"{scene.lights.n_lights} lights "
              f"(loaded in {time.perf_counter() - t0:.2f}s)")

    # camera overrides
    if args.eye or args.lookat or args.fov or args.aperture is not None:
        import numpy as np
        eye = args.eye or tuple(np.asarray(camera.eye))
        lookat = args.lookat or tuple(np.asarray(camera.lookat))
        fov = args.fov or camera.hfov
        ap = args.aperture if args.aperture is not None \
            else float(camera.aperture)
        camera = Camera.make(eye, lookat, hfov=fov, vfov=fov, aperture=ap)
    if args.dolly:
        camera = camera.dolly(args.dolly)
    if args.pan:
        camera = camera.translate(*args.pan)

    if args.serve is not None:
        from .viewer import serve
        serve(scene, camera, cfg, port=args.serve, seed=args.seed,
              preview_every=max(1, args.preview_every),
              ppm_initial_radius=args.ppm_radius)
        return 0

    r = Renderer(scene, camera, cfg, seed=args.seed,
                 ppm_initial_radius=args.ppm_radius)
    if args.resume and args.checkpoint and Path(args.checkpoint).exists():
        r.load_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"resumed from {args.checkpoint} at iteration "
                  f"{r.iteration}")

    save = save_tga if args.output.endswith(".tga") else save_png
    target = r.iteration + args.iterations
    from .core.profiling import trace
    with trace(args.profile):
        while r.iteration < target:
            m = r.render_next_iteration()
            if not args.quiet:
                extra = "".join(
                    f" {k}={v:.3g}" for k, v in m.items()
                    if k in ("photons_stored", "light_vertices_stored",
                             "ppm_radius"))
                print(f"iter {m['iteration']:4d}  "
                      f"{m['iteration_seconds'] * 1e3:7.1f} ms{extra}")
            if args.preview_every and r.iteration % args.preview_every == 0:
                save(r.film, args.output, gamma=args.gamma)

    save(r.film, args.output, gamma=args.gamma)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"checkpoint -> {args.checkpoint}")
    if not args.quiet:
        print(f"wrote {args.output} ({r.iteration} iterations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
