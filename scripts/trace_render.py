"""Trace a few fused render iterations and print where the device time goes.

    python scripts/trace_render.py --scene CornellSmall --size 512 \\
        --method ppm --gather tile --out chiprun_out/trace_tile

Compiles the fused ``Renderer.render`` step (co-sort photon grid), warms
it up, then captures ``--iters`` iterations in one dispatch with
``jax.profiler`` (Perfetto trace under ``--out``). Prints the wall time,
the device busy time summed over the accelerator's tracks, and the device
operations that took the most time, by name.
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def device_op_times(trace_dir: Path) -> tuple[dict[str, float], float]:
    """({op name: total µs}, busy µs) over the device tracks of the newest
    Perfetto trace under ``trace_dir``."""
    path = max(trace_dir.rglob("perfetto_trace.json.gz"),
               key=lambda p: p.stat().st_mtime)
    with gzip.open(path, "rt") as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    device = {pid for pid, n in names.items() if "/device:" in n}
    if not device:
        raise SystemExit(f"no device track in {path}: {sorted(names.values())}")
    per_op: dict[str, float] = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in device:
            per_op[e["name"]] += float(e.get("dur", 0.0))
    return dict(per_op), float(sum(per_op.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="CornellSmall")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--method", default="ppm", choices=["pt", "ppm", "vcm"])
    ap.add_argument("--gather", default="auto", choices=["auto", "tile", "xla"],
                    help="PPM photon gather route")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args(argv)

    import jax

    from oppositerenderer.config import RenderConfig, RenderMethod
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name

    method = {"pt": RenderMethod.PATH_TRACING,
              "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
              "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[args.method]
    cfg = RenderConfig(width=args.size, height=args.size, render_method=method,
                       photon_grid_sort="cosort", dispatch_seconds_budget=0.0,
                       iterations_per_dispatch=args.iters,
                       use_pallas_gather={"auto": None, "tile": True,
                                          "xla": False}[args.gather])
    scene, cam = get_scene_by_name(args.scene)
    r = Renderer(scene, cam, cfg, seed=7)
    t0 = time.perf_counter()
    r.render(1).accum.block_until_ready()
    print(f"compile + first iteration {time.perf_counter() - t0:.1f} s")
    r.render(args.iters).accum.block_until_ready()
    out = Path(args.out)
    with jax.profiler.trace(str(out), create_perfetto_trace=True):
        t0 = time.perf_counter()
        r.render(args.iters).accum.block_until_ready()
        wall = (time.perf_counter() - t0) * 1e3 / args.iters
    per_op, busy = device_op_times(out)
    busy_ms = busy / 1e3 / args.iters
    print(f"{args.scene} {args.size}^2 {args.method} ({args.gather} gather) on "
          f"{jax.devices()[0].device_kind}: wall {wall:.2f} ms/iteration, "
          f"device busy {busy_ms:.2f} ms/iteration "
          f"(idle share {max(0.0, 1 - busy_ms / wall):.3f})")
    for name, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / 1e3 / args.iters:9.3f} ms/iteration  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
