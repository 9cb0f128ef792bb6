"""Generate the golden-parity tensors (VERDICT r1 missing #3).

Renders every SceneFactory scene (Gui/scene/SceneFactory.cpp:24-80: Cornell
+ the 7 CornellSmall variants) at 64^2 with a fixed seed for PT / PPM / VCM
and stores the mean radiance images as float16 in tests/goldens/goldens.npz.
tests/test_goldens.py re-renders the same configs and asserts agreement —
pinning every estimator's output across rounds (the reference has no golden
images; its CornellSmall variants are SmallVCM-style known-answer scenes,
which is exactly what makes them good goldens).

The goldens are made on the CPU backend:

    JAX_PLATFORMS=cpu python scripts/make_goldens.py

A GPU render is held to them by tests/test_goldens.py's cross-backend
comparator: its last-bit float differences flip rare discrete path
decisions and move a bounded number of whole pixels
(scripts/golden_flip_witness.py).
"""
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
GOLDEN_DIR = REPO / "tests" / "goldens"
GOLDENS = GOLDEN_DIR / "goldens.npz"

# one shared config per method; small path lengths keep CI compile cheap
SCENES = ["Cornell", "CornellSmall", "CornellSmallNoBlocks",
          "CornellSmallLargeSphere", "CornellSmallSmallSpheres",
          "CornellSmallLightUpwards", "CornellSmallPointDistant",
          "CornellSmallPointTest"]
METHODS = ["pt", "ppm", "vcm"]
SIZE = 64
ITERS = {"pt": 4, "ppm": 3, "vcm": 2}
SEED = 7


def golden_config(method):
    from oppositerenderer.config import RenderConfig, RenderMethod
    m = {"pt": RenderMethod.PATH_TRACING,
         "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
         "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[method]
    return RenderConfig(
        width=SIZE, height=SIZE, render_method=m,
        pt_max_segments_nee=4,
        max_radiance_trace_depth=5, max_photon_trace_depth=4,
        photons_per_iteration=1 << 14, photon_grid_resolution=32,
        gather_photon_budget=64, vcm_max_path_length=6,
        iterations_per_dispatch=ITERS[method],
        # the goldens hold the XLA gather's estimator on every backend
        use_pallas_gather=False,
        # one grid-sort form (both are bit-identical): no background
        # compile of the other tier
        photon_grid_sort="argsort")


def render_golden(scene_name, method):
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name
    scene, cam = get_scene_by_name(scene_name)
    r = Renderer(scene, cam, golden_config(method), seed=SEED)
    film = r.render(ITERS[method])
    return np.asarray(film.mean_radiance())


def main():
    out = {}
    for scene_name in SCENES:
        for method in METHODS:
            img = render_golden(scene_name, method)
            assert np.isfinite(img).all(), (scene_name, method)
            out[f"{scene_name}__{method}"] = img.astype(np.float16)
            print(f"{scene_name:32s} {method}: mean={img.mean():.5f}",
                  flush=True)
    GOLDEN_DIR.mkdir(exist_ok=True)
    np.savez_compressed(GOLDENS, **out)
    print("wrote", GOLDENS)


if __name__ == "__main__":
    main()
