"""Golden-parity harness (VERDICT r1 missing #3).

Every SceneFactory scene (the reference's known-answer CornellSmall variants,
Gui/scene/SceneFactory.cpp:24-80) is re-rendered at 64^2 with a fixed seed
and compared against the golden tensors rendered on the CPU
(scripts/make_goldens.py): exactly on the CPU, and on another backend with
a bounded number of flipped pixels (assert_matches_golden_across_backends).
Catches any estimator regression across rounds; also asserts PT/VCM
cross-method energy agreement per scene and the reference_faithful flag's
documented effect.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import sys

sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
from make_goldens import (GOLDENS, ITERS, SCENES, SEED,  # noqa: E402
                          golden_config)

# Another backend's float arithmetic (transcendentals, FMA contraction)
# differs from the CPU's in the last bits, which flips rare discrete path
# decisions and moves whole pixels (scripts/golden_flip_witness.py traces
# each differing PPM pixel to a photon or eye path that moved). Per method:
# (share of pixels allowed off the per-pixel tolerance, image-mean
# relative bound). Measured on an H100 against these goldens, worst scene:
# PT 9 pixels (0.22%) / 1.6e-4, VCM 18 (0.44%) / 7.4e-5, PPM 62 (1.5%) /
# 5.0e-3 (Cornell, where one photon path moves a neighbourhood); the
# bounds are about twice that.
CROSS_BACKEND_BOUNDS = {"pt": (0.005, 3e-4), "vcm": (0.01, 3e-4),
                        "ppm": (0.03, 1e-2)}


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _render(scene_name, method):
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name
    scene, cam = get_scene_by_name(scene_name)
    r = Renderer(scene, cam, golden_config(method), seed=SEED)
    film = r.render(ITERS[method])
    return np.asarray(film.mean_radiance())


def _golden_atol(want) -> float:
    return 5e-3 * max(float(want.mean()), 0.01)


def assert_matches_golden(img, want, label: str) -> None:
    """The golden comparator: float16 storage + float noise, so a mixed
    tolerance scaled to the image magnitude."""
    assert np.isfinite(img).all(), label
    np.testing.assert_allclose(
        img, want, rtol=5e-3, atol=_golden_atol(want),
        err_msg=f"{label} diverged from golden")


def assert_matches_golden_across_backends(img, want, method: str,
                                          label: str) -> tuple[int, float]:
    """The comparator for a render made on another backend than the
    goldens: every pixel within the per-pixel tolerance except at most
    CROSS_BACKEND_BOUNDS' share of flipped pixels, and the image mean
    within its bound. Returns (pixels off, image-mean relative diff)."""
    assert np.isfinite(img).all(), label
    share, mean_rtol = CROSS_BACKEND_BOUNDS[method]
    bad = np.abs(img - want) > _golden_atol(want) + 5e-3 * np.abs(want)
    off = int(bad.reshape(-1, bad.shape[-1]).any(axis=-1).sum())
    n_pix = img.shape[0] * img.shape[1]
    rel = abs(float(img.mean()) - float(want.mean())) / float(want.mean())
    assert off <= share * n_pix, \
        f"{label}: {off} of {n_pix} pixels off the golden"
    assert rel <= mean_rtol, f"{label}: image mean off by {rel:.2e}"
    return off, rel


@pytest.mark.parametrize("method", ["pt", "ppm", "vcm"])
def test_all_scenes_match_goldens(goldens, method):
    import jax
    for scene_name in SCENES:
        img = _render(scene_name, method)
        want = goldens[f"{scene_name}__{method}"].astype(np.float32)
        label = f"{scene_name} {method}"
        if jax.default_backend() == "cpu":
            assert_matches_golden(img, want, label)
        else:
            assert_matches_golden_across_backends(img, want, method, label)


def test_cross_backend_comparator_bounds():
    """The cross-backend comparator passes a few flipped pixels and
    refuses a shifted image or too many flips."""
    rng = np.random.default_rng(0)
    want = rng.uniform(0.1, 1.0, (64, 64, 3)).astype(np.float32)
    img = want.copy()
    img[:3, 0] += 0.1                        # three flipped pixels
    off, rel = assert_matches_golden_across_backends(img, want, "pt", "t")
    assert off == 3 and rel < 3e-4
    with pytest.raises(AssertionError, match="pixels off"):
        assert_matches_golden_across_backends(
            want + np.where(np.arange(64)[:, None, None] < 1, 0.5, 0.0),
            want, "pt", "t")
    with pytest.raises(AssertionError, match="image mean"):
        assert_matches_golden_across_backends(want * 1.004, want, "vcm", "t")


def test_cross_method_energy_agreement(goldens):
    """PT and VCM estimate the same integral: per-scene mean radiance must
    agree within MC noise at these sample counts.

    CornellSmallLightUpwards is exempt: its light faces the ceiling so ALL
    transport is indirect, and the golden config's truncated PT (4
    segments, no light tracing) structurally underestimates what VCM's
    light subpaths capture — that attribution difference is exactly why
    the reference ships the scene (SmallVCM-style technique showcase,
    SceneFactory.cpp:24-80)."""
    for scene_name in SCENES:
        if scene_name == "CornellSmallLightUpwards":
            continue
        pt = float(goldens[f"{scene_name}__pt"].astype(np.float32).mean())
        vcm = float(goldens[f"{scene_name}__vcm"].astype(np.float32).mean())
        assert vcm == pytest.approx(pt, rel=0.25), \
            f"{scene_name}: PT {pt} vs VCM {vcm}"
    # the exempt scene: VCM must see MORE energy (indirect-only transport)
    pt_up = float(goldens["CornellSmallLightUpwards__pt"]
                  .astype(np.float32).mean())
    vcm_up = float(goldens["CornellSmallLightUpwards__vcm"]
                   .astype(np.float32).mean())
    assert vcm_up > pt_up


def test_reference_faithful_flag_changes_direct_light():
    """reference_faithful bundles the albedo-not-f NEE + emitter clamp:
    PT direct lighting must brighten by ~pi on a diffuse scene."""
    from oppositerenderer.config import RenderMethod
    from oppositerenderer.renderer import Renderer
    from oppositerenderer.scene import get_scene_by_name
    scene, cam = get_scene_by_name("CornellSmallNoBlocks")
    cfg = golden_config("pt").replace(pt_max_segments_nee=2,
                                      iterations_per_dispatch=1)
    r_fix = Renderer(scene, cam, cfg, seed=SEED)
    r_ref = Renderer(scene, cam, cfg.replace(reference_faithful=True),
                     seed=SEED)
    a = np.asarray(r_fix.render(1).mean_radiance())
    b = np.asarray(r_ref.render(1).mean_radiance())
    ratio = b.sum() / a.sum()
    assert 1.5 < ratio < np.pi + 0.3, ratio
