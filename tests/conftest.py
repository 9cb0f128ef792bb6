"""Test configuration: force the CPU backend with a virtual 8-device mesh.

The tests run on the CPU (kernels in the Pallas interpreter); tests that
need the GPU carry the ``gpu`` marker and skip elsewhere (``gpu`` fixture).
jax.config.update('jax_platforms', ...) wins as long as no backend has been
initialized yet, and XLA_FLAGS must be set before first device use to get 8
virtual CPU devices for sharding tests.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# JAX_PLATFORMS picks the backend when set (JAX_PLATFORMS=cuda runs the
# gpu-marked tests on the card); otherwise the tests run on the CPU
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Long-running statistical/convergence tests (>= ~20 s each, measured with
# pytest --durations on a 2-core host). `pytest -m "not slow"` is the
# quick tier. Centralized here so the list tracks measurements, not author
# guesses.
_SLOW_TESTS = (
    "test_goldens.py::test_all_scenes_match_goldens",
    "test_media.py::test_medium_attenuates_and_adds_inscatter",
    "test_media.py::test_medium_energy_sanity",
    "test_media.py::test_slab_single_scatter_matches_quadrature",
    "test_pallas_gather.py::test_ppm_iteration_with_tiled_gather_agrees",
    "test_pallas_gather.py::test_tiled_subsampled_is_unbiased_estimate",
    "test_ppm.py::test_ppm_radius_shrinks_indirect_consistent",
    "test_ppm.py::test_ppm_stochastic_hash_variant",
    "test_ppm.py::test_ppm_agrees_with_pt",
    "test_ppm.py::test_ppm_specular_chain",
    "test_debug.py::test_check_iteration_clean_scene",
    "test_vcm_vm.py::",
    "test_conference.py::test_pt_vcm_agree",
    "test_pt.py::test_fused_multi_iteration_matches_single",
    "test_grad.py::test_vcm_grad_kd_matches_fd",
    "test_grad.py::test_ppm_grad_through_tiled_gather",
    "test_grad.py::test_ppm_grad_kd_matches_fd",
    "test_grad.py::test_vcm_grad_emission_linear",
    "test_grad.py::test_pt_grad_emission_matches_fd",
    "test_vcm.py::test_vcm_ablations_do_not_exceed_total",
    "test_vcm.py::test_uniform_vertex_sampling_agrees_with_paired",
    "test_vcm.py::test_vcm_agrees_with_pt",
    "test_bvh.py::test_bvh_cornell_render_and_grad",
    "test_sharding.py::test_sharded_matches_unsharded",
    "test_grad_sharded.py::",
    "test_exchange_skew.py::",
    "test_analytic.py::test_ppm_matches_polygon_formula",
    "test_multiprocess.py::",
    "test_distributed.py::test_cli_end_to_end",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SLOW_TESTS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(20260817)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is the GPU (decided at run time, never at
    import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
