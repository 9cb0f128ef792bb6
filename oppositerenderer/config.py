"""Runtime render configuration.

The reference renderer hard-codes most knobs as compile-time ``#define``s in
``RenderEngine/config.h`` (max depths, RR start, epsilons, photon budget) and
``renderer/OptixRenderer.cpp:39-53`` (photon/grid/LVC capacities).  Here
every one of those becomes a runtime field of :class:`RenderConfig`,
consumed as a static (hashable) argument by the jitted render steps.
"""
from __future__ import annotations

import dataclasses
import enum


class RenderMethod(enum.IntEnum):
    """Render methods (reference: RenderEngine/renderer/RenderMethod.h:11-19)."""

    PATH_TRACING = 0
    PROGRESSIVE_PHOTON_MAPPING = 1
    VCM_BIDIRECTIONAL_PATH_TRACING = 2


class PhotonMapStructure(enum.IntEnum):
    """Photon map acceleration structure (reference: config.h:17-21)."""

    SORTED_UNIFORM_GRID = 0  # reference ACCELERATION_STRUCTURE_UNIFORM_GRID
    STOCHASTIC_HASH = 1      # reference ACCELERATION_STRUCTURE_STOCHASTIC_HASH
    KD_TREE_CPU = 2          # reference ACCELERATION_STRUCTURE_KD_TREE_CPU
                             # (host C++ build + device stack traversal)


class PhotonExchange(enum.IntEnum):
    """Multi-chip photon-map exchange strategy (sharded PPM).

    The reference's single full map per GPU (OptixRenderer_SpatialHash.cu)
    has no analog of this axis; see parallel/exchange.py.
    """

    ALL_TO_ALL = 0   # cell-owner partition; O(P/D) traffic+memory per chip
    ALL_GATHER = 1   # replicate photons; identical full grid on every chip


class Intersector(enum.IntEnum):
    """Ray-scene intersection backend."""

    AUTO = 0         # bruteforce for small scenes, BVH otherwise
    BRUTEFORCE = 1   # dense rays x triangles; fused by XLA for small scenes
    BVH = 2          # flattened BVH, leaf-cluster wavefront traversal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time knobs. Hashable so it can be a static jit argument."""

    width: int = 512
    height: int = 512
    render_method: RenderMethod = RenderMethod.PATH_TRACING

    # --- path depths (reference config.h:33-37) ---
    max_radiance_trace_depth: int = 9     # MAX_RADIANCE_TRACE_DEPTH
    max_photon_trace_depth: int = 7       # MAX_PHOTON_TRACE_DEPTH
    photon_rr_start_depth: int = 3        # PHOTON_TRACING_RR_START_DEPTH
    path_rr_start_depth: int = 3          # PATH_TRACING_RR_START_DEPTH

    # --- path tracing (reference pt/RayGeneratorPT.cu:67-69) ---
    pt_direct_light_sampling: bool = True
    pt_max_segments_nee: int = 5          # numPaths with NEE
    pt_max_segments_no_nee: int = 10      # numPaths without NEE
    pt_shadow_samples: int = 1

    # --- PPM (reference OptixRenderer.cpp:39-53, config.h:23-27) ---
    photons_per_iteration: int = 1 << 20          # 1024x1024 launch
    max_photon_deposits_per_emitted: int = 4      # MAX_PHOTONS_DEPOSITS_PER_EMITTED
    photon_grid_resolution: int = 100             # PHOTON_GRID_MAX_SIZE per axis
    # Photon-grid sort form: the co-sort (payload moved IN lax.sort) or
    # argsort + row gather (sort_rows_by_key docstring); the co-sort is
    # the slower compile, and was the faster graph where it was tuned (not
    # yet separated on the H100, PERF.md). "auto" (default) = TIERED:
    # the first executable compiles with argsort while the co-sort
    # executable compiles on a background thread and swaps in when ready
    # (Renderer._multi_step_fn). Both sorts are stable -> bit-identical
    # grids, so the swap is invisible. "cosort"/"argsort" pin one form.
    photon_grid_sort: str = "auto"
    photon_map_structure: PhotonMapStructure = PhotonMapStructure.SORTED_UNIFORM_GRID
    stochastic_hash_size_log2: int = 22           # 4M-entry hash table fallback
    ppm_alpha: float = 2.0 / 3.0                  # Knaus-Zwicker alpha
    ppm_initial_radius: float = 0.20              # Gui/Application.cpp:41 default
    ppm_default_radius_from_scene: bool = True    # IScene.cpp:23-30 heuristic
    ppm_direct_shadow_samples: int = 4            # DirectRadianceEstimation.cu
    # fixed gather budget of the XLA gather: photons gathered per query
    # point; boxes holding more are stride-subsampled with reweighting
    # (unbiased)
    gather_photon_budget: int = 128
    # sharded PPM only: how photons reach their grid-cell owners
    photon_exchange: PhotonExchange = PhotonExchange.ALL_TO_ALL
    # per-destination slab capacity = local_photons/D x this factor
    photon_exchange_capacity_factor: float = 2.0

    # --- VCM (reference OptixRenderer.cpp:53, vcm/*) ---
    vcm_max_path_length: int = 10                 # VCM_MAX_PATH_LENGTH
    vcm_use_vc: bool = True                       # vertex connection on
    # Vertex merging. The reference scaffolds VM but never finishes it
    # (OptixRenderer.cpp:300-301); here it is a REAL merging pass
    # (integrators/vcm.build_vertex_grid + _merge_vertices), off by default
    # to match the reference's estimator.
    vcm_use_vm: bool = False
    # light vertices gathered per camera vertex per merge round (over-full
    # boxes are stride-subsampled with reweighting, unbiased)
    vcm_vm_budget: int = 64
    # ablation switches (reference vcm.h:34-37 compile-time defines)
    vcm_connect_vertices: bool = True             # !CONNECT_VERTICES_DISABLED
    vcm_connect_camera_t1: bool = True            # !CONNECT_CAMERA_T1_DISABLED
    vcm_connect_light_s0: bool = True             # !CONNECT_LIGHT_S0_DISABLED
    vcm_connect_light_s1: bool = True             # !CONNECT_LIGHT_S1_DISABLED
    # debugging/testing knob: pin the RR continuation probability (e.g. 1.0
    # disables RR, making finite-difference gradient checks well-conditioned)
    vcm_force_continuation_prob: float | None = None
    # VCM_UNIFORM_VERTEX_SAMPLING (vcm/config_vcm.h; OptixRenderer.cpp:308,
    # 679-773): connect each camera vertex to vcm_uniform_connections
    # vertices picked uniformly from the GLOBAL light-vertex store instead
    # of pairing 1:1 with one light path. The reference derives the
    # connection count from a host-side estimate pass (ceil of the average
    # subpath length, RR on the fraction); here it is a static config knob
    # (XLA needs static trip counts) defaulting to the Cornell-class
    # average the estimate pass would measure.
    vcm_uniform_vertex_sampling: bool = False
    vcm_uniform_connections: int = 3

    # --- participating media (reference config.h:29, default off;
    #     active when the scene carries a Medium) ---
    media_max_deposits_per_photon: int = 2   # volumetric deposit slots/path

    # --- epsilons (reference config.h:41-43) ---
    ray_len_min: float = 1e-4                     # RAY_LEN_MIN
    eps_cosine: float = 1e-6                      # EPS_COSINE
    eps_ray: float = 1e-3                         # EPS_RAY

    # --- intersection backend ---
    intersector: Intersector = Intersector.AUTO
    bruteforce_max_tris: int = 4096       # AUTO switches to BVH above this
    bvh_arity: int = 8                    # wide-BVH branching factor
    bvh_leaf_size: int = 6                # max triangles per leaf row

    # --- output (reference Gui/Application.cpp:36-40) ---
    gamma: float = 2.2

    # --- host-loop batching ---
    # Iterations fused into ONE device dispatch (lax.fori_loop inside jit).
    # The analog of the reference server rendering 4 iterations per packet
    # and transferring output once (RenderServerRenderer.cpp:110-113):
    # per-dispatch latency is paid once per chunk instead of once per
    # iteration.
    iterations_per_dispatch: int = 8
    # PT iterations STACKED side-by-side in one wavefront (G x W x H lanes
    # per dispatch) — distinct from iterations_per_dispatch, which runs
    # them SEQUENTIALLY in a fori_loop. PT iterations are independent
    # samples (the same property the reference's iteration sharding
    # exploits, DistributedApplication.cpp:96-122), so stacking them
    # multiplies the lane count of every traversal dispatch: the BVH
    # compaction ladder's fixed-size tail rounds (accel/bvh.py ladder) and
    # per-dispatch overheads amortize over G x more rays. Only PT batches;
    # other methods ignore this field.
    iteration_batch: int = 1
    # Pallas (Triton) tile gather for the PPM indirect estimate (accel/
    # pallas_gather.py): 16x16 pixel tiles share their photon-cell
    # intervals instead of per-query random row gathers. None = auto: the
    # compiled kernel on the GPU, the XLA budgeted gather elsewhere. True
    # on the CPU runs the kernel in the Pallas interpreter (tests); any
    # other backend raises. Same unbiased estimator family as the budgeted
    # XLA gather; different subsampling pattern. Gradients through it are
    # its plain reference's (accel/pallas_gather.py docstring).
    use_pallas_gather: bool | None = None
    # upper bound on the device time of ONE fused dispatch: runtimes have
    # watchdogs that kill multi-minute single dispatches. Renderer.render
    # probes one iteration first, then fuses as many as fit the budget.
    # <=0 disables adaptation.
    dispatch_seconds_budget: float = 90.0
    # pipeline overlap: queue every fused chunk without blocking between
    # them, letting the host enqueue chunk k+1 while the device computes
    # chunk k (the reference hides latency with <=30 pending iterations
    # per server + 4-iteration packets, RenderServerConnection.cpp:37-48;
    # XLA's async dispatch gives the same overlap for free once we stop
    # synchronizing per chunk). Off by default only so per-chunk metrics
    # stay exact wall times.
    async_dispatch: bool = False

    # --- reference parity mode ---
    # Bundle the documented physics deviations back to the reference's
    # behavior so parity-with-reference and fixed-physics are both testable:
    # (a) NEE multiplies raw albedo instead of f=albedo/pi
    #     (helpers/light.h:29-89 + Diffuse.cu attenuation *= Kd);
    # (b) PPM clamps emitter passthrough radiance to <=1
    #     (DirectRadianceEstimation.cu:38).
    reference_faithful: bool = False

    # --- numerics ---
    use_cheap_random: bool = False        # USE_CHEAP_RANDOM (config.h:39):
                                          # hash RNG instead of threefry

    def __post_init__(self):
        # Depth-0 configs would trace no segment at all; reject them (the
        # reference hard-codes these as compile-time constants >= 1,
        # config.h:33-37).
        for field in ("max_radiance_trace_depth", "max_photon_trace_depth",
                      "pt_max_segments_nee", "pt_max_segments_no_nee",
                      "vcm_max_path_length"):
            if getattr(self, field) < 1:
                raise ValueError(f"RenderConfig.{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        for field in ("pt_shadow_samples", "ppm_direct_shadow_samples"):
            if getattr(self, field) < 0:
                raise ValueError(f"RenderConfig.{field} must be >= 0, got "
                                 f"{getattr(self, field)}")
        if self.photon_grid_sort not in ("auto", "cosort", "argsort"):
            raise ValueError("RenderConfig.photon_grid_sort must be "
                             f"auto|cosort|argsort, got "
                             f"{self.photon_grid_sort!r}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def pt_max_segments(self) -> int:
        return (self.pt_max_segments_nee if self.pt_direct_light_sampling
                else self.pt_max_segments_no_nee)
