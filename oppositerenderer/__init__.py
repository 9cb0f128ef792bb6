"""opposite-renderer: a differentiable renderer in JAX (XLA, Pallas).

Built from scratch with the capabilities of ico-eagleye/OppositeRenderer
(progressive photon mapping + VCM-style vertex connection + path tracing):
wavefront integrators under jit, sorted-grid photon maps via
lax.sort/cumsum, a Pallas (Triton) tile-shared photon gather, and
shard_map distribution over device meshes.
"""
import os as _os
from pathlib import Path as _Path

import jax as _jax

# Persistent compilation cache: the render graphs take tens of seconds to
# compile and are identical across runs (the reference pays an analogous
# OptiX JIT per process, README.md:78). JAX itself honours
# JAX_COMPILATION_CACHE_DIR; without it the cache lives at a fixed path in
# the checkout (the path is part of the cache key). Accelerator backends
# only: XLA:CPU executables are tied to the host's CPU features, and CPU
# compiles are short.
DEFAULT_COMPILE_CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir(environ, platforms: str) -> str | None:
    """The directory this package sets as JAX's compile cache, or None when
    it sets none (the variable is set, or the first platform is the CPU)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms.split(",")[0].strip() == "cpu":
        return None
    return str(DEFAULT_COMPILE_CACHE_DIR)


if (_cache := compile_cache_dir(
        _os.environ, _jax.config.jax_platforms
        or _os.environ.get("JAX_PLATFORMS", ""))) is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)

from .config import Intersector, PhotonMapStructure, RenderConfig, RenderMethod

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "RenderMethod",
    "PhotonMapStructure",
    "Intersector",
    "__version__",
]
