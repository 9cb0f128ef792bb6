"""Film: accumulation buffer, display transform, image IO, checkpointing.

Covers the reference's output pipeline: the float3 accumulation buffer
(``OptixRenderer::getOutputBuffer``), the GL display shader's
``pow(c/iterations, 1/gamma)`` transform (Gui/gui/RenderWidget.cpp:75-130),
TGA/PNG export (util/Image + vendored libtga), plus checkpoint/resume which
the reference lacks entirely (SURVEY.md section 5: film + RNG + iteration
counter survive restarts here).
"""
from __future__ import annotations

import struct as pystruct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from .core import pytree as struct
from .png import encode_png

Array = jax.Array


@struct.dataclass
class Film:
    """Accumulated radiance; display divides by iteration count."""

    accum: Array       # [H,W,3] f32 sum over iterations
    iterations: Array  # [] int32 completed iterations

    @classmethod
    def create(cls, width: int, height: int) -> "Film":
        return cls(accum=jnp.zeros((height, width, 3), jnp.float32),
                   iterations=jnp.zeros((), jnp.int32))

    def add_iteration(self, radiance: Array) -> "Film":
        """Accumulate one iteration's [H,W,3] radiance (NaN-guarded, like
        RayGeneratorPT.cu:127-131)."""
        safe = jnp.where(jnp.isfinite(radiance), radiance, 0.0)
        return Film(accum=self.accum + safe, iterations=self.iterations + 1)

    def add_iterations(self, radiance_sum: Array, n: int) -> "Film":
        """Accumulate a pre-summed [H,W,3] radiance of ``n`` iterations
        (fused multi-iteration dispatch; each iteration is NaN-guarded
        inside the fused step before summing)."""
        return Film(accum=self.accum + radiance_sum,
                    iterations=self.iterations + n)

    def mean_radiance(self) -> Array:
        it = jnp.maximum(self.iterations, 1)
        return self.accum / it.astype(jnp.float32)

    def to_display(self, gamma: float = 2.2) -> Array:
        """[H,W,3] uint8 with the RenderWidget gamma transform. Buffer row 0
        is the bottom scanline (camera v points up; the reference displays
        through GL whose texture origin is bottom-left), so flip for raster
        order."""
        img = jnp.clip(self.mean_radiance(), 0.0, None)
        img = jnp.power(img, 1.0 / gamma)
        return jnp.clip(img * 255.0 + 0.5, 0, 255).astype(jnp.uint8)[::-1]


# ---------------------------------------------------------------------------
# image IO
# ---------------------------------------------------------------------------

def save_png(film_or_img, path: str | Path, gamma: float = 2.2) -> None:
    img = _as_display(film_or_img, gamma)
    Path(path).write_bytes(encode_png(img))


def save_tga(film_or_img, path: str | Path, gamma: float = 2.2) -> None:
    """Uncompressed 24-bit TGA (reference export format, util/libtga)."""
    img = _as_display(film_or_img, gamma)
    h, w, _ = img.shape
    header = pystruct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                           24, 0x20)  # top-left origin
    bgr = img[:, :, ::-1].tobytes()
    Path(path).write_bytes(header + bgr)


def _as_display(film_or_img, gamma: float) -> np.ndarray:
    if isinstance(film_or_img, Film):
        return np.asarray(film_or_img.to_display(gamma))
    img = np.asarray(film_or_img)
    if img.dtype != np.uint8:
        img = np.clip(np.power(np.clip(img, 0, None), 1.0 / gamma) * 255.0
                      + 0.5, 0, 255).astype(np.uint8)
    return img


# ---------------------------------------------------------------------------
# checkpoint / resume (new capability vs reference)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str | Path, film: Film, rng_key: Array,
                    ppm_radius_sq: float | Array = 0.0,
                    extra: dict | None = None) -> None:
    data = dict(accum=np.asarray(film.accum),
                iterations=np.asarray(film.iterations),
                rng_key=np.asarray(jax.random.key_data(rng_key))
                if jnp.issubdtype(rng_key.dtype, jax.dtypes.prng_key)
                else np.asarray(rng_key),
                ppm_radius_sq=np.asarray(ppm_radius_sq))
    for k, v in (extra or {}).items():
        data["x_" + k] = np.asarray(v)
    np.savez(str(path), **data)


def load_checkpoint(path: str | Path):
    """Returns (film, rng_key, ppm_radius_sq, extra)."""
    z = np.load(str(path))
    film = Film(accum=jnp.asarray(z["accum"]),
                iterations=jnp.asarray(z["iterations"]))
    key = jnp.asarray(z["rng_key"], jnp.uint32)
    extra = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("x_")}
    return film, key, float(z["ppm_radius_sq"]), extra
