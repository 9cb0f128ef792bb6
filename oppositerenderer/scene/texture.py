"""Texture atlas + sampling (reference ``material/Texture.{h,cu}`` +
vendored libtga loader).

Textures live in one dense ``[n_tex, H, W, 3]`` f32 atlas (all images resized
to the atlas resolution at load — static shapes for jit); sampling is
bilinear with repeat wrapping, matching the reference's tex2D usage
(Texture.cu:83-116). Normal maps perturb the shading normal in the
per-triangle tangent frame (Texture.cu:116-160 tangent-space mapping).
"""
from __future__ import annotations

import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import Array, normalize
from ..png import decode_png


def load_image(path: str | Path) -> np.ndarray:
    """RGB float image in [0,1] from an 8-bit PNG or an uncompressed
    24/32-bit TGA (the reference's export format, util/libtga)."""
    data = Path(path).read_bytes()
    if str(path).lower().endswith(".tga"):
        img = _decode_tga(data)
    else:
        img = decode_png(data)
    if img.shape[2] < 3:                       # grey (+alpha) -> RGB
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def _decode_tga(data: bytes) -> np.ndarray:
    id_len, cmap_type, img_type = data[0], data[1], data[2]
    w, h, bpp, desc = struct.unpack("<HHBB", data[12:18])
    if cmap_type != 0 or img_type != 2 or bpp not in (24, 32):
        raise ValueError(f"unsupported TGA: type {img_type}, {bpp} bpp")
    ch = bpp // 8
    px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=18 + id_len)
    img = px.reshape(h, w, ch)[..., [2, 1, 0]]             # BGR -> RGB
    return img if desc & 0x20 else img[::-1]               # bottom-left


def build_atlas(images: list[np.ndarray], resolution: int = 256
                ) -> jnp.ndarray:
    """Stack images into [n, R, R, 3], resized bilinearly."""
    if not images:
        return jnp.zeros((0, 1, 1, 3), jnp.float32)
    out = [jax.image.resize(jnp.asarray(np.clip(img, 0, 1), jnp.float32),
                            (resolution, resolution, 3), "linear")
           for img in images]
    return jnp.clip(jnp.stack(out), 0.0, 1.0)


def sample_bilinear(atlas: Array, tex_id: Array, uv: Array) -> Array:
    """Bilinear lookup with repeat wrap. atlas [n,H,W,3]; tex_id [...] int32
    (invalid ids are caller-masked); uv [...,2] with v up (texture row 0 at
    v=1, image convention)."""
    n, h, w, _ = atlas.shape
    u = uv[..., 0] % 1.0
    v = 1.0 - (uv[..., 1] % 1.0)
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    tid = jnp.clip(tex_id, 0, max(n - 1, 0))
    c00 = atlas[tid, y0, x0]
    c01 = atlas[tid, y0, x1]
    c10 = atlas[tid, y1, x0]
    c11 = atlas[tid, y1, x1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def apply_normal_map(ns: Array, tangent: Array, bitangent: Array,
                     rgb: Array) -> Array:
    """Tangent-space normal perturbation (Texture.cu normal mapping)."""
    tn = rgb * 2.0 - 1.0
    return normalize(tn[..., 0:1] * tangent + tn[..., 1:2] * bitangent
                     + tn[..., 2:3] * ns)


def compute_triangle_tangents(v0, v1, v2, uv0, uv1, uv2):
    """Per-triangle tangent/bitangent from UV parameterization
    (Scene.cpp:438-470 per-vertex tangent generation, flat per-face here)."""
    e1 = v1 - v0
    e2 = v2 - v0
    du1 = uv1[..., 0] - uv0[..., 0]
    dv1 = uv1[..., 1] - uv0[..., 1]
    du2 = uv2[..., 0] - uv0[..., 0]
    dv2 = uv2[..., 1] - uv0[..., 1]
    det = du1 * dv2 - du2 * dv1
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det),
                   0.0)
    tangent = (e1 * dv2[..., None] - e2 * dv1[..., None]) * inv[..., None]
    bitangent = (e2 * du1[..., None] - e1 * du2[..., None]) * inv[..., None]
    norm = lambda a: a / np.maximum(
        np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    return norm(tangent), norm(bitangent)
