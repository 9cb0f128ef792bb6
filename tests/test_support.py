"""The package's own plumbing: pytree dataclasses, the PNG codec, the
compile-cache directory rule and the native-library build path."""
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oppositerenderer
from oppositerenderer import native
from oppositerenderer.core import pytree
from oppositerenderer.png import decode_png, encode_png


@pytree.dataclass
class _Rec:
    a: jax.Array
    b: jax.Array
    tag: str = pytree.field(static=True, default="x")


def test_pytree_flatten_keeps_static_fields_out_of_leaves():
    r = _Rec(a=jnp.ones(2), b=jnp.zeros(3), tag="y")
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert [leaf.shape for leaf in leaves] == [(2,), (3,)]
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "y" and isinstance(back, _Rec)
    doubled = jax.tree_util.tree_map(lambda x: x * 2, r)
    assert doubled.tag == "y"
    np.testing.assert_array_equal(doubled.a, 2 * np.ones(2))


def test_pytree_replace_and_frozen():
    r = _Rec(a=jnp.ones(2), b=jnp.zeros(3))
    r2 = r.replace(b=jnp.ones(3), tag="z")
    assert r.tag == "x" and r2.tag == "z"
    np.testing.assert_array_equal(r2.b, np.ones(3))
    with pytest.raises(AttributeError):
        r.a = jnp.zeros(2)


def test_pytree_static_field_is_part_of_the_jit_key():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.tag)
        return r.a.sum() + (1.0 if r.tag == "x" else 10.0)

    assert float(f(_Rec(a=jnp.ones(2), b=jnp.zeros(1)))) == 3.0
    assert float(f(_Rec(a=jnp.zeros(2), b=jnp.zeros(1)))) == 1.0
    assert float(f(_Rec(a=jnp.ones(2), b=jnp.zeros(1), tag="q"))) == 12.0
    assert traces == ["x", "q"]   # new static value -> one retrace


def test_png_round_trip(tmp_path):
    from oppositerenderer.film import Film, save_png
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    assert np.array_equal(decode_png(encode_png(img)), img)
    film = Film.create(4, 3).add_iteration(jnp.full((3, 4, 3), 0.25))
    save_png(film, tmp_path / "f.png")
    got = decode_png((tmp_path / "f.png").read_bytes())
    assert got.shape == (3, 4, 3)
    np.testing.assert_array_equal(got, np.asarray(film.to_display()))


def _png(rows: bytes, w: int, h: int, ctype: int, extra=b"") -> bytes:
    import struct

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + extra + chunk(b"IDAT", zlib.compress(rows))
            + chunk(b"IEND", b""))


def test_png_decodes_every_row_filter_and_palette():
    """Rows filtered with None/Sub/Up/Average/Paeth (PNG spec 9.2) decode
    to the same grey ramp; a palette image expands to RGB."""
    want = np.array([[10, 20, 30, 40], [15, 25, 35, 45],
                     [5, 60, 10, 200], [0, 255, 128, 1],
                     [9, 9, 9, 9]], np.int64)

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)

    raw, prev = b"", np.zeros(4, np.int64)
    for ftype, row in enumerate(want):
        out = []
        for x, v in enumerate(row):
            a = row[x - 1] if x else 0
            pred = [0, a, prev[x], (a + prev[x]) // 2,
                    paeth(a, prev[x], prev[x - 1] if x else 0)][ftype]
            out.append((v - pred) % 256)
        raw += bytes([ftype] + out)
        prev = row
    got = decode_png(_png(raw, 4, 5, 0))
    np.testing.assert_array_equal(got[..., 0], want)

    plte = bytes([255, 0, 0, 0, 255, 0])
    import struct
    plte_chunk = (struct.pack(">I", 6) + b"PLTE" + plte
                  + struct.pack(">I", zlib.crc32(b"PLTE" + plte)))
    pal = decode_png(_png(bytes([0, 1, 0]), 2, 1, 3, plte_chunk))
    np.testing.assert_array_equal(pal[0], [[0, 255, 0], [255, 0, 0]])


def test_png_rejects_unsupported():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 3), np.float32))


@pytest.mark.parametrize("environ,platforms,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "cuda", None),
    ({}, "cpu", None),
    ({}, "cuda", "default"),
    ({}, "", "default"),
])
def test_compile_cache_dir_rule(environ, platforms, want):
    """JAX_COMPILATION_CACHE_DIR wins untouched; the CPU gets no cache;
    otherwise the cache sits at a fixed path inside the checkout."""
    got = oppositerenderer.compile_cache_dir(environ, platforms)
    if want is None:
        assert got is None
    else:
        assert got == str(oppositerenderer.DEFAULT_COMPILE_CACHE_DIR)
        repo = Path(oppositerenderer.__file__).resolve().parent.parent
        assert Path(got).parent == repo
        assert ".jax_cache/" in (repo / ".gitignore").read_text()


def test_native_library_path_is_keyed_by_source_and_ignored():
    p = native.lib_path("bvh_builder")
    assert p.parent == native.BUILD_DIR
    assert p.name.startswith("libbvh_builder-") and p.suffix == ".so"
    assert native.lib_path("text_scan") != p
    repo = Path(native.__file__).resolve().parents[2]
    assert ".native_build/" in (repo / ".gitignore").read_text()
