"""Native (C++) components, loaded via ctypes with pure-numpy fallbacks.

The reference's native runtime pieces map to:
* bvh_builder.cpp — binned-SAH BVH build (host, once per scene; replaces
  OptiX's Trbvh build, scene/Scene.cpp:353)
* kdtree_builder.cpp — left-balanced photon kd-tree build (host, per
  iteration when PhotonMapStructure.KD_TREE_CPU is selected; replaces
  renderer/OptixRenderer_CPUKdTree.cpp)
The shared libraries compile on first use (g++ -O3, portable code: no
``-march=native``) into ``.native_build/`` at the checkout root, one file
per source hash and host architecture, so an edited source or another
machine never loads a stale binary. Without a toolchain the numpy
fallbacks take over.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
BUILD_DIR = _HERE.parent.parent / ".native_build"
_libs: dict[str, object] = {}
_failed: set[str] = set()


def lib_path(stem: str) -> Path:
    """Where the library built from ``<stem>.cpp`` lives: keyed by the
    source's hash and the host's architecture."""
    h = hashlib.sha256((_HERE / f"{stem}.cpp").read_bytes())
    h.update(f"{platform.system()}-{platform.machine()}".encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _compile(stem: str, out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_HERE / f"{stem}.cpp"),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)      # atomic: concurrent builders never see half
    return True


def _get(stem: str):
    """ctypes handle to a native library by source stem, or None."""
    if stem in _libs:
        return _libs[stem]
    if stem in _failed:
        return None
    path = lib_path(stem)
    if not path.exists() and not _compile(stem, path):
        _failed.add(stem)
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _failed.add(stem)
        return None
    _libs[stem] = lib
    return lib


def get_lib():
    """ctypes handle to the native BVH builder, or None if unavailable."""
    lib = _get("bvh_builder")
    if lib is None or hasattr(lib, "_sigs_set"):
        return lib
    lib.build_bvh.restype = ctypes.c_int
    lib.build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib._sigs_set = True
    return lib


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray,
                     centroid: np.ndarray, leaf_size: int):
    """Run the C++ builder. Returns (nodes_min, nodes_max, nodes_a, nodes_b,
    order) or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = prim_min.shape[0]
    max_nodes = max(4 * n, 64)
    pmn = np.ascontiguousarray(prim_min, np.float32)
    pmx = np.ascontiguousarray(prim_max, np.float32)
    cen = np.ascontiguousarray(centroid, np.float32)
    nmn = np.empty((max_nodes, 3), np.float32)
    nmx = np.empty((max_nodes, 3), np.float32)
    na = np.empty((max_nodes,), np.int32)
    nb = np.empty((max_nodes,), np.int32)
    order = np.empty((n,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    count = lib.build_bvh(
        pmn.ctypes.data_as(fp), pmx.ctypes.data_as(fp),
        cen.ctypes.data_as(fp), n, leaf_size,
        nmn.ctypes.data_as(fp), nmx.ctypes.data_as(fp),
        na.ctypes.data_as(ip), nb.ctypes.data_as(ip),
        order.ctypes.data_as(ip), max_nodes)
    if count <= 0:
        return None
    return (nmn[:count], nmx[:count], na[:count], nb[:count], order)


# ---------------------------------------------------------------------------
# photon kd-tree builder (kdtree_builder.cpp)
# ---------------------------------------------------------------------------

KD_LEAF, KD_NULL = 3, 4


def _kdtree_lib():
    lib = _get("kdtree_builder")
    if lib is None or hasattr(lib, "_sigs_set"):
        return lib
    lib.build_photon_kdtree.restype = ctypes.c_int
    lib.build_photon_kdtree.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib._sigs_set = True
    return lib


def _left_subtree_size(n: int) -> int:
    if n <= 1:
        return 0
    h = 0
    while (1 << (h + 1)) - 1 < n:
        h += 1
    last = n - ((1 << h) - 1)
    return ((1 << (h - 1)) - 1) + min(last, 1 << (h - 1))


def _build_kdtree_numpy(pos: np.ndarray, perm: np.ndarray,
                        axis: np.ndarray) -> None:
    """Pure-numpy fallback mirroring kdtree_builder.cpp (np.argpartition
    as the nth_element)."""
    # iterative stack to avoid Python recursion limits
    stack = [(np.arange(pos.shape[0], dtype=np.int64), 0)]
    while stack:
        idx, slot = stack.pop()
        n = idx.shape[0]
        if n == 0 or slot >= perm.shape[0]:
            continue
        if n == 1:
            perm[slot] = idx[0]
            axis[slot] = KD_LEAF
            continue
        p = pos[idx]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        med = _left_subtree_size(n)
        part = np.argpartition(p[:, ax], med)
        perm[slot] = idx[part[med]]
        axis[slot] = ax
        stack.append((idx[part[:med]], 2 * slot + 1))
        stack.append((idx[part[med + 1:]], 2 * slot + 2))


def build_photon_kdtree_native(pos: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Left-balanced kd-tree over photon positions [n,3].

    Returns (perm [m], axis_flags [m]) with m the smallest complete-tree
    capacity >= n (children of slot i at 2i+1/2i+2; flags 0/1/2 = split
    axis, 3 = leaf, 4 = null). C++ when available, numpy otherwise.
    """
    n = int(pos.shape[0])
    m = 1
    while m < n:
        m = 2 * m + 1
    perm = np.full((m,), -1, np.int32)
    axis = np.full((m,), KD_NULL, np.int32)
    if n == 0:
        return perm, axis
    p = np.ascontiguousarray(pos, np.float32)
    lib = _kdtree_lib()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        count = lib.build_photon_kdtree(
            p.ctypes.data_as(fp), n, perm.ctypes.data_as(ip),
            axis.ctypes.data_as(ip), m)
        if count == n:
            return perm, axis
    _build_kdtree_numpy(p, perm, axis)
    return perm, axis


# --- fast numeric token scanner (scene file payloads) ---------------------

def _text_scan_lib():
    """ctypes handle to the text scanner (text_scan.cpp), or None."""
    lib = _get("text_scan")
    if lib is None or hasattr(lib, "_sigs_set"):
        return lib
    for name, outp in (("scan_floats", ctypes.POINTER(ctypes.c_float)),
                       ("scan_ints", ctypes.POINTER(ctypes.c_int64))):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, outp,
                       ctypes.c_int64]
    lib._sigs_set = True
    return lib


def _scan(text, dtype, fn_name, ptr_t):
    lib = _text_scan_lib()
    if lib is None:
        return None
    b = text.encode("ascii", "strict") if isinstance(text, str) else text
    n = len(b)
    # worst case one token per 2 bytes ("1 1 1 ..."); typical tokens are
    # 8-20 bytes so this over-allocates ~5-10x transiently, then copies
    # down to the exact count.
    cap = n // 2 + 1
    out = np.empty(cap, dtype)
    k = int(getattr(lib, fn_name)(b, n, out.ctypes.data_as(ptr_t), cap))
    if k < 0:        # malformed token: let the Python parser report it
        return None
    return out[:k].copy()


def scan_floats(text) -> "np.ndarray | None":
    """Parse whitespace/comma-separated floats at C speed (Collada
    <float_array> payloads). Returns None when
    the native library is unavailable or the text has tokens the strict
    scanner does not accept — callers fall back to the Python parser."""
    return _scan(text, np.float32, "scan_floats",
                 ctypes.POINTER(ctypes.c_float))


def scan_ints(text) -> "np.ndarray | None":
    """Parse whitespace/comma-separated integers at C speed (Collada
    <p>/<vcount> payloads). Same fallback contract as scan_floats."""
    return _scan(text, np.int64, "scan_ints",
                 ctypes.POINTER(ctypes.c_int64))
