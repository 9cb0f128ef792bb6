"""BVH: host-side build (C++/numpy) + on-device wide-arity wavefront traversal.

Replaces OptiX's runtime acceleration structure (``scene/Scene.cpp:353``
"Trbvh") for scenes beyond the dense brute-force budget. The build is a
one-time host step: a native binned-SAH binary build (ctypes, numpy
median-split fallback) collapsed into a WIDE (8-ary by default) BVH; the
geometry is permuted so each leaf's primitives are contiguous, and traversal
on the device is a masked per-ray loop where every leaf test is a dense
[rays x leaf_size] Moller-Trumbore block (SURVEY.md section 7 "hard parts":
blockwise traversal design).

Traversal runs under ``lax.while_loop`` and is wrapped in a zero-gradient
``custom_vjp``: intersection outputs carry no material-parameter dependence
(the supported differentiation scope), and this keeps ``jax.grad`` working
over the loop.

DESIGN (a lockstep wavefront: every lane pays every while-loop round):

* the design goal is FEWER STEPS x ONE ROW GATHER PER STEP.
* a binary BVH pays about a hundred lockstep node steps per ray and TWO
  row gathers per step (node row + leaf row). The wide BVH cuts both:
  - arity 8 shortens the tree (depth ~7 instead of ~19-26 on the 253k-tri
    Atrium), cutting per-ray steps ~2.5-3x;
  - ONE unified row table holds both node rows (8 child AABBs + 8 child
    codes) and leaf rows (6 inlined triangles + occluder flags), so every
    step is exactly ONE [N, 64] gather;
  - the traversal stack stores (node, remaining-child-bitmask) packed in
    one int32 — re-visiting a multi-hit node re-slabs it against the
    CURRENT t_best (extra pruning), and stack depth stays bounded by the
    (short) wide-tree depth, so the one-hot stack ops touch [N, ~8]
    instead of [N, 26-48].
* the residual lockstep divergence is handled by the compaction ladder
  (live lanes first, shrink per level).

The tuning constants below were chosen on another accelerator; their
values on the GPU are not measured yet (PERF.md, open questions). A
per-ray traversal kernel (one ray per thread, private stack) is the
GPU-native alternative queued in ROADMAP.md.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import pytree as struct

from ..core.math import Array

BIG = 1e30


@struct.dataclass
class Bvh:
    """Flattened BVH.

    Two representations coexist:
    * the plain BINARY node arrays (nodes_min/max/a/b) from the builder —
      kept for inspection/tests;
    * the WIDE packed traversal layout (``rows``), built by
      ``build_scene_bvh``: one [R, W] f32 table holding both wide inner
      nodes and leaves, so traversal does exactly one row gather per step.

      Inner row (arity A, W = max(128, ceil((7A+1)/8)*8)):
      child i occupies cols
      [6i, 6i+6) = (min3, max3); cols [6A, 7A) = child codes (bitcast
      int32); col [7A] = valid-child bitmask (bitcast int32 — reversed
      bounds do NOT reject in the min/max slab form, so missing children
      are masked explicitly).
      Leaf row (L = (W-1)//10 triangles): cols [0, 9L) = L x (v0, e1, e2),
      [9L, 10L) = occluder flags, [10L] = first (permuted) prim id.

    Child codes: inner child = row index (>= 0); leaf child =
    ``-(row * 32 + count) - 1`` (count <= 31).
    """

    nodes_min: Array  # [n,3] binary tree (builder output, for tests)
    nodes_max: Array  # [n,3]
    nodes_a: Array    # [n] inner: left child; leaf: ~first_prim
    nodes_b: Array    # [n] inner: right child; leaf: prim count
    rows: Array = None   # [R, W] unified wide node/leaf table
    # [n_wide, 128] int8 QUANTIZED inner-node table (a quarter of the
    # bytes per inner step of the f32 table). Layout per inner row:
    #   [0:12)    origin  f32[3] (row bbox min over valid children)
    #   [12:24)   scale   f32[3] ((bbox extent)/255, slightly inflated)
    #   [24:48)   qlo     u8[A][3] conservative floor-quantized child mins
    #   [48:72)   qhi     u8[A][3] conservative ceil-quantized child maxs
    #   [72:104)  codes   int32[A]
    #   [104:108) valid   int32 child bitmask
    # Conservative quantization only ever GROWS child boxes, so traversal
    # visits a superset of the f32 visits and Moller-Trumbore on exact f32
    # leaf rows keeps results bit-identical. Leaf rows stay in ``rows``;
    # the traversal loop postpones leaf tests into flush phases so the
    # expensive f32 gather doesn't run every step (see _run_until).
    q_rows: Array = None
    root_code: int = struct.field(static=True, default=0)
    arity: int = struct.field(static=True, default=8)
    leaf_size: int = struct.field(static=True, default=6)
    max_stack: int = struct.field(static=True, default=12)


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

def _build_numpy(prim_min, prim_max, centroid, leaf_size):
    """Median-split fallback builder (same output contract as the C++)."""
    n = prim_min.shape[0]
    order = np.arange(n, dtype=np.int32)
    nodes_min, nodes_max, nodes_a, nodes_b = [], [], [], []

    def build(first, count):
        idx = order[first:first + count]
        bmin = prim_min[idx].min(axis=0)
        bmax = prim_max[idx].max(axis=0)
        node = len(nodes_a)
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        nodes_a.append(0)
        nodes_b.append(0)
        if count <= leaf_size:
            nodes_a[node] = ~first
            nodes_b[node] = count
            return node
        cen = centroid[idx]
        axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
        part = np.argsort(cen[:, axis], kind="stable")
        order[first:first + count] = idx[part]
        mid = first + count // 2
        left = build(first, mid - first)
        right = build(mid, first + count - mid)
        nodes_a[node] = left
        nodes_b[node] = right
        return node

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old)
    return (np.asarray(nodes_min, np.float32),
            np.asarray(nodes_max, np.float32),
            np.asarray(nodes_a, np.int32), np.asarray(nodes_b, np.int32),
            order)


def build_bvh_arrays(prim_min, prim_max, leaf_size: int = 16,
                     max_stack: int = 48):
    """Build over primitive AABBs -> (Bvh, order). Tries the native C++
    binned-SAH builder first; numpy median-split fallback."""
    centroid = 0.5 * (prim_min + prim_max)
    from ..native import build_bvh_native
    out = build_bvh_native(prim_min, prim_max, centroid, leaf_size)
    if out is None:
        out = _build_numpy(np.asarray(prim_min), np.asarray(prim_max),
                           np.asarray(centroid), leaf_size)
    nmn, nmx, na, nb, order = out
    bvh = Bvh(nodes_min=jnp.asarray(nmn), nodes_max=jnp.asarray(nmx),
              nodes_a=jnp.asarray(na), nodes_b=jnp.asarray(nb),
              leaf_size=leaf_size, max_stack=max_stack)
    return bvh, np.asarray(order)


def _bitcast_i2f(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int32).view(np.float32)


def _collapse_wide(nmn, nmx, na, nb, arity):
    """Collapse the binary SAH tree into wide nodes (host numpy).

    A wide node's child list starts as the binary root's two children and
    repeatedly replaces the INNER child with the largest surface area by its
    two binary children until ``arity`` children or all leaves — the
    standard greedy SAH collapse. Returns (wide_children, depth) where
    wide_children[i] is a list of ('leaf', first, count) | ('inner', wid).
    """
    ext = np.maximum(nmx - nmn, 0.0)
    sa = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]

    wide_children: list[list] = []
    # queue of (binary inner node -> wide id); binary root handled by caller
    todo = [(0, 0)]
    wide_children.append(None)
    wide_of = {0: 0}
    while todo:
        b, wid = todo.pop()
        kids = [int(na[b]), int(nb[b])]
        while len(kids) < arity:
            best, best_sa = -1, -1.0
            for i, k in enumerate(kids):
                if na[k] >= 0 and sa[k] > best_sa:
                    best, best_sa = i, sa[k]
            if best < 0:
                break
            k = kids.pop(best)
            kids.extend([int(na[k]), int(nb[k])])
        entry = []
        for k in kids:
            if na[k] < 0:
                entry.append(("leaf", int(~na[k]), int(nb[k]), k))
            else:
                nwid = len(wide_children)
                wide_children.append(None)
                wide_of[k] = nwid
                todo.append((k, nwid))
                entry.append(("inner", nwid, 0, k))
        wide_children[wid] = entry

    # depth of the wide tree (iterative)
    depth = 1
    stack = [(0, 1)]
    while stack:
        wid, d = stack.pop()
        depth = max(depth, d)
        for kind, a, _, _ in wide_children[wid]:
            if kind == "inner":
                stack.append((a, d + 1))
    return wide_children, depth


def _collapse_wide_sah(nmn, nmx, na, nb, arity, L, c_leaf=2.0):
    """SAH-cost-minimizing wide collapse.

    Dynamic program over the binary SAH tree in the style of Ylitie et
    al. 2017 (compressed wide BVHs): ``C[n, i]`` is the cheapest expected
    traversal cost of representing subtree ``n`` as a forest of ``i``
    wide-node child slots. Recurrences::

        C[n, i>=2] = min_k C[left, k] + C[right, i-k]      (slot split)
        C[n, 1]    = min( leaf(n),  p(n)*c_node + C[n, A] )

    with p(n) = area(n)/area(root) the geometric visit probability.
    Deviation from the paper, specific to this wavefront: a leaf VISIT
    costs a constant flush round (the [N, L] Moller-Trumbore tests all L
    lanes regardless of triangle count — bvh.py flush phase), so
    ``leaf(n) = p(n) * c_leaf`` whenever subtree n holds <= L primitives
    (they are contiguous in prim order by the builder's in-place
    partition), NOT count*c_prim. ``c_leaf`` is the
    flush:inner round cost ratio (cf. _Q_FLUSH_K).

    Returns the same (wide_children, depth) structure as
    ``_collapse_wide``.
    """
    n = na.shape[0]
    A = arity
    INF = np.float64(1e30)
    leaf_b = na < 0
    l = np.where(leaf_b, 0, na).astype(np.int64)
    r = np.where(leaf_b, 0, nb).astype(np.int64)
    ext = np.maximum(nmx - nmn, 0.0).astype(np.float64)
    sa = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
          + ext[:, 2] * ext[:, 0])
    p = sa / max(float(sa[0]), 1e-30)

    # prim ranges (contiguous per subtree) + level schedule, leaves up
    first = np.where(leaf_b, ~na, 0).astype(np.int64)
    count = np.where(leaf_b, nb, 0).astype(np.int64)
    done = leaf_b.copy()
    batches = []
    while not done.all():
        ready = ~done & done[l] & done[r]
        idx = np.nonzero(ready)[0]
        batches.append(idx)
        first[idx] = first[l[idx]]
        count[idx] = count[l[idx]] + count[r[idx]]
        done[ready] = True

    C = np.full((n, A + 1), INF)
    K = np.zeros((n, A + 1), np.int8)    # best split; 0 = single root
    leaf_ok = count <= min(L, 31)
    is_leaf_choice = leaf_b.copy()       # slot-root becomes a leaf row
    C[leaf_b, 1:] = (p[leaf_b] * c_leaf)[:, None]
    for idx in batches:
        cl, cr = C[l[idx]], C[r[idx]]    # [B, A+1]
        for i in range(2, A + 1):
            ks = np.arange(1, i)
            cand = cl[:, ks] + cr[:, i - ks]         # [B, i-1]
            j = np.argmin(cand, axis=1)
            C[idx, i] = cand[np.arange(len(idx)), j]
            K[idx, i] = (j + 1).astype(np.int8)
        cost_int = p[idx] + C[idx, A]
        cost_leaf = np.where(leaf_ok[idx], p[idx] * c_leaf, INF)
        pick_leaf = cost_leaf <= cost_int
        C[idx, 1] = np.where(pick_leaf, cost_leaf, cost_int)
        is_leaf_choice[idx] = pick_leaf
        # a forest of i roots may always collapse to a single root
        for i in range(2, A + 1):
            better = C[idx, 1] < C[idx, i]
            C[idx, i] = np.where(better, C[idx, 1], C[idx, i])
            K[idx, i] = np.where(better, np.int8(0), K[idx, i])

    def collect(b, i):
        """Slot roots of subtree b distributed over i slots (iterative)."""
        out, stack = [], [(int(b), int(i))]
        while stack:
            bb, ii = stack.pop()
            k = int(K[bb, ii]) if ii > 1 else 0
            if k == 0:
                out.append(bb)
            else:
                # right first so left's slots come out first (order is
                # cosmetic; traversal orders children by hit distance)
                stack.append((int(r[bb]), ii - k))
                stack.append((int(l[bb]), k))
        return out

    wide_children: list[list] = [None]
    todo = [(0, 0)]
    while todo:
        b, wid = todo.pop()
        entry = []
        for s in collect(b, A):
            if is_leaf_choice[s]:
                entry.append(("leaf", int(first[s]), int(count[s]), s))
            else:
                assert s != b, "internal single-root collapse cycle"
                nwid = len(wide_children)
                wide_children.append(None)
                todo.append((s, nwid))
                entry.append(("inner", nwid, 0, s))
        wide_children[wid] = entry

    depth = 1
    stack = [(0, 1)]
    while stack:
        wid, d = stack.pop()
        depth = max(depth, d)
        for kind, a, _, _ in wide_children[wid]:
            if kind == "inner":
                stack.append((a, d + 1))
    return wide_children, depth


def _row_width(arity: int) -> int:
    """Unified row width. Arity 8 needs 57 f32 for an inner row, but the
    table is built 128 WIDE: the extra columns buy leaf rows 12 inlined
    triangles instead of 6 — halving the leaf visits per ray (the f32
    flush gathers are the most expensive term of the quantized traversal
    loop)."""
    return max(128, -(-(7 * arity + 1) // 8) * 8)


def _pack_wide(nmn, nmx, na, nb, tri9_perm, occluder, arity, L,
               collapse: str = "greedy", c_leaf: float = 2.0):
    """Pack the collapsed wide tree into the unified row table. ``L`` is
    the leaf triangle capacity (also the column layout of leaf rows, so it
    must match the Bvh.leaf_size the traversal decodes with).
    ``collapse``: 'sah' = DP cost-minimizing (_collapse_wide_sah),
    'greedy' = max-area expansion (_collapse_wide)."""
    W = _row_width(arity)
    n_tris = tri9_perm.shape[0]
    assert n_tris < (1 << 24), "first-prim id must be exact in f32"

    if na[0] < 0:  # whole scene is one binary leaf
        first, count = int(~na[0]), int(nb[0])
        assert count <= L
        rows = np.zeros((1, W), np.float32)
        _fill_leaf_row(rows, 0, first, count, tri9_perm, occluder, L)
        return rows, -(0 * 32 + count) - 1, 1, 0

    if collapse == "sah":
        wide_children, depth = _collapse_wide_sah(nmn, nmx, na, nb,
                                                  arity, L, c_leaf)
    else:
        wide_children, depth = _collapse_wide(nmn, nmx, na, nb, arity)
    n_wide = len(wide_children)
    n_leaf = sum(1 for ch in wide_children for c in ch if c[0] == "leaf")
    # bit 30 tags composite stack entries, so (node << A) must fit below it
    assert n_wide < (1 << (30 - arity)), "stack packing needs small codes"
    rows = np.zeros((n_wide + n_leaf, W), np.float32)

    leaf_row = n_wide
    for wid, ch in enumerate(wide_children):
        valid = 0
        for i, (kind, a, cnt, b) in enumerate(ch):
            rows[wid, 6 * i:6 * i + 3] = nmn[b]
            rows[wid, 6 * i + 3:6 * i + 6] = nmx[b]
            valid |= 1 << i
            if kind == "inner":
                code = a
            else:
                assert cnt <= min(L, 31)
                _fill_leaf_row(rows, leaf_row, a, cnt, tri9_perm,
                               occluder, L)
                code = -(leaf_row * 32 + cnt) - 1
                leaf_row += 1
            rows[wid, 6 * arity + i] = _bitcast_i2f(np.asarray([code]))[0]
        rows[wid, 7 * arity] = _bitcast_i2f(np.asarray([valid]))[0]
    return rows, 0, depth, n_wide


def _q_layout(arity: int):
    """(qlo, qhi, codes, valid, width) byte offsets of the int8 inner row:
    org f32x3 at 0, scale f32x3 at 12, then A-child qlo/qhi/codes/valid.
    Width rounds up to 128-byte lanes (128 at A<=8, 256 at A<=16)."""
    o_qlo = 24
    o_qhi = o_qlo + 3 * arity
    o_codes = o_qhi + 3 * arity
    o_valid = o_codes + 4 * arity
    width = -(-(o_valid + 4) // 128) * 128
    return o_qlo, o_qhi, o_codes, o_valid, width


def _build_q_rows(rows, n_wide, arity):
    """int8-quantized inner table (layout in Bvh.q_rows docstring +
    _q_layout). Child boxes are quantized CONSERVATIVELY — the numpy
    verify loop decrements/increments any coordinate whose f32
    dequantization would shrink the box — so quantized traversal visits a
    superset of f32 visits."""
    A = arity
    o_qlo, o_qhi, o_codes, o_valid, qw = _q_layout(A)
    if n_wide == 0:
        return np.zeros((1, qw), np.int8)
    ch = rows[:n_wide, :6 * A].reshape(n_wide, A, 6).astype(np.float32)
    valid_i = np.ascontiguousarray(rows[:n_wide, 7 * A]).view(np.int32)
    codes_i = np.ascontiguousarray(rows[:n_wide, 6 * A:7 * A]
                                   ).view(np.int32)
    vmask = ((valid_i[:, None] >> np.arange(A)) & 1) > 0
    lo, hi = ch[:, :, 0:3], ch[:, :, 3:6]
    org = np.where(vmask[..., None], lo, np.inf).min(axis=1)
    top = np.where(vmask[..., None], hi, -np.inf).max(axis=1)
    org = np.where(np.isfinite(org), org, 0.0).astype(np.float32)
    top = np.where(np.isfinite(top), top, 0.0).astype(np.float32)
    # slight inflation so org + 255*scale >= top under f32 rounding
    scale = (np.maximum(top - org, 1e-20) / 255.0 * (1 + 1e-6)
             ).astype(np.float32)
    o3, s3 = org[:, None, :], scale[:, None, :]
    qlo = np.clip(np.floor((lo - o3) / s3), 0, 255)
    qhi = np.clip(np.ceil((hi - o3) / s3), 0, 255)
    for _ in range(2):  # enforce conservativeness under f32 dequant
        qlo = np.where((o3 + qlo.astype(np.float32) * s3) > lo,
                       np.maximum(qlo - 1, 0), qlo)
        qhi = np.where(((o3 + qhi.astype(np.float32) * s3) < hi)
                       & (qhi < 255), qhi + 1, qhi)
    qlo = np.where(vmask[..., None], qlo, 255).astype(np.uint8)
    qhi = np.where(vmask[..., None], qhi, 0).astype(np.uint8)
    q = np.zeros((n_wide, qw), np.int8)
    q[:, 0:12] = np.ascontiguousarray(org).view(np.int8)
    q[:, 12:24] = np.ascontiguousarray(scale).view(np.int8)
    q[:, o_qlo:o_qlo + 3 * A] = qlo.reshape(n_wide, 3 * A).view(np.int8)
    q[:, o_qhi:o_qhi + 3 * A] = qhi.reshape(n_wide, 3 * A).view(np.int8)
    q[:, o_codes:o_codes + 4 * A] = np.ascontiguousarray(codes_i) \
        .view(np.int8)
    q[:, o_valid:o_valid + 4] = np.ascontiguousarray(valid_i[:, None]) \
        .view(np.int8)
    return q


def _fill_leaf_row(rows, r, first, count, tri9_perm, occluder, L):
    n_tris = tri9_perm.shape[0]
    k = np.arange(L)
    idx = np.minimum(first + k, n_tris - 1)
    valid = k < count
    rows[r, :9 * L] = np.where(valid[:, None], tri9_perm[idx],
                               0.0).reshape(-1)
    rows[r, 9 * L:10 * L] = np.where(valid, occluder[idx], 0.0)
    rows[r, 10 * L] = np.float32(first)


def build_scene_bvh(scene, leaf_size: int | None = None, arity: int = 8,
                    collapse: str = "sah", c_leaf: float = 2.0):
    """Returns (scene-with-permuted-triangles, Bvh). Spheres stay dense
    (their count is tiny in every reference scene).

    ``arity`` is the wide-BVH branching factor; the leaf size is derived
    from the unified row width (128-f32 rows -> 12 triangles/leaf at
    arity 8)."""
    W = _row_width(arity)
    L = (W - 1) // 10
    if leaf_size is not None:
        L = min(L, leaf_size)
    g = scene.geometry
    v0 = np.asarray(g.tri_v0)
    v1 = v0 + np.asarray(g.tri_e1)
    v2 = v0 + np.asarray(g.tri_e2)
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    # DP collapse wants fine binary granularity (it decides leaf
    # boundaries itself, flattening subtrees up to L prims); the greedy
    # collapse consumes builder leaves directly.
    bvh, order = build_bvh_arrays(pmin, pmax,
                                  2 if collapse == "sah" else L)
    perm = jnp.asarray(order)
    geom = g.replace(
        tri_v0=g.tri_v0[perm], tri_e1=g.tri_e1[perm], tri_e2=g.tri_e2[perm],
        tri_n0=g.tri_n0[perm], tri_n1=g.tri_n1[perm], tri_n2=g.tri_n2[perm],
        tri_uv0=g.tri_uv0[perm], tri_uv1=g.tri_uv1[perm],
        tri_uv2=g.tri_uv2[perm], tri_tangent=g.tri_tangent[perm],
        tri_bitangent=g.tri_bitangent[perm], tri_mat=g.tri_mat[perm])

    # pack traversal layout from the PERMUTED triangles; occluder flags are
    # baked (emitter surfaces never occlude — DiffuseEmitter.cu:63-68)
    from ..scene.types import EMITTER
    tri9 = np.concatenate([np.asarray(geom.tri_v0), np.asarray(geom.tri_e1),
                           np.asarray(geom.tri_e2)], axis=1)  # [T,9]
    is_em = (np.asarray(scene.materials.kind)[np.asarray(geom.tri_mat)]
             == EMITTER)
    rows, root_code, depth, n_wide = _pack_wide(
        np.asarray(bvh.nodes_min), np.asarray(bvh.nodes_max),
        np.asarray(bvh.nodes_a), np.asarray(bvh.nodes_b),
        tri9, (~is_em).astype(np.float32), arity, L,
        collapse=collapse, c_leaf=c_leaf)
    # int8 inner table: layout fits A <= 8 (q_rows docstring offsets)
    # the int8 layout holds up to arity 16 in 256-byte rows (_q_layout);
    # wider arities fall back to the f32 loop
    q_rows = (jnp.asarray(_build_q_rows(rows, n_wide, arity))
              if n_wide > 0 and arity <= 16 else None)
    # Stack bound: the f32 loop stores (ancestor, remaining-mask) pairs —
    # one per wide-tree level, depth+1 suffices. The quantized loop with
    # _CODE_STACK pushes up to A-1 child codes per visited level, so its
    # hard bound is (A-1)*depth + 1 (realistic occupancy is far lower,
    # but a silent overflow would corrupt results).
    # hybrid code stack: <= 2 entries (one code + one composite) per
    # wide-tree level
    max_stack = (2 * depth + 1 if (_CODE_STACK and q_rows is not None)
                 else depth + 1)
    bvh = bvh.replace(rows=jnp.asarray(rows), q_rows=q_rows,
                      root_code=root_code,
                      arity=arity, leaf_size=L, max_stack=max_stack)
    return scene.replace(geometry=geom), bvh


# ---------------------------------------------------------------------------
# device traversal
# ---------------------------------------------------------------------------

# node steps fused per while_loop round (tunable)
INNER_STEPS = 4
# below this lane count the compaction ladder stops (compaction overhead
# beats the lockstep saving only for large waves)
LADDER_MIN = 4096
# wave shrink factor per ladder level: fewer, bigger shrinks mean fewer
# lockstep tail rounds and less HLO than halving per level
_LADDER_DIV = 8


# diagnostic: carry a per-lane lockstep-round counter through the q loop
# (scripts/trav_rounds.py); off in production — costs one [N] add/round
_COUNT_ROUNDS = False


def _init_state(bvh: Bvh, o, d, tmin, tmax):
    n = o.shape[0]
    full = (1 << bvh.arity) - 1
    extra = ({"rounds": jnp.zeros((n,), jnp.int32)} if _COUNT_ROUNDS
             else {})
    return dict(
        **extra,
        o=o, d=d, tmin=tmin,
        cur=jnp.full((n,), bvh.root_code, jnp.int32),
        cmask=jnp.full((n,), full, jnp.int32),
        cur_ok=jnp.ones((n,), jnp.bool_),
        pend=jnp.zeros((n,), jnp.int32),   # postponed leaf code (<0) or 0
        pend2=jnp.zeros((n,), jnp.int32),  # second postponement slot
        stack=jnp.zeros((n, bvh.max_stack), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        t_best=jnp.minimum(tmax, BIG),
        i_best=jnp.full((n,), -1, jnp.int32),
        u_best=jnp.zeros((n,)), v_best=jnp.zeros((n,)),
        found=jnp.zeros((n,), jnp.bool_))


def _runnable(st, any_hit):
    run = (st["cur_ok"] | (st["sp"] > 0) | (st["pend"] < 0)
           | (st["pend2"] < 0))
    if any_hit:
        run = run & ~st["found"]
    return run


def _oh_read(stack, pos):
    """stack[i, pos[i]] without a per-lane column gather: one-hot select
    over the short [N, depth+1 ~ 8] stack."""
    S = stack.shape[1]
    m = jnp.arange(S, dtype=pos.dtype)[None, :] == pos[:, None]
    return jnp.sum(jnp.where(m, stack, 0), axis=1)


def _oh_write(stack, pos, val, mask):
    S = stack.shape[1]
    m = ((jnp.arange(S, dtype=pos.dtype)[None, :] == pos[:, None])
         & mask[:, None])
    return jnp.where(m, val[:, None], stack)


def _traverse_impl(bvh: Bvh, geom, o, d, tmin, tmax, any_hit: bool):
    """Wide-BVH wavefront traversal (see module docstring), under a
    compaction ladder: every while-loop round is LOCKSTEP — the full wave
    pays until the slowest lane finishes — so once the unfinished count
    drops below half the wave the live lanes are compacted 2x and the loop
    continues there (recursively, down to LADDER_MIN lanes)."""
    st = _init_state(bvh, o, d, tmin, tmax)
    st = _solve(bvh, st, any_hit)
    return (st["t_best"], st["i_best"], st["u_best"], st["v_best"],
            st["found"])


def _solve(bvh: Bvh, st, any_hit: bool):
    n = st["o"].shape[0]
    if n <= LADDER_MIN:
        return _run_until(bvh, st, any_hit, cap=0)
    n_next = n // _LADDER_DIV
    st = _run_until(bvh, st, any_hit, cap=n_next)
    run = _runnable(st, any_hit)
    # live-first partition via cumsum + scatter: bandwidth-priced where an
    # argsort of the live flags would be O(n log n)
    # Unwritten tail slots stay 0 = lane 0 duplicated: duplicates carry
    # identical state, evolve identically (masked updates), and the
    # merge writes identical values — benign.
    dest = jnp.cumsum(run.astype(jnp.int32)) - 1
    src = jnp.arange(n, dtype=jnp.int32)
    sel = jnp.zeros((n_next,), jnp.int32).at[
        jnp.where(run, dest, n_next)].set(src, mode="drop")
    sub = jax.tree_util.tree_map(lambda a: a[sel], st)
    sub = _solve(bvh, sub, any_hit)
    return jax.tree_util.tree_map(
        lambda full, s: full.at[sel].set(s), st, sub)


def _run_until(bvh: Bvh, st, any_hit: bool, cap: int):
    """Run traversal rounds until <= ``cap`` lanes remain unfinished."""
    if bvh.q_rows is not None:
        return _run_until_q(bvh, st, any_hit, cap)
    n = st["o"].shape[0]
    S = bvh.max_stack
    A = bvh.arity
    L = bvh.leaf_size
    full_mask = (1 << A) - 1
    n_rows = bvh.rows.shape[0]
    ar = jnp.arange(n)
    abits = jnp.arange(A, dtype=jnp.int32)

    def outer_cond(st):
        return jnp.sum(_runnable(st, any_hit)) > cap

    def outer(st):
        o, d, tmin = st["o"], st["d"], st["tmin"]
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)

        def step(_, st2):
            (cur, cmask, cur_ok, stack, sp, t_best, i_best, u_best,
             v_best, found) = st2
            if any_hit:
                cur_ok = cur_ok & ~found

            # refill the cursor from the stack where it ran dry. Entries
            # pack (node << A) | remaining-child-mask; node >= 0 always.
            need = ~cur_ok & (sp > 0)
            if any_hit:
                need = need & ~found
            top = _oh_read(stack, sp - 1)
            cur = jnp.where(need, top >> A, cur)
            cmask = jnp.where(need, top & full_mask, cmask)
            cur_ok = cur_ok | need
            sp = sp - need.astype(jnp.int32)

            is_leaf_c = cur_ok & (cur < 0)
            is_inner = cur_ok & (cur >= 0)

            # ---- ONE unified row gather for both interpretations --------
            dec = -cur - 1
            row_idx = jnp.where(is_inner, cur,
                                jnp.where(is_leaf_c,
                                          jnp.minimum(dec >> 5, n_rows - 1),
                                          0))
            row = bvh.rows[row_idx]                       # [N, W]

            # ---- leaf: dense [N, L] Moller-Trumbore ----------------------
            count = jnp.where(is_leaf_c, dec & 31, 0)
            tri = row[:, :9 * L].reshape(n, L, 9)
            occ_f = row[:, 9 * L:10 * L]
            first = row[:, 10 * L].astype(jnp.int32)
            ks = jnp.arange(L)
            cand = ks[None, :] < count[:, None]
            if any_hit:
                cand = cand & (occ_f > 0.5)
            ob = o[:, None, :]
            db = d[:, None, :]
            v0 = tri[..., 0:3]
            e1 = tri[..., 3:6]
            e2 = tri[..., 6:9]
            pvec = jnp.cross(db, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
            tvec = ob - v0
            u = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1)
            v = jnp.sum(db * qvec, axis=-1) * inv_det
            t = jnp.sum(e2 * qvec, axis=-1) * inv_det
            ok = (cand & (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
                  & (u + v <= 1.0) & (t > tmin[:, None])
                  & (t < t_best[:, None]))
            t = jnp.where(ok, t, BIG)
            if any_hit:
                found = found | jnp.any(t < BIG, axis=1)
            else:
                j = jnp.argmin(t, axis=1)
                tj = t[ar, j]
                better = tj < t_best
                t_best = jnp.where(better, tj, t_best)
                i_best = jnp.where(better, first + j, i_best)
                u_best = jnp.where(better, u[ar, j], u_best)
                v_best = jnp.where(better, v[ar, j], v_best)
                found = found | better

            # ---- inner: slab all A children, masked by cmask -------------
            ch = row[:, :6 * A].reshape(n, A, 6)
            t0 = (ch[..., 0:3] - ob) * inv_d[:, None, :]
            t1 = (ch[..., 3:6] - ob) * inv_d[:, None, :]
            tn = jnp.maximum(jnp.max(jnp.minimum(t0, t1), -1),
                             tmin[:, None])
            tf = jnp.minimum(jnp.min(jnp.maximum(t0, t1), -1),
                             t_best[:, None])
            valid = jax.lax.bitcast_convert_type(row[:, 7 * A], jnp.int32)
            mbit = ((cmask & valid)[:, None] >> abits[None, :]) & 1
            hit = (tn <= tf) & (mbit > 0) & is_inner[:, None]
            codes = jax.lax.bitcast_convert_type(
                row[:, 6 * A:7 * A], jnp.int32)                 # [N, A]

            # nearest hit child -> cursor; re-push (cur, remaining mask)
            # when >= 2 children hit. One-hot over A avoids per-lane minor-
            # axis gathers.
            key = jnp.where(hit, tn, BIG)
            j2 = jnp.argmin(key, axis=1)
            oh = abits[None, :] == j2[:, None]
            go = jnp.sum(jnp.where(oh, codes, 0), axis=1)
            khits = jnp.sum(hit, axis=1)
            rem = jnp.sum(jnp.where(hit & ~oh, 1 << abits[None, :], 0),
                          axis=1)
            push = is_inner & (khits >= 2)
            stack = _oh_write(stack, sp, (cur << A) | rem, push)
            sp = sp + push.astype(jnp.int32)

            cur = jnp.where(is_inner, go, cur)
            cmask = jnp.where(is_inner, full_mask, cmask)
            cur_ok = jnp.where(is_inner, khits > 0, cur_ok & ~is_leaf_c)
            return (cur, cmask, cur_ok, stack, sp, t_best, i_best, u_best,
                    v_best, found)

        # fori_loop, not a Python unroll: the traversal body hides the
        # loop overhead behind its own dependency chain, and the unrolled
        # form only bloats compile time.
        out = jax.lax.fori_loop(
            0, INNER_STEPS, step,
            (st["cur"], st["cmask"], st["cur_ok"], st["stack"], st["sp"],
             st["t_best"], st["i_best"], st["u_best"], st["v_best"],
             st["found"]))
        (cur, cmask, cur_ok, stack, sp, t_best, i_best, u_best, v_best,
         found) = out
        return dict(o=o, d=d, tmin=tmin, cur=cur, cmask=cmask,
                    cur_ok=cur_ok, pend=st["pend"], pend2=st["pend2"],
                    stack=stack, sp=sp,
                    t_best=t_best, i_best=i_best, u_best=u_best,
                    v_best=v_best, found=found)

    return jax.lax.while_loop(outer_cond, outer, st)


# phase schedule per while-loop round of the QUANTIZED loop: inner steps
# gather only the cheap int8 table; flush steps run the f32 leaf gather +
# Moller-Trumbore for lanes holding a postponed leaf. 2:1 approximates
# the measured Atrium inner:leaf visit ratio (~13:5.5 per ray).
_Q_SCHEDULE = ("i", "i", "f", "i", "i", "f")
# Dynamic mode: each while-loop round runs ONE phase, picked by flush
# pressure — flush when the postponed-leaf population outweighs the
# inner-progressable population by _Q_FLUSH_K (the flush:inner
# phase cost ratio). Adapts the schedule to
# the wave state (early traversal = all inner; tail = mostly flush) and
# compiles ONE copy of each phase body per ladder level instead of
# len(_Q_SCHEDULE) copies.
_Q_DYNAMIC = True
_Q_FLUSH_K = 1.5
# dynamic phases executed per while-loop round. >1 would amortize the
# full-wave outer_cond reduction across phases, but the pressure
# decision itself pays two [N] sums per phase either way, and each extra
# phase is another copy of the body to compile.
_Q_PHASES_PER_ROUND = 1
# HYBRID stack. A stack of (node, remaining-mask) pairs makes every
# popped extra child re-gather and re-decode the parent row (about a
# third of the inner rounds on Atrium). Pushing ALL child codes
# (far-first sorted) removes the re-decodes but needs an
# (A-1)*depth-deep stack and an in-loop sort, whose [N,64] one-hot
# stack traffic costs more than it saves. The hybrid pushes the
# SECOND-NEAREST child as
# a plain code (k=2 is the dominant multi-hit case — kills its
# re-decode) plus ONE tagged (node, mask-of-remainder) entry when k>=3
# (rare; those children still pay a re-decode each but re-slab against
# the improved t_best). Stack bound: 2 entries per level -> 2*depth+1.
# Composite entries are tagged with bit 30 (node row index < 2^22
# asserted at build); plain inner codes (< 2^22) and leaf codes (< 0)
# never carry it.
_CODE_STACK = True
_COMP_TAG = 1 << 30
# Forced double flush before each ladder compaction ("tail shaping"):
# the full-wave f32 leaf gathers outside the while_loop cost more than
# the retired pend lanes save, so it is off.
_FLUSH_AT_LADDER = False


def _run_until_q(bvh: Bvh, st, any_hit: bool, cap: int):
    """Traversal on the int8 quantized inner table (Bvh.q_rows): inner
    steps pay the ~3.8 ns int8 row gather instead of the 13.3 ns f32 one;
    leaf tests are POSTPONED into per-lane ``pend`` registers and run in
    flush phases against the exact f32 leaf rows, so results match the
    unquantized loop exactly (conservative child boxes only add visits)."""
    n = st["o"].shape[0]
    A = bvh.arity
    L = bvh.leaf_size
    full_mask = (1 << A) - 1
    n_rows = bvh.rows.shape[0]
    nq = bvh.q_rows.shape[0]
    ar = jnp.arange(n)
    abits = jnp.arange(A, dtype=jnp.int32)

    def outer_cond(st):
        return jnp.sum(_runnable(st, any_hit)) > cap

    o, d, tmin = st["o"], st["d"], st["tmin"]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    ob = o[:, None, :]
    db = d[:, None, :]

    def inner(c):
        (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best, i_best,
         u_best, v_best, found) = c
        if any_hit:
            cur_ok = cur_ok & ~found
        # refill cursor from the stack where it ran dry
        need = ~cur_ok & (sp > 0)
        if any_hit:
            need = need & ~found
        top = _oh_read(stack, sp - 1)
        if _CODE_STACK:
            # plain code (leaf < 0 or inner < 2^22) vs tagged composite
            is_comp = need & (top >= _COMP_TAG)
            untag = top & ~_COMP_TAG
            cur = jnp.where(need,
                            jnp.where(is_comp, untag >> A, top), cur)
            cmask = jnp.where(need,
                              jnp.where(is_comp, untag & full_mask,
                                        full_mask), cmask)
        else:
            cur = jnp.where(need, top >> A, cur)
            cmask = jnp.where(need, top & full_mask, cmask)
        cur_ok = cur_ok | need
        sp = sp - need.astype(jnp.int32)

        # postpone a leaf cursor into pend/pend2 (capacity 2; a lane
        # with both slots full stalls with the cursor held until a
        # flush — capacity 2 halves the stall-driven flush pressure)
        is_leaf_c = cur_ok & (cur < 0)
        take = is_leaf_c & (pend == 0)
        pend = jnp.where(take, cur, pend)
        take2 = is_leaf_c & ~take & (pend2 == 0)
        pend2 = jnp.where(take2, cur, pend2)
        cur_ok = cur_ok & ~(take | take2)
        is_inner = cur_ok & (cur >= 0)

        # ---- ONE cheap int8 row gather + decode ----------------------
        o_qlo, o_qhi, o_codes, o_valid, _qw = _q_layout(A)
        qrow = bvh.q_rows[jnp.where(is_inner,
                                    jnp.minimum(cur, nq - 1), 0)]
        org = jax.lax.bitcast_convert_type(
            qrow[:, 0:12].reshape(n, 3, 4), jnp.float32)
        scl = jax.lax.bitcast_convert_type(
            qrow[:, 12:24].reshape(n, 3, 4), jnp.float32)
        qlo = jax.lax.bitcast_convert_type(
            qrow[:, o_qlo:o_qlo + 3 * A], jnp.uint8).astype(jnp.float32)
        qhi = jax.lax.bitcast_convert_type(
            qrow[:, o_qhi:o_qhi + 3 * A], jnp.uint8).astype(jnp.float32)
        lo = org[:, None, :] + qlo.reshape(n, A, 3) * scl[:, None, :]
        hi = org[:, None, :] + qhi.reshape(n, A, 3) * scl[:, None, :]
        codes = jax.lax.bitcast_convert_type(
            qrow[:, o_codes:o_codes + 4 * A].reshape(n, A, 4), jnp.int32)
        valid = jax.lax.bitcast_convert_type(
            qrow[:, o_valid:o_valid + 4].reshape(n, 1, 4), jnp.int32)[:, 0]

        t0 = (lo - ob) * inv_d[:, None, :]
        t1 = (hi - ob) * inv_d[:, None, :]
        tn = jnp.maximum(jnp.max(jnp.minimum(t0, t1), -1),
                         tmin[:, None])
        tf = jnp.minimum(jnp.min(jnp.maximum(t0, t1), -1),
                         t_best[:, None])
        mbit = ((cmask & valid)[:, None] >> abits[None, :]) & 1
        hit = (tn <= tf) & (mbit > 0) & is_inner[:, None]
        khits = jnp.sum(hit, axis=1)

        if _CODE_STACK:
            # nearest child -> cursor; SECOND-nearest -> plain code
            # push; children 3..k -> one tagged (node, mask) composite
            # pushed underneath (popped last, re-decoded with the
            # then-current t_best).
            key = jnp.where(hit, tn, BIG)
            j1 = jnp.argmin(key, axis=1)
            oh1 = abits[None, :] == j1[:, None]
            go = jnp.sum(jnp.where(oh1, codes, 0), axis=1)
            key2 = jnp.where(oh1, BIG, key)
            j2 = jnp.argmin(key2, axis=1)
            oh2 = abits[None, :] == j2[:, None]
            code2 = jnp.sum(jnp.where(oh2, codes, 0), axis=1)
            rem = jnp.sum(jnp.where(hit & ~oh1 & ~oh2,
                                    1 << abits[None, :], 0), axis=1)
            push_c = is_inner & (khits >= 3)
            stack = _oh_write(stack, sp,
                              _COMP_TAG | (cur << A) | rem, push_c)
            sp = sp + push_c.astype(jnp.int32)
            push2 = is_inner & (khits >= 2)
            stack = _oh_write(stack, sp, code2, push2)
            sp = sp + push2.astype(jnp.int32)
            cmask = jnp.where(is_inner, full_mask, cmask)
        else:
            key = jnp.where(hit, tn, BIG)
            j2 = jnp.argmin(key, axis=1)
            oh = abits[None, :] == j2[:, None]
            go = jnp.sum(jnp.where(oh, codes, 0), axis=1)
            rem = jnp.sum(jnp.where(hit & ~oh, 1 << abits[None, :], 0),
                          axis=1)
            push = is_inner & (khits >= 2)
            stack = _oh_write(stack, sp, (cur << A) | rem, push)
            sp = sp + push.astype(jnp.int32)
            cmask = jnp.where(is_inner, full_mask, cmask)

        cur = jnp.where(is_inner, go, cur)
        cur_ok = jnp.where(is_inner, khits > 0, cur_ok)
        return (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best,
                i_best, u_best, v_best, found)

    def flush(c):
        (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best, i_best,
         u_best, v_best, found) = c
        has = pend < 0
        if any_hit:
            has = has & ~found
        dec = -pend - 1
        row = bvh.rows[jnp.where(has,
                                 jnp.minimum(dec >> 5, n_rows - 1),
                                 0)]
        count = jnp.where(has, dec & 31, 0)
        tri = row[:, :9 * L].reshape(n, L, 9)
        occ_f = row[:, 9 * L:10 * L]
        first = row[:, 10 * L].astype(jnp.int32)
        ks = jnp.arange(L)
        cand = ks[None, :] < count[:, None]
        if any_hit:
            cand = cand & (occ_f > 0.5)
        v0 = tri[..., 0:3]
        e1 = tri[..., 3:6]
        e2 = tri[..., 6:9]
        pvec = jnp.cross(db, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = ob - v0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(db * qvec, axis=-1) * inv_det
        t = jnp.sum(e2 * qvec, axis=-1) * inv_det
        ok = (cand & (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
              & (u + v <= 1.0) & (t > tmin[:, None])
              & (t < t_best[:, None]))
        t = jnp.where(ok, t, BIG)
        if any_hit:
            found = found | jnp.any(t < BIG, axis=1)
        else:
            j = jnp.argmin(t, axis=1)
            tj = t[ar, j]
            better = tj < t_best
            t_best = jnp.where(better, tj, t_best)
            i_best = jnp.where(better, first + j, i_best)
            u_best = jnp.where(better, u[ar, j], u_best)
            v_best = jnp.where(better, v[ar, j], v_best)
            found = found | better
        pend = jnp.where(has, 0, pend)
        # promote slot 2 so the next flush sees it
        promote = (pend == 0) & (pend2 < 0)
        pend = jnp.where(promote, pend2, pend)
        pend2 = jnp.where(promote, 0, pend2)
        return (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best,
                i_best, u_best, v_best, found)

    def outer(st):
        c = (st["cur"], st["cmask"], st["cur_ok"], st["pend"],
             st["pend2"], st["stack"], st["sp"], st["t_best"],
             st["i_best"], st["u_best"], st["v_best"], st["found"])
        if _Q_DYNAMIC:
            # _Q_PHASES_PER_ROUND dynamic phases per while round, each
            # picked by flush pressure. A lane can progress in an inner
            # phase if its cursor is an inner node, it can refill from
            # the stack, or it holds a leaf cursor with a free pend
            # slot; a flush pays off proportionally to the slot-0 pend
            # population. Multiple phases per round amortize the
            # full-wave outer_cond reduction (one [N] sum per round).
            for _ in range(_Q_PHASES_PER_ROUND):
                (cur, cmask, cur_ok, pend, pend2, *_rest) = c
                sp_ = c[6]
                found_ = c[11]
                free_pend = (pend == 0) | (pend2 == 0)
                prog = ((cur_ok & ((cur >= 0) | free_pend))
                        | (~cur_ok & (sp_ > 0)))
                n_pend = pend < 0
                if any_hit:
                    prog = prog & ~found_
                    n_pend = n_pend & ~found_
                do_flush = (jnp.sum(n_pend).astype(jnp.float32)
                            > _Q_FLUSH_K
                            * jnp.sum(prog).astype(jnp.float32))
                c = jax.lax.cond(do_flush, flush, inner, c)
        else:
            for phase in _Q_SCHEDULE:
                c = inner(c) if phase == "i" else flush(c)
        (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best, i_best,
         u_best, v_best, found) = c
        extra = ({"rounds": st["rounds"] + 1} if "rounds" in st
                 else {})
        return dict(**extra, o=o, d=d, tmin=tmin, cur=cur, cmask=cmask,
                    cur_ok=cur_ok, pend=pend, pend2=pend2, stack=stack,
                    sp=sp, t_best=t_best, i_best=i_best, u_best=u_best,
                    v_best=v_best, found=found)

    st = jax.lax.while_loop(outer_cond, outer, st)
    if cap > 0 and _FLUSH_AT_LADDER:
        # retire pend-only lanes at the ladder boundary so they do not
        # drag into the compacted subwave (two flushes: slot 0 + the
        # promoted slot 1)
        c = (st["cur"], st["cmask"], st["cur_ok"], st["pend"],
             st["pend2"], st["stack"], st["sp"], st["t_best"],
             st["i_best"], st["u_best"], st["v_best"], st["found"])
        c = flush(flush(c))
        (cur, cmask, cur_ok, pend, pend2, stack, sp, t_best, i_best,
         u_best, v_best, found) = c
        extra = {"rounds": st["rounds"]} if "rounds" in st else {}
        st = dict(**extra, o=o, d=d, tmin=tmin, cur=cur, cmask=cmask,
                  cur_ok=cur_ok, pend=pend, pend2=pend2, stack=stack,
                  sp=sp, t_best=t_best, i_best=i_best, u_best=u_best,
                  v_best=v_best, found=found)
    return st



# Live-first chunking of the incoherent wavefront: integrators mark dead
# lanes with
# tmax <= tmin (PT after ray termination/RR, shadow lanes of inactive
# paths). A dead lane still PAYS every lockstep round until the first
# ladder boundary drops it (scripts/trav_rounds.py counts the rounds).
# Instead: partition lanes live-first with a cumsum
# (no sort), split into _LIVE_CHUNKS static chunks, and lax.map ONE
# compiled solve over them sequentially — chunks holding only dead
# lanes exit their while_loop immediately, so a wave with live
# fraction f costs ~ceil(f*C)/C of the full-width dispatch. The lax.map
# nested inside the scan/fori dispatch multiplies compile time and
# segment liveness decays slower than modeled, so the default is 1
# (off).
_LIVE_CHUNKS = 1


def _traverse_chunked(bvh: Bvh, geom, o, d, tmin, tmax, any_hit: bool):
    n = o.shape[0]
    C = _LIVE_CHUNKS
    if C <= 1 or n % C != 0 or n // C < LADDER_MIN:
        return _traverse_impl(bvh, geom, o, d, tmin, tmax, any_hit)
    run = tmax > tmin
    live = jnp.cumsum(run.astype(jnp.int32))
    nlive = live[-1]
    dead = jnp.cumsum((~run).astype(jnp.int32))
    pos = jnp.where(run, live - 1, nlive + dead - 1)   # lane -> slot
    perm = jnp.zeros((n,), jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32))                # slot -> lane
    chunks = jax.tree_util.tree_map(
        lambda a: a[perm].reshape(C, n // C, *a.shape[1:]),
        (o, d, tmin, tmax))

    def body(ch):
        return _traverse_impl(bvh, geom, *ch, any_hit)

    outs = jax.lax.map(body, chunks)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(n, *a.shape[2:])[pos], outs)


@jax.custom_vjp
def traverse(bvh: Bvh, geom, o, d, tmin, tmax):
    """Closest hit via BVH: returns (t, prim_idx, u, v, found). Gradients
    are defined as zero (geometry-only computation; see module docstring)."""
    return _traverse_chunked(bvh, geom, o, d, tmin, tmax, any_hit=False)


def _traverse_fwd(bvh, geom, o, d, tmin, tmax):
    return traverse(bvh, geom, o, d, tmin, tmax), (bvh, geom, o, d, tmin,
                                                   tmax)


def _traverse_bwd(res, g):
    bvh, geom, o, d, tmin, tmax = res
    zeros = jax.tree_util.tree_map(jnp.zeros_like, (bvh, geom, o, d, tmin,
                                                    tmax))
    return zeros


traverse.defvjp(_traverse_fwd, _traverse_bwd)


@jax.custom_vjp
def traverse_any(bvh: Bvh, geom, occluder_mask, o, d, tmin, tmax):
    """Any-hit (occlusion); early-outs once a lane is blocked. Returns [N]
    bool. The occluder mask (emitters never occlude) is BAKED into the
    packed leaf rows at build time — the ``occluder_mask`` argument is kept
    for API stability and ignored."""
    del occluder_mask
    _, _, _, _, found = _traverse_chunked(bvh, geom, o, d, tmin, tmax,
                                          any_hit=True)
    return found


def _any_fwd(bvh, geom, occluder_mask, o, d, tmin, tmax):
    return traverse_any(bvh, geom, occluder_mask, o, d, tmin, tmax), \
        (bvh, geom, occluder_mask, o, d, tmin, tmax)


def _any_bwd(res, g):
    return jax.tree_util.tree_map(jnp.zeros_like, res)


traverse_any.defvjp(_any_fwd, _any_bwd)
