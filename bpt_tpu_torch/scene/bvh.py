"""Host-side BVH builder (numpy) -> threaded-DFS flat arrays.

A copy of the numpy path of ``bpt_tpu.scene.bvh.build_bvh``, which the
reference's build policy defines (src/acceleration/bvh.h:20-48): node bbox =
union of member bboxes padded to min width 1e-4 per axis
(src/acceleration/aabb.h:81-88), split axis = longest axis, sort the span by
per-triangle bbox min on that axis, split at the (packing-rounded) median;
spans of 1-2 become leaves.  The builder uses ``order`` so triangle ids and
summation order match ``bpt_tpu`` exactly.
"""

from __future__ import annotations

import sys

import numpy as np

_PAD_DELTA = 1.0e-4  # src/acceleration/aabb.h:84
_PACK_TRIS = 32  # streaming-block grain of bpt_tpu's split rounding


def subtree_splits(bvh_skip, bvh_count, max_tris: int):
    """Greedy maximal-subtree triangle-range split points (bpt_tpu/scene/
    bvh.py:29-57).

    Walks the preorder/skip-link node array; at each node whose subtree
    holds <= max_tris triangles, emits the subtree's contiguous triangle
    range as one segment and jumps the whole subtree.  The triangle order
    is the BVH leaf order, so the segments tile [0, T) and each one is a
    subtree of the build.  The clustered hit kernels (ops/clusters.py)
    take these as their clusters and superclusters."""
    skip = np.asarray(bvh_skip, np.int64)
    count = np.asarray(bvh_count, np.int64)
    N = skip.shape[0]
    pre = np.zeros(N + 1, np.int64)
    pre[1:] = np.cumsum(count)
    tri_count = pre[skip] - pre[:N]
    splits = [0]
    pos = 0
    while pos < N:
        tc = int(tri_count[pos])
        if 0 < tc <= max_tris:
            splits.append(int(pre[pos]) + tc)
            pos = int(skip[pos])
        else:
            pos += 1
    return tuple(splits)


def merge_splits(cs, ss, cap: int):
    """Greedy fill-merge of adjacent subtree segments up to ``cap``
    triangles, closing at every ``ss`` boundary so that the outer and
    inner splits stay aligned (bpt_tpu/scene/bvh.py:60-80)."""
    ssi = frozenset(ss)
    merged = [cs[0]]
    for k in range(1, len(cs)):
        b = cs[k]
        if b == cs[-1] or b in ssi or (cs[k + 1] - merged[-1]) > cap:
            merged.append(b)
    return tuple(merged)


def _pad_box(bmin: np.ndarray, bmax: np.ndarray):
    size = bmax - bmin
    pad = np.where(size < _PAD_DELTA, _PAD_DELTA / 2.0, 0.0)
    return bmin - pad, bmax + pad


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray):
    """Build from per-triangle bounds [T,3] (float64 host math).

    Returns dict with preorder node arrays (bvh_min, bvh_max, bvh_skip,
    bvh_first, bvh_count) and ``order`` — the triangle permutation such that
    leaves cover contiguous ranges of the permuted triangle arrays.
    """
    T = tri_min.shape[0]
    if T == 0:
        return dict(
            bvh_min=np.zeros((1, 3)),
            bvh_max=np.zeros((1, 3)),
            bvh_skip=np.array([1], np.int32),
            bvh_first=np.array([0], np.int32),
            bvh_count=np.array([0], np.int32),
            order=np.zeros((0,), np.int64),
        )

    tri_min = np.asarray(tri_min, np.float64)
    tri_max = np.asarray(tri_max, np.float64)

    node_min, node_max = [], []
    node_skip, node_first, node_count = [], [], []
    new_order: list[int] = []

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(idx: np.ndarray):
        my_pos = len(node_min)
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        bmin, bmax = _pad_box(bmin, bmax)
        node_min.append(bmin)
        node_max.append(bmax)
        node_skip.append(-1)  # patched after subtree emitted

        span = len(idx)
        if span <= 2:
            node_first.append(len(new_order))
            node_count.append(span)
            new_order.extend(idx.tolist())
        else:
            node_first.append(0)
            node_count.append(0)
            axis = int(np.argmax(bmax - bmin))  # longest_axis, aabb.h:68-75
            keys = tri_min[idx, axis]
            order = np.argsort(keys, kind="stable")
            idx = idx[order]
            if span > _PACK_TRIS:
                # packing-aware median: the split rounds to a _PACK_TRIS
                # multiple; floor(x+0.5) == C++ llround for positive x
                mid = int(np.clip(
                    int(span / (2 * _PACK_TRIS) + 0.5) * _PACK_TRIS,
                    _PACK_TRIS, span - 1))
            else:
                mid = span // 2  # bvh.h:43
            rec(idx[:mid])
            rec(idx[mid:])
        node_skip[my_pos] = len(node_min)

    rec(np.arange(T))

    return dict(
        bvh_min=np.stack(node_min),
        bvh_max=np.stack(node_max),
        bvh_skip=np.asarray(node_skip, np.int32),
        bvh_first=np.asarray(node_first, np.int32),
        bvh_count=np.asarray(node_count, np.int32),
        order=np.asarray(new_order, np.int64),
    )
