"""Morton-window approximate self-KNN for large clouds.

The covariance/normal neighborhood pass needs k≈10-20 neighbors for EVERY
point of a raw scan (``feature/covariance.hpp:260-503`` runs it through a
KD-tree in the reference).  Dense approaches are bandwidth-bound at
O(N·M), and gather-based spatial structures pay a gather per candidate.

Alternative: order points along a space-filling curve, then
almost all true neighbors sit within a small WINDOW of the sorted order —
and window distances need no gathers at all, only shifted slices:

  1. 30-bit Morton codes (3 x 10-bit interleave, vectorized bit-spreads);
  2. ONE device sort (points ride as payload);
  3. distances point-vs-(sorted neighbors at offsets ±1..±W) as a dense
     [N, 2W] computation built from rolls of the sorted array;
  4. ``top_k`` over the window; map window offsets back through the sort
     permutation (one [N, k] gather — the only gather in the pipeline).

Cost is O(N · W) instead of O(N · M): at N=131k, W=64, that is 64x less
distance work than dense self-KNN.  Recall is measured, not assumed (see
tests/test_window_knn.py and the committed crossover artifact); a second
pass in a different axis-interleave order unions out the curve-boundary
misses exactly like ``approx_knn``'s permuted second pass.

Intended use: covariance/normal neighborhoods on raw-scale clouds, where
~2% approximate neighbors are measurably irrelevant to registration
results (same contract as :func:`sycl_points_tpu.ops.knn.approx_knn`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult

_BIG = 3.0e38


def _spread10(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of int32 lanes to every 3rd bit position."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(
    points: jax.Array,
    valid: jax.Array,
    cell_size: float,
    axis_order: tuple = (0, 1, 2),
) -> jax.Array:
    """30-bit Morton codes over 10-bit per-axis cells re-based to the cloud
    minimum (per-frame extent 1024 cells/axis, like ops.voxel).  Invalid
    points get the maximal code and sort to the tail.  ``axis_order``
    permutes which axis owns the low interleave bit — a cheap second
    independent curve for the two-pass union."""
    pts = points[:, list(axis_order)]
    scaled = pts * (1.0 / cell_size)
    finite = jnp.all(jnp.isfinite(scaled), axis=-1) & valid
    c = jnp.floor(scaled).astype(jnp.int32)
    big = jnp.int32(2**30)
    cmin = jnp.min(jnp.where(finite[:, None], c, big), axis=0)
    rel = jnp.clip(c - cmin, 0, 1023)
    code = _spread10(rel[:, 0]) | (_spread10(rel[:, 1]) << 1) | (
        _spread10(rel[:, 2]) << 2
    )
    return jnp.where(finite, code, jnp.int32(2**31 - 1))


def _window_pass(
    points: jax.Array,  # [N, 3]
    mask: jax.Array,  # [N]
    k: int,
    window: int,
    cell_size: float,
    axis_order: tuple,
):
    """One sorted-window pass: (indices [N, k] into the ORIGINAL order,
    d2 [N, k])."""
    N = points.shape[0]
    code = morton_codes(points, mask, cell_size, axis_order)
    # payload sort: points + original index + validity ride the code sort
    idx = jnp.arange(N, dtype=jnp.int32)
    code_s, x_s, y_s, z_s, idx_s, ok_s = jax.lax.sort(
        (code, points[:, 0], points[:, 1], points[:, 2], idx,
         mask.astype(jnp.int32)),
        num_keys=1,
    )
    pts_s = jnp.stack([x_s, y_s, z_s], axis=1)
    okf = ok_s == 1

    # [N, 2W] distances to sorted-order neighbors via rolls (shifted slices;
    # no gathers).  Rolled-over boundary entries are masked by validity of
    # the partner plus an index-range check.
    offs = [o for o in range(-window, window + 1) if o != 0]
    cols_d = []
    for o in offs:
        p2 = jnp.roll(pts_s, -o, axis=0)
        ok2 = jnp.roll(okf, -o, axis=0)
        j = idx + o  # sorted position of the partner
        in_rng = (j >= 0) & (j < N)
        diff = pts_s - p2
        d2 = jnp.sum(diff * diff, axis=-1)
        cols_d.append(jnp.where(okf & ok2 & in_rng, d2, _BIG))
    D = jnp.stack(cols_d, axis=1)  # [N, 2W]

    neg, sel = jax.lax.top_k(-D, k)  # best k window slots per point
    off_arr = jnp.asarray(offs, jnp.int32)
    j = jnp.clip(idx[:, None] + off_arr[sel], 0, N - 1)  # sorted positions
    orig = idx_s[j]  # [N, k] gather (small)
    d = -neg
    # scatter the per-sorted-position results back to the original order
    out_i = jnp.zeros((N, k), jnp.int32).at[idx_s].set(orig)
    out_d = jnp.full((N, k), _BIG, jnp.float32).at[idx_s].set(d)
    return out_i, out_d


def window_self_knn(
    points: jax.Array,
    mask: jax.Array,
    k: int,
    window: int = 64,
    cell_size: float = 0.5,
    passes: int = 2,
) -> KNNResult:
    """Approximate self-KNN (every point queries the whole cloud).  Jittable.

    ``window`` is the one-sided sorted-order search radius; ``passes=2``
    unions a second Morton order (axis interleave rotated) and exact-top-ks
    the union, recovering the curve-boundary misses.  Distances are exact
    f32 for every reported neighbor; approximation only means a true
    neighbor can be replaced by the next-nearest one outside both windows.
    """
    i1, d1 = _window_pass(points, mask, k, window, cell_size, (0, 1, 2))
    if passes <= 1:
        return KNNResult(i1, jnp.where(d1 >= _BIG, jnp.inf, d1))
    i2, d2 = _window_pass(points, mask, k, window, cell_size, (2, 0, 1))
    idx = jnp.concatenate([i1, i2], axis=1)
    dd = jnp.concatenate([d1, d2], axis=1)
    idx_s, dd_s = jax.lax.sort((idx, dd), num_keys=1, dimension=1)
    dup = (idx_s == jnp.roll(idx_s, 1, axis=1)).at[:, 0].set(False)
    dd_s = jnp.where(dup, _BIG, dd_s)
    neg, sel = jax.lax.top_k(-dd_s, k)
    out_d = -neg
    return KNNResult(
        jnp.take_along_axis(idx_s, sel, axis=1),
        jnp.where(out_d >= _BIG, jnp.inf, out_d),
    )
