"""Range-image KNN: neighbor search for raw spinning-LiDAR scans in O(N).

The covariance/normal neighborhood pass (``feature/covariance.hpp:260-503``)
needs k~10-20 neighbors for every point of a raw scan.  Dense matmul KNN is
O(N*M) and memory-bound; tree/grid structures need gathers per candidate.

A spinning LiDAR's geometry IS a 2-D grid: every return lives in a unique
(azimuth column, elevation ring) cell.  Scatter the cloud into that dense
[n_az, n_rings] range image once, and the k nearest neighbors of a point
are (measured) almost surely inside a small 2-D cell window around it —
computed with IMAGE ROLLS, no gathers, no trees:

  1. azimuth/elevation binning (center-offset bins; collision telemetry);
  2. one scatter into the dense image (points + original indices);
  3. for each of the (2*Waz+1)*(2*Wel+1) window offsets: a 2-D roll of the
     image (azimuth circular, elevation clamped) + exact f32 distances;
  4. ``top_k`` over the window; original indices ride the same rolls.

Cost is O(N * window) — 117 candidate cells replaces M=131k candidates.
Measured recall vs exact brute force on the synthetic Velodyne world:
0.998 at window (6, 4), 0.9993 at (8, 4) (tests/test_range_image_knn.py).
Approximation contract matches :func:`sycl_points_tpu.ops.knn.approx_knn`:
intended for neighborhood collection on SENSOR-FRAME raw scans (before any
downsampling destroys the grid structure); the ICP correspondence search
stays exact.

Reference parity note: this replaces the KD-tree self-search the reference
runs per scan (``pipeline/pointcloud_processing.hpp:62``) for the raw-scan
tier; the generic-cloud path (post-voxel clouds, arbitrary targets) stays
on ops.knn.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult

_BIG = 3.0e38


class RangeImageKNNResult(NamedTuple):
    knn: KNNResult
    collisions: jax.Array  # i32: points sharing a cell with another point
    # (they inherit the cell winner's neighborhood — telemetry, no silent cap)


def range_image_knn(
    points: jax.Array,  # [N, 3] sensor-frame
    mask: jax.Array,  # [N] bool
    k: int,
    n_az: int = 2048,
    n_rings: int = 64,
    window_az: int = 6,
    window_el: int = 4,
    el_min: Optional[float] = None,
    el_max: Optional[float] = None,
) -> RangeImageKNNResult:
    """Self-KNN over a raw spinning-LiDAR scan via its dense range image.

    ``el_min``/``el_max`` bound the elevation fan; ``None`` derives them
    from the scan (masked min/max — fine for full scans, pass the sensor
    constants for partial ones).  Jittable; all shapes static.
    """
    N = points.shape[0]
    C = n_az * n_rings

    r = jnp.linalg.norm(points, axis=1)
    ok = mask & jnp.isfinite(r) & (r > 1e-6)
    az = jnp.arctan2(points[:, 1], points[:, 0])
    el = jnp.arcsin(jnp.clip(points[:, 2] / jnp.maximum(r, 1e-9), -1.0, 1.0))

    if el_min is None:
        el_lo = jnp.min(jnp.where(ok, el, jnp.inf))
    else:
        el_lo = jnp.float32(el_min)
    if el_max is None:
        el_hi = jnp.max(jnp.where(ok, el, -jnp.inf))
    else:
        el_hi = jnp.float32(el_max)
    span = jnp.maximum(el_hi - el_lo, 1e-6)

    # center-offset bins: ray angles sit at bin centers, not edges (edge
    # placement made ~25% of returns straddle into the neighbor bin)
    azb = jnp.floor((az + jnp.pi) / (2.0 * jnp.pi) * n_az + 0.5).astype(jnp.int32) % n_az
    elb = jnp.clip(
        jnp.floor((el - el_lo) / span * (n_rings - 1) + 0.5).astype(jnp.int32),
        0, n_rings - 1,
    )
    cell = jnp.where(ok, azb * n_rings + elb, C)  # invalid -> dropped slot

    # occupancy + collision telemetry (one scatter-add)
    occ = jnp.zeros((C + 1,), jnp.int32).at[cell].add(1)
    collisions = jnp.sum(jnp.maximum(occ[:C] - 1, 0))

    # dense image scatter (last writer wins for colliding returns)
    img_p = jnp.zeros((C + 1, 3), jnp.float32).at[cell].set(points)
    img_i = jnp.full((C + 1,), -1, jnp.int32).at[cell].set(
        jnp.arange(N, dtype=jnp.int32)
    )
    IP = img_p[:C].reshape(n_az, n_rings, 3)
    II = img_i[:C].reshape(n_az, n_rings)
    IO = (occ[:C] > 0).reshape(n_az, n_rings)

    # window distances via 2-D rolls (azimuth circular, elevation masked)
    ring = jnp.arange(n_rings, dtype=jnp.int32)
    cols_d = []
    cols_j = []
    for da in range(-window_az, window_az + 1):
        for de in range(-window_el, window_el + 1):
            P2 = jnp.roll(IP, (-da, -de), axis=(0, 1))
            O2 = jnp.roll(IO, (-da, -de), axis=(0, 1))
            J2 = jnp.roll(II, (-da, -de), axis=(0, 1))
            el_ok = ((ring + de) >= 0) & ((ring + de) < n_rings)
            diff = IP - P2
            d2 = jnp.sum(diff * diff, axis=2)
            d2 = jnp.where(IO & O2 & el_ok[None, :], d2, _BIG)
            cols_d.append(d2.reshape(-1))
            cols_j.append(J2.reshape(-1))
    D = jnp.stack(cols_d, axis=1)  # [C, W]
    J = jnp.stack(cols_j, axis=1)

    neg, sel = jax.lax.top_k(-D, k)  # [C, k]
    idx_c = jnp.take_along_axis(J, sel, axis=1)
    d_c = -neg

    # per-point results: each point reads its own cell's row
    out_i = idx_c[jnp.clip(cell, 0, C - 1)]
    out_d = d_c[jnp.clip(cell, 0, C - 1)]
    # self-substitution for missing/invalid slots (identity fallback keeps
    # downstream covariance math well-defined; covariance.py already treats
    # <4 valid neighbors as identity, feature/covariance.hpp:37-42)
    self_i = jnp.arange(N, dtype=jnp.int32)[:, None]
    missing = (out_i < 0) | (out_d >= _BIG) | ~ok[:, None]
    out_i = jnp.where(missing, self_i, out_i)
    out_d = jnp.where(missing, jnp.inf, out_d)
    return RangeImageKNNResult(
        knn=KNNResult(indices=out_i, distances=out_d),
        collisions=collisions,
    )
