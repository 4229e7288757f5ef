"""Mask-based point filters (box, angle-incidence, outlier removal).

Replaces the flag-and-compact filter operators of fateshelled/sycl_points
(``algorithms/filter/preprocess_operator/*`` and
``algorithms/filter/outlier_removal_filter.hpp``).  Design: filters
*mask* points (no data movement); compaction happens only when a smaller
static capacity is wanted (:func:`sycl_points_tpu.points.point_cloud.compact_device`).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils.eigh3 import smallest_eigenvector3


def box_filter(cloud: PointCloud, min_distance: float, max_distance: float) -> PointCloud:
    """Keep points whose Chebyshev (L-inf) distance lies in [min, max] and are
    finite (kernel::box_filter, preprocess_operator/common.hpp:19-26)."""
    finite = jnp.all(jnp.isfinite(cloud.points), axis=-1)
    linf = jnp.max(jnp.abs(cloud.points), axis=-1)
    keep = finite & (linf >= min_distance) & (linf <= max_distance)
    return cloud.replace(mask=cloud.mask & keep)


def angle_incidence_filter(
    cloud: PointCloud, min_angle: float, max_angle: float
) -> PointCloud:
    """Remove points whose |cos| of the (ray, normal) angle is outside
    [cos(max_angle), cos(min_angle)] (angle_incidence_filter_operator.hpp:17-...).

    Normals come from the ``normals`` field, else extracted from the
    covariances on the fly.
    """
    if cloud.normals is None and cloud.covs is None:
        raise ValueError("angle incidence filter requires normals or covariances")
    if min_angle < 0.0 or max_angle > math.pi * 0.5 or min_angle >= max_angle:
        raise ValueError("invalid angle range")
    normals = (
        cloud.normals if cloud.normals is not None else smallest_eigenvector3(cloud.covs)
    )
    max_cos = math.cos(min_angle)
    min_cos = math.cos(max_angle)

    finite = jnp.all(jnp.isfinite(cloud.points), axis=-1)
    dot = jnp.sum(cloud.points * normals, axis=-1)
    denom = jnp.linalg.norm(cloud.points, axis=-1) * jnp.linalg.norm(normals, axis=-1)
    ok_denom = denom > 1e-6
    abs_cos = jnp.abs(dot / jnp.maximum(denom, 1e-30))
    keep = finite & ok_denom & (abs_cos >= min_cos) & (abs_cos <= max_cos)
    return cloud.replace(mask=cloud.mask & keep)


def statistical_outlier_removal(
    cloud: PointCloud, knn: KNNResult, stddev_mul_thresh: float = 1.0
) -> PointCloud:
    """Statistical outlier removal (OutlierRemoval::statistical,
    outlier_removal_filter.hpp:38-145).

    Matches the reference exactly, including operating on *squared* neighbor
    distances: per-point mean of k squared distances, global mean/stddev over
    all points, remove where mean_i > mean + mult * stddev.  ``knn`` is a
    self-search result on ``cloud``.
    """
    d = jnp.where(jnp.isfinite(knn.distances), knn.distances, 0.0)
    k = knn.distances.shape[1]
    local_mean = jnp.sum(d, axis=1) / k
    m = cloud.mask.astype(local_mean.dtype)
    n = jnp.maximum(jnp.sum(m), 1.0)
    # Reference divides by N (all points); padded slots contribute 0 here, so
    # normalize by the valid count instead (identical when unpadded).
    g_mean = jnp.sum(local_mean * m) / n
    g_var = jnp.sum(((g_mean - local_mean) ** 2) * m) / n
    thresh = g_mean + stddev_mul_thresh * jnp.sqrt(g_var)
    keep = local_mean <= thresh
    return cloud.replace(mask=cloud.mask & keep)


def radius_outlier_removal(
    cloud: PointCloud, knn: KNNResult, radius: float, min_neighbors: int
) -> PointCloud:
    """Radius outlier removal (OutlierRemoval::radius,
    outlier_removal_filter.hpp:155-199): keep points with at least
    ``min_neighbors`` neighbors within ``radius`` (self excluded).  ``knn``
    must have k > min_neighbors."""
    within = (knn.distances <= radius * radius) & jnp.isfinite(knn.distances)
    count = jnp.sum(within, axis=1) - 1  # exclude the self-match
    keep = count >= min_neighbors
    return cloud.replace(mask=cloud.mask & keep)
