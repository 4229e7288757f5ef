"""Per-point covariance and normal estimation from KNN neighborhoods.

Replaces ``algorithms/feature/covariance.hpp`` of fateshelled/sycl_points.
All estimators are batched gathers + einsum moment accumulation
over the whole cloud instead of per-work-item loops:

  * plain estimator (covariance.hpp:16-47): neighborhood second moment with
    identity fallback below ``min_num_correspondences`` (>= 4);
  * robust M-estimated covariance (covariance.hpp:182-250): IRLS with
    squared-Mahalanobis residuals, per-point median * mad_scale as the
    robust scale (floored), fixed iteration count (statically unrolled);
  * normal extraction (covariance.hpp:49-65): smallest eigenvector, sign
    flipped toward the sensor;
  * plane regularization / covariance normalization re-exported from
    :mod:`sycl_points_tpu.utils.eigh3`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult
from sycl_points_tpu.ops.robust import RobustLossType, compute_weight
from sycl_points_tpu.utils import eigh3
from sycl_points_tpu.utils.eigh3 import normalize_covariance, plane_regularize  # noqa: F401 (re-export)


def _neighbor_validity(knn: KNNResult) -> jax.Array:
    return (knn.indices >= 0) & jnp.isfinite(knn.distances)


def _weighted_moments(
    points: jax.Array, knn: KNNResult, weights: jax.Array, min_num: int
):
    """Weighted mean/covariance over gathered neighborhoods.

    Returns (cov [N,3,3], mean [N,3], success [N]).  Mirrors
    ``kernel::estimate_weighted`` (covariance.hpp:97-134): identity fallback
    when fewer than ``max(min_num, 4)`` valid neighbors or zero total weight.
    """
    valid = _neighbor_validity(knn)
    w = jnp.where(valid, weights, 0.0)
    idx = jnp.maximum(knn.indices, 0)
    nbr = points[idx]  # [N, k, 3]

    total_w = jnp.sum(w, axis=1)
    count = jnp.sum(valid, axis=1)
    total_w_safe = jnp.maximum(total_w, 1e-30)
    # Broadcast-multiply-sum moment accumulation: exact f32 in one fused
    # elementwise pass (a dot_general over the tiny k axis would depend on
    # the matmul precision setting).  CENTERED two-pass form: the
    # E[xx^T] - mu mu^T identity cancels catastrophically in f32 at LiDAR
    # coordinate magnitudes (~30 m -> products ~900 vs covariances ~1e-4),
    # yielding indefinite matrices with eigenvalues down to -3e-4; centering
    # first keeps the result PSD to f32 roundoff.
    mean = jnp.sum(w[:, :, None] * nbr, axis=1) / total_w_safe[:, None]
    diff = nbr - mean[:, None, :]
    second_c = (
        jnp.sum(w[:, :, None, None] * diff[:, :, :, None] * diff[:, :, None, :], axis=1)
        / total_w_safe[:, None, None]
    )
    cov = eigh3.ensure_symmetric(second_c)

    success = (count >= max(min_num, 4)) & (total_w > jnp.finfo(jnp.float32).eps)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=points.dtype), cov.shape)
    return jnp.where(success[:, None, None], cov, eye), mean, success


def estimate_covariances(
    points: jax.Array, knn: KNNResult, min_num: int = 4
) -> jax.Array:
    """Plain neighborhood covariance (kernel::estimate, covariance.hpp:16-47)."""
    cov, _, _ = _weighted_moments(points, knn, jnp.ones_like(knn.distances), min_num)
    return cov


def estimate_covariances_robust(
    points: jax.Array,
    knn: KNNResult,
    loss: RobustLossType = RobustLossType.CAUCHY,
    mad_scale: float = 1.4826,
    min_robust_scale: float = 1e-4,
    max_iterations: int = 3,
    min_num: int = 4,
) -> jax.Array:
    """IRLS robust covariance (kernel::estimate_robust, covariance.hpp:182-250).

    The robust weight argument is the *squared* Mahalanobis distance (as in
    the reference); the per-point scale is ``mad_scale * median(d^2)``
    floored at ``min_robust_scale``.  Invalid neighbor slots contribute 0 to
    the median, matching the zero-initialized device buffer semantics.
    """
    if loss is RobustLossType.NONE:
        return estimate_covariances(points, knn, min_num)

    valid = _neighbor_validity(knn)
    idx = jnp.maximum(knn.indices, 0)
    nbr = points[idx]
    k = knn.indices.shape[1]

    weights = jnp.ones_like(knn.distances)
    cov, mean, success0 = _weighted_moments(points, knn, weights, min_num)
    keep_running = success0

    for _ in range(max_iterations):
        cov_inv = eigh3.inv3(cov)
        diff = nbr - mean[:, None, :]
        u = jnp.sum(cov_inv[:, None, :, :] * diff[:, :, None, :], axis=-1)  # [N,k,3]
        d2 = jnp.sum(diff * u, axis=-1)
        d2 = jnp.where(valid, d2, 0.0)
        med = jnp.median(d2, axis=1)
        scale = jnp.maximum(mad_scale * med, min_robust_scale)
        weights = compute_weight(loss, d2, scale[:, None])
        new_cov, new_mean, ok = _weighted_moments(points, knn, weights, min_num)
        # A failed re-estimate freezes the previous value (reference `break`).
        upd = keep_running & ok
        cov = jnp.where(upd[:, None, None], new_cov, cov)
        mean = jnp.where(upd[:, None], new_mean, mean)
        keep_running = upd

    eye = jnp.broadcast_to(jnp.eye(3, dtype=points.dtype), cov.shape)
    return jnp.where(success0[:, None, None], cov, eye)


def extract_normals(points: jax.Array, covs: jax.Array) -> jax.Array:
    """Normal = smallest-eigenvalue eigenvector, sign flipped toward the
    sensor (kernel::extract_normal, covariance.hpp:49-65: keep when
    dot(n, p) <= 1, else negate)."""
    n = eigh3.smallest_eigenvector3(covs)
    flip = jnp.sum(n * points, axis=-1) > 1.0
    return jnp.where(flip[..., None], -n, n)
