"""Intensity processing ops: correction, directional Gaussian smoothing,
local-mean normalization, z-score.

Replaces the ``algorithms/filter/intensity_*.hpp`` family of
fateshelled/sycl_points; each op is a batched gather + fused elementwise pass over
the KNN neighborhoods:

  * correction (intensity_correction.hpp:18-38):
    I' = clamp(scale * I * (dist/ref)^exponent * |cos|^-angle_exp, min, max)
  * directional Gaussian smoothing (intensity_gaussian.hpp:15-90): Gaussian
    in a per-point sensor-local (range, azimuth, elevation) frame with the
    near-zenith fallback basis
  * local-mean normalization (intensity_local_mean_norm.hpp): divide by the
    directional-Gaussian local mean (edge-preserving)
  * z-score (intensity_zscore.hpp:13-...): per-point z vs the plain KNN
    neighborhood with a sigma floor
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult
from sycl_points_tpu.points.point_cloud import PointCloud


def correct_intensity(
    cloud: PointCloud,
    exponent: float = 2.0,
    scale: float = 1.0,
    min_intensity: float = 0.0,
    max_intensity: float = 1000.0,
    ref_distance: float = 1.0,
    angle_exponent: float = 0.0,
) -> PointCloud:
    """Distance + incidence-angle intensity compensation (in the cloud's
    sensor frame)."""
    if cloud.intensities is None:
        raise ValueError("intensity field not found")
    if exponent < 0.0:
        raise ValueError("exponent must be non-negative")
    if ref_distance <= 0.0:
        raise ValueError("ref_distance must be positive")

    pts = cloud.points
    dist = jnp.linalg.norm(pts, axis=-1)
    dist_factor = jnp.power(dist / ref_distance, exponent)

    angle_factor = jnp.ones_like(dist)
    if angle_exponent != 0.0 and cloud.normals is not None:
        dot = jnp.sum(pts * cloud.normals, axis=-1)
        denom = dist * jnp.linalg.norm(cloud.normals, axis=-1)
        abs_cos = jnp.abs(dot / jnp.maximum(denom, 1e-30))
        af = jnp.power(jnp.maximum(abs_cos, 1e-3), -angle_exponent)
        angle_factor = jnp.where(denom > 1e-6, af, 1.0)

    out = jnp.clip(
        cloud.intensities * dist_factor * angle_factor * scale,
        min_intensity,
        max_intensity,
    )
    return cloud.replace(intensities=out)


def _directional_gaussian_mean(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float,
    k_limit: int = 0,
) -> jax.Array:
    """Gaussian-weighted local intensity mean in the per-point sensor-local
    (range, azimuth, elevation) basis (intensity_gaussian.hpp:36-90)."""
    if sigma_azimuth <= 0 or sigma_elevation <= 0 or sigma_range <= 0:
        raise ValueError("all sigma values must be positive")
    pts, inten = cloud.points, cloud.intensities
    k_stride = knn.indices.shape[1]
    k_use = k_limit if (0 < k_limit < k_stride) else k_stride
    idx = jnp.maximum(knn.indices[:, :k_use], 0)

    r = jnp.linalg.norm(pts, axis=-1)
    ok_r = r >= 1e-6
    r_safe = jnp.maximum(r, 1e-6)
    r_hat = pts / r_safe[:, None]

    rxy = jnp.linalg.norm(pts[:, :2], axis=-1)
    near_zenith = rxy < 1e-6
    inv_rxy = 1.0 / jnp.maximum(rxy, 1e-6)
    ax = jnp.where(near_zenith, 1.0, -pts[:, 1] * inv_rxy)
    ay = jnp.where(near_zenith, 0.0, pts[:, 0] * inv_rxy)
    ex = jnp.where(near_zenith, 0.0, -r_hat[:, 2] * ay)
    ey = jnp.where(near_zenith, 1.0, r_hat[:, 2] * ax)
    ez = jnp.where(near_zenith, 0.0, rxy / r_safe)

    dp = pts[idx] - pts[:, None, :]  # [N, k, 3]
    dp_r = jnp.sum(dp * r_hat[:, None, :], axis=-1)
    dp_az = dp[..., 0] * ax[:, None] + dp[..., 1] * ay[:, None]
    dp_el = dp[..., 0] * ex[:, None] + dp[..., 1] * ey[:, None] + dp[..., 2] * ez[:, None]

    inv2_az = 0.5 / (sigma_azimuth * sigma_azimuth)
    inv2_el = 0.5 / (sigma_elevation * sigma_elevation)
    inv2_r = 0.5 / (sigma_range * sigma_range)
    w = jnp.exp(-(dp_r**2 * inv2_r + dp_az**2 * inv2_az + dp_el**2 * inv2_el))
    valid = (knn.indices[:, :k_use] >= 0) & jnp.isfinite(knn.distances[:, :k_use])
    w = jnp.where(valid, w, 0.0)

    sum_w = jnp.sum(w, axis=1)
    sum_wI = jnp.sum(w * inten[idx], axis=1)
    mean = jnp.where(sum_w > 0.0, sum_wI / jnp.maximum(sum_w, 1e-30), inten)
    return jnp.where(ok_r, mean, inten)


def smooth_intensity(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float = 0.05,
    k_limit: int = 0,
) -> PointCloud:
    """Directional anisotropic Gaussian smoothing
    (intensity_gaussian::smooth_intensity)."""
    if cloud.intensities is None:
        raise ValueError("intensity field not found")
    out = _directional_gaussian_mean(
        cloud, knn, sigma_azimuth, sigma_elevation, sigma_range, k_limit
    )
    return cloud.replace(intensities=out)


def local_mean_normalize(
    cloud: PointCloud,
    knn: KNNResult,
    sigma_azimuth: float,
    sigma_elevation: float,
    sigma_range: float = 0.05,
    mean_min: float = 1e-3,
    k_limit: int = 0,
) -> PointCloud:
    """Divide by the directional-Gaussian local mean
    (intensity_local_mean_norm::normalize)."""
    if cloud.intensities is None:
        raise ValueError("intensity field not found")
    if mean_min <= 0.0:
        raise ValueError("mean_min must be positive")
    mean = _directional_gaussian_mean(
        cloud, knn, sigma_azimuth, sigma_elevation, sigma_range, k_limit
    )
    return cloud.replace(intensities=cloud.intensities / jnp.maximum(mean, mean_min))


def intensity_zscore(
    cloud: PointCloud, knn: KNNResult, sigma_min: float = 0.01
) -> PointCloud:
    """Per-point z-score vs the KNN neighborhood (intensity_zscore::compute);
    0 below the sigma floor."""
    if cloud.intensities is None:
        raise ValueError("intensity field not found")
    k = knn.indices.shape[1]
    if k < 3:
        raise ValueError("neighbors.k must be >= 3")
    idx = jnp.maximum(knn.indices, 0)
    nI = cloud.intensities[idx]  # [N, k]
    mean = jnp.mean(nI, axis=1)
    var = jnp.maximum(jnp.mean(nI * nI, axis=1) - mean * mean, 0.0)
    sigma = jnp.sqrt(var)
    z = (cloud.intensities - mean) / jnp.maximum(sigma, 1e-30)
    return cloud.replace(intensities=jnp.where(sigma < sigma_min, 0.0, z))
