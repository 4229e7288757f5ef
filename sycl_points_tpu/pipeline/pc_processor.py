"""Scan preprocessing orchestration (PCProcessor).

Replaces ``pipeline/pointcloud_processing.hpp:25-204`` of
fateshelled/sycl_points: optional IMU deskew -> prefilter chain (box ->
polar grid -> voxel grid -> random sampling) -> KNN context ->
covariance estimation (robust or plain) -> refine filter (angle incidence,
intensity correction / Gaussian smoothing / local-mean normalization with
KNN-result reuse).

Design: every stage is jitted and shape-static; the prefilter chain
compacts to a fixed capacity tier once, and the random sampler fixes the
final capacity.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.deskew.imu_deskew import deskew_point_cloud_imu
from sycl_points_tpu.ops import intensity as intensity_ops
from sycl_points_tpu.ops.covariance import estimate_covariances, estimate_covariances_robust
from sycl_points_tpu.ops.filters import angle_incidence_filter, box_filter
from sycl_points_tpu.ops.knn import BruteForceKNN, KNNResult, approx_knn, brute_force_knn
from sycl_points_tpu.ops.polar import CoordinateSystem, polar_downsample
from sycl_points_tpu.ops.sampling import random_sampling
from sycl_points_tpu.ops.voxel import voxel_downsample
from sycl_points_tpu.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu.pipeline.params import CommonParameters


class ProcessingContext(NamedTuple):
    """KNN context reused across covariance + intensity stages
    (pointcloud_processing.hpp:25-28)."""

    knn: KNNResult


class PCProcessor:
    def __init__(self, params: CommonParameters):
        self.params = params
        self._key = jax.random.key(1234)
        self._prefilter_jit = jax.jit(self._prefilter_fn)
        self._covariances_jit = jax.jit(self._covariances_fn)
        self._refine_jit = jax.jit(self._refine_fn)
        # cached ONCE: a fresh jax.jit object per call would retrace and
        # recompile every frame (~15 s/frame on this toolchain).
        self._knn_jit = jax.jit(
            partial(approx_knn, k=self.params.covariance_estimation.neighbor_num)
        )

    # -- prefilter ----------------------------------------------------------
    def _prefilter_fn(self, cloud: PointCloud, key) -> PointCloud:
        p = self.params.scan
        ce = self.params.covariance_estimation
        c = cloud
        if p.preprocess.box_filter.enable:
            c = box_filter(c, p.preprocess.box_filter.min, p.preprocess.box_filter.max)
        if ce.raw_range_image:
            # raw-features: covariances from the O(N) range-image
            # neighborhoods BEFORE downsampling; the voxel stage aggregates
            # them (ops/voxel.py) and compute_covariances becomes a no-op
            from sycl_points_tpu.ops.range_image_knn import range_image_knn

            rr = range_image_knn(
                c.points, c.mask, ce.neighbor_num,
                n_az=ce.range_image_n_az, n_rings=ce.range_image_n_rings,
                window_az=ce.range_image_window_az,
                window_el=ce.range_image_window_el,
            )
            me = ce.m_estimation
            if me.enable:
                covs = estimate_covariances_robust(
                    c.points, rr.knn, me.type, me.mad_scale,
                    me.min_robust_scale, me.max_iterations,
                )
            else:
                covs = estimate_covariances(c.points, rr.knn)
            c = c.replace(covs=covs)
        cap = min(self.params.scan_capacity, c.capacity)
        if p.downsampling.polar.enable:
            # The last grid stage emits bins densely from slot 0, so it can
            # write straight into the scan capacity — no compaction pass.
            polar_cap = cap if not p.downsampling.voxel.enable else None
            c = polar_downsample(
                c,
                p.downsampling.polar.distance_size,
                p.downsampling.polar.elevation_size,
                p.downsampling.polar.azimuth_size,
                CoordinateSystem.from_string(p.downsampling.polar.coord_system),
                out_capacity=polar_cap,
            )
        if p.downsampling.voxel.enable:
            c = voxel_downsample(c, p.downsampling.voxel.size, out_capacity=cap)
        elif not p.downsampling.polar.enable:
            c = compact_device(c, out_capacity=cap)
        if p.downsampling.random.enable and p.downsampling.random.num < c.capacity:
            c = random_sampling(c, p.downsampling.random.num, key)
        return c

    def prefilter(self, cloud: PointCloud) -> PointCloud:
        self._key, sub = jax.random.split(self._key)
        return self._prefilter_jit(cloud, sub)

    # -- covariance context --------------------------------------------------
    def prepare_context(self, cloud: PointCloud) -> ProcessingContext:
        # Covariance neighborhoods use approx_knn (exact on CPU and GPU).  The
        # raw-features path carries covariances from the raw scan; its KNN
        # context is only needed for the intensity refine ops.
        if cloud.covs is not None and not self._refine_needs_knn():
            return ProcessingContext(knn=None)
        knn = self._knn_jit(cloud.points, cloud.mask, cloud.points)
        return ProcessingContext(knn=knn)

    def _refine_needs_knn(self) -> bool:
        p = self.params.scan
        return bool(
            p.intensity_gaussian.enable or p.intensity_local_mean_norm.enable
        )

    def _covariances_fn(self, cloud: PointCloud, knn: KNNResult) -> PointCloud:
        me = self.params.covariance_estimation.m_estimation
        if me.enable:
            covs = estimate_covariances_robust(
                cloud.points, knn, me.type, me.mad_scale, me.min_robust_scale, me.max_iterations
            )
        else:
            covs = estimate_covariances(cloud.points, knn)
        return cloud.replace(covs=covs)

    def compute_covariances(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        if cloud.covs is not None:
            return cloud  # raw-features path: already estimated + aggregated
        return self._covariances_jit(cloud, ctx.knn)

    # -- refine filter -------------------------------------------------------
    def _refine_fn(self, cloud: PointCloud, knn: KNNResult) -> PointCloud:
        p = self.params.scan
        c = cloud
        if p.preprocess.angle_incidence_filter.enable and (
            c.normals is not None or c.covs is not None
        ):
            c = angle_incidence_filter(
                c, p.preprocess.angle_incidence_filter.min_angle,
                p.preprocess.angle_incidence_filter.max_angle,
            )
        has_intensity = c.intensities is not None
        if p.intensity_correction.enable and not p.enhanced_reflectivity.enable and has_intensity:
            ic = p.intensity_correction
            c = intensity_ops.correct_intensity(
                c, ic.exp, ic.scale, ic.min_intensity, ic.max_intensity,
                ic.ref_distance, ic.angle_exponent,
            )
        if p.intensity_gaussian.enable and has_intensity:
            g = p.intensity_gaussian
            c = intensity_ops.smooth_intensity(
                c, knn, g.sigma_azimuth, g.sigma_elevation, g.sigma_range,
                k_limit=min(g.neighbor_num, knn.indices.shape[1]),
            )
        if p.intensity_local_mean_norm.enable and has_intensity:
            l = p.intensity_local_mean_norm
            c = intensity_ops.local_mean_normalize(
                c, knn, l.sigma_azimuth, l.sigma_elevation, l.sigma_range, l.mean_min,
                k_limit=min(l.neighbor_num, knn.indices.shape[1]),
            )
        return c

    def refine_filter(self, cloud: PointCloud, ctx: ProcessingContext) -> PointCloud:
        return self._refine_jit(cloud, ctx.knn)

    # -- IMU deskew ----------------------------------------------------------
    def deskew_with_imu(
        self,
        cloud: PointCloud,
        imu_buffer,
        current_pose: np.ndarray,
        scan_start_time_sec: float,
        scan_duration_sec: float,
        gyro_bias=None,
        accel_bias=None,
        v_world_body=None,
        R_world_imu=None,
    ):
        """pointcloud_processing.hpp:42-53.

        ``R_world_imu`` overrides the pose-derived IMU rotation — pipelines
        pass the rotation PROPAGATED to scan start (``current_pose`` is one
        frame stale by construction)."""
        imu_p = self.params.imu
        T_il = imu_p.T_imu_to_lidar_matrix()
        if R_world_imu is None:
            R_world_imu = np.asarray(current_pose)[:3, :3] @ T_il[:3, :3]
        return deskew_point_cloud_imu(
            cloud, imu_buffer, scan_start_time_sec, scan_duration_sec, T_il,
            np.asarray(imu_p.gyro_bias, np.float32) if gyro_bias is None else gyro_bias,
            np.asarray(imu_p.accel_bias, np.float32) if accel_bias is None else accel_bias,
            imu_p.preintegration, R_world_imu,
            np.zeros(3, np.float32) if v_world_body is None else v_world_body,
            gyro_only=imu_p.deskew.gyro_only,
        )
