"""LiDAR-only odometry pipeline.

Replaces ``pipeline/lidar_odometry.hpp:27-622`` of fateshelled/sycl_points:
per-frame state machine (initial-alignment handshake, preprocess,
covariances, refine, first-frame bootstrap, IMU window integration, motion
prediction, MAP-prior registration, submapping, velocity/odometry update),
per-stage wall-clock timing, and the frame ResultType codes.

ONE device->host sync per frame: the registration (align while-loop, MAP
prior, keyframe decision) and the submap update (robust-weighted sampling,
map insert, extraction, covariance finalize) run as TWO chained async
device programs — split so map-capacity growth re-jits only the small
submap program — and every scalar the host needs (pose, counts, keyframe
flag, load factor, drop/overflow telemetry, the raw Hessian for the next
frame's motion prediction) travels in a single fused stats fetch.  The
reference pays nothing comparable because its host loop shares memory with
the device (pipeline/lidar_odometry.hpp:115-298); across PCIe every
separate readback is a host<->device sync, so the sync budget is the wall
clock.
"""

from __future__ import annotations

import enum
import math
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.deskew.constant_velocity import deskew_constant_velocity
from sycl_points_tpu.imu.initial_alignment import InitialAlignmentEstimator
from sycl_points_tpu.imu.preintegration import (
    IMUMeasurement,
    IMUPreintegration,
    build_measurement_window,
)
from sycl_points_tpu.imu.velocity_corrector import IMUVelocityCorrector
from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.pipeline.fused_submap import (
    build_submap_step,
    precompile_growth_ladder,
    start_growth_precompile,
)
from sycl_points_tpu.pipeline.motion_predictor import MotionPredictor
from sycl_points_tpu.pipeline.params import LidarOdometryParams
from sycl_points_tpu.pipeline.pc_processor import PCProcessor
from sycl_points_tpu.pipeline.submap import Submap
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.map_prior import (
    MapPriorParams,
    inactive_prior,
    update as map_prior_update,
)
from sycl_points_tpu.registration.pipeline import align_pipeline
from sycl_points_tpu.utils import lie, lie_np


class ResultType(enum.Enum):
    success = "success"
    first_frame = "first_frame"
    waiting_initial_alignment = "waiting_initial_alignment"
    error = "error"
    old_timestamp = "old_timestamp"
    small_number_of_points = "small_number_of_points"


# stats vector layout (see _build_reg_step/_build_submap_step)
_S1 = 62  # T(16) + 9 scalars + H_raw(36) + error_raw(1)


class LidarOdometry:
    def __init__(self, params: LidarOdometryParams = LidarOdometryParams(),
                 map_prior_params: MapPriorParams = MapPriorParams()):
        self.params = params
        self.map_prior_params = map_prior_params
        self.pc_processor = PCProcessor(params)
        self.submap = Submap(params)
        self.motion_predictor = MotionPredictor(params.motion_prediction)
        self.pipeline_params = params.make_registration_pipeline_params()

        self._deskew_jit = jax.jit(deskew_constant_velocity)
        self._stats_cat_jit = jax.jit(lambda a, b: jnp.concatenate([a, b]))
        # compile the NEXT growth capacity's submap program in a background
        # thread so growth swaps in a ready executable (set False to disable)
        self.growth_precompile = True
        self._build_reg_step()
        self._fused_version = -1  # forces _build_submap_step on first use

        self.odom = params.pose.initial_matrix()
        self.prev_odom = self.odom.copy()
        self.linear_velocity = np.zeros(3, np.float32)
        self.angular_velocity = np.zeros(3, np.float32)
        self.dt = 0.1
        self.last_frame_time = -1.0
        self.is_first_frame = True
        self.registrated = False
        self.reg_result = None
        self.preprocessed: Optional[PointCloud] = None
        self.error_message = ""
        self.processing_times: Dict[str, float] = defaultdict(float)
        self.frame_count = 0
        self.sync_count_last_frame = 0
        # host mirrors of the previous frame's fused stats (motion predictor
        # inputs — no device readback needed)
        self._prev_Hraw_np: Optional[np.ndarray] = None
        self._prev_inlier = 0
        self._dropped_seen = 0
        self._last_load: Optional[float] = None  # growth-precompile gate

        # IMU machinery
        self.imu_buffer: deque = deque()
        self.imu_bias_gyro = np.asarray(params.imu.gyro_bias, np.float32)
        self.imu_bias_accel = np.asarray(params.imu.accel_bias, np.float32)
        self.imu_preintegration = (
            IMUPreintegration(params.imu.preintegration) if params.imu.enable else None
        )
        self.imu_velocity_corrector = IMUVelocityCorrector()
        self.imu_R_world_at_reset = np.eye(3, dtype=np.float32)
        self.imu_v_world_at_reset = np.zeros(3, np.float32)
        self.last_imu_reset_timestamp = -1.0
        self.imu_window_complete = False
        self.alignment_estimator = (
            InitialAlignmentEstimator(
                params.imu.initial_alignment,
                np.asarray(params.imu.preintegration.gravity, np.float32),
                params.imu.T_imu_to_lidar_matrix(),
            )
            if params.imu.enable and params.imu.initial_alignment.enable
            else None
        )

        self._scan_start_time_sec = 0.0
        self._scan_duration_sec = 0.0

    # -- fused per-frame programs -------------------------------------------
    def _build_reg_step(self):
        """Program A (jitted ONCE): min-points gate, MAP prior, the whole
        align pipeline, keyframe decision, and the first stats half.  The
        gate and keyframe policy mirror lidar_odometry.hpp:208/599-621 and
        submapping.hpp:99-121 but run on device so the host needs no
        intermediate readbacks."""
        p = self.params
        kfp = p.submap.keyframe
        min_pts = p.registration.min_num_points
        is_occ = self.submap.is_occupancy
        prior_enabled = self.map_prior_params.enabled

        def _reg_step(pre, submap, knn, misc,
                      prev_T, prev_Hraw, prev_err_raw, prev_inlier):
            # misc packs every per-frame host scalar into ONE [51] f32 h2d
            # payload (init_T | prev_odom | dt | registrated | last_kf_pose
            # | kf_dt_exceeded) — separate small uploads each pay a
            # dispatch.
            init_T = misc[:16].reshape(4, 4)
            prev_odom = misc[16:32].reshape(4, 4)
            dt_s = misc[32]
            registrated = misc[33] > 0.5
            last_kf_pose = misc[34:50].reshape(4, 4)
            kf_dt_exceeded = misc[50] > 0.5
            n_pre = pre.count()
            small = n_pre <= min_pts

            prior = None
            if prior_enabled:
                prior = map_prior_update(
                    self.map_prior_params, prev_T, prev_Hraw, prev_err_raw,
                    prev_inlier, init_T,
                )
                prior = prior._replace(active=prior.active & registrated)

            out = align_pipeline(
                pre, submap, knn, self.pipeline_params,
                initial_guess=init_T, prev_pose=prev_odom, dt=dt_s,
                map_prior=prior,
            )
            result = out.result
            # a too-small frame must not move the odometry
            T_eff = jnp.where(small, prev_odom, result.T)

            n_reg = out.registration_input.count()
            n_desk = out.deskewed.count()
            ratio = result.inlier.astype(jnp.float32) / jnp.maximum(
                n_reg, 1
            ).astype(jnp.float32)
            if kfp.inlier_ratio_threshold > 0.0:
                inlier_ok = ratio > kfp.inlier_ratio_threshold
            else:
                inlier_ok = jnp.bool_(True)
            if is_occ:  # occupancy backend inserts every frame
                geom_kf = jnp.bool_(True)
            else:
                delta = lie.transform_inverse(last_kf_pose) @ T_eff
                tw = lie.se3_log(delta)
                dist = jnp.linalg.norm(delta[:3, 3])
                angle_deg = jnp.linalg.norm(tw[:3]) * (180.0 / math.pi)
                geom_kf = (
                    (dist >= kfp.distance_threshold)
                    | (angle_deg >= kfp.angle_threshold_degrees)
                    | kf_dt_exceeded
                )
            is_kf = (~small) & inlier_ok & geom_kf

            f32 = lambda x: jnp.asarray(x, jnp.float32)
            stats1 = jnp.concatenate([
                T_eff.ravel(),  # 0:16
                jnp.stack([
                    f32(result.inlier), f32(n_pre), f32(n_reg), f32(n_desk),
                    f32(is_kf), f32(small), f32(result.converged),
                    f32(result.iterations), f32(result.error),
                ]),  # 16:25
                result.H_raw.ravel(),  # 25:61
                f32(result.error_raw)[None],  # 61
            ])
            return result, out.deskewed, T_eff, is_kf, stats1

        self._reg_step_jit = jax.jit(_reg_step)

    def _build_submap_step(self):
        """Program B (re-jitted after every map-capacity growth): keyframe
        submap update under ``lax.cond`` — see
        :mod:`sycl_points_tpu.pipeline.fused_submap`.  A growth event first
        checks the background-precompiled program for the new capacity
        (``start_growth_precompile``) before paying a fresh compile."""
        robust_scale = (
            self.pipeline_params.robust.min_scale
            if self.pipeline_params.robust.auto_scale
            else self.params.registration.factor.robust.default_scale
        )
        self._submap_robust_scale = robust_scale
        key = (self.submap.map_capacity, self.submap.extract_capacity)
        cached = getattr(self, "_prebuilt_submap", {}).get(key)
        if cached is not None:
            self._submap_step_jit = cached
        else:
            self.submap.compile_log.append(
                {"what": "submap_step_jit_miss", "key": key}
            )
            self._submap_step_jit = build_submap_step(
                self.params, self.submap, robust_scale
            )
        self._fused_version = self.submap.version

    def precompile_growth(self, max_capacity: int, wait: bool = True) -> int:
        """Deployment warm-start: compile every map-growth step up to
        ``max_capacity`` ahead of the stream (see
        :func:`fused_submap.precompile_growth_ladder`).  Call after the
        first processed frame."""
        return precompile_growth_ladder(self, max_capacity, wait=wait)

    # -- IMU input (lidar_odometry.hpp:85-113) -------------------------------
    def add_imu_measurement(self, meas: IMUMeasurement):
        self.imu_buffer.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while self.imu_buffer and self.imu_buffer[0].timestamp < horizon:
            self.imu_buffer.popleft()

    # -- frame processing ----------------------------------------------------
    def process(
        self,
        scan: PointCloud,
        timestamp: float,
        scan_duration_sec: float = 0.1,
    ) -> ResultType:
        self.error_message = ""
        p = self.params

        # initial alignment handshake (lidar_odometry.hpp:121-129)
        if (
            self.is_first_frame
            and self.alignment_estimator is not None
            and self.alignment_estimator.enabled()
            and not self.alignment_estimator.is_done()
        ):
            ok, R_gl, gyro_bias, diag = self.alignment_estimator.try_align(
                timestamp, list(self.imu_buffer), self.imu_bias_gyro, self.imu_bias_accel
            )
            if not ok:
                self.error_message = f"initial_alignment: {diag.error_message}"
                return ResultType.waiting_initial_alignment
            # apply: gravity-aligned rotation + gyro bias (hpp:480-494)
            user_R = self.odom[:3, :3]
            yaw = float(np.arctan2(user_R[1, 0], user_R[0, 0]))
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
            self.odom[:3, :3] = Rz @ R_gl
            self.prev_odom = self.odom.copy()
            self.imu_bias_gyro = gyro_bias

        if self.last_frame_time > 0.0:
            dt = timestamp - self.last_frame_time
            if dt > 0.0:
                self.dt = float(dt)
            else:
                self.error_message = "old timestamp"
                return ResultType.old_timestamp

        self._scan_start_time_sec = timestamp
        self._scan_duration_sec = scan_duration_sec
        self.processing_times.clear()
        self.sync_count_last_frame = 0

        # preprocess (hpp:496-502) — async dispatches, no readback
        t0 = time.perf_counter()
        cloud = scan
        if self._imu_deskew_enabled():
            # initial-velocity compensation from the CV velocity estimate:
            # without it the sweep translation (|v| * scan_duration, ~1 m at
            # highway speed) stays uncorrected and deskew only fixes rotation
            v_world = (self.odom[:3, :3] @ self.linear_velocity).astype(np.float32)
            cloud, _status = self.pc_processor.deskew_with_imu(
                cloud, list(self.imu_buffer), self.odom,
                self._scan_start_time_sec, self._scan_duration_sec,
                self.imu_bias_gyro, self.imu_bias_accel,
                v_world_body=v_world,
            )
        pre = self.pc_processor.prefilter(cloud)

        # covariances (hpp:508-522)
        ctx = None
        if self._needs_covariances():
            ctx = self.pc_processor.prepare_context(pre)
            pre = self.pc_processor.compute_covariances(pre, ctx)

        # refine filter
        if ctx is not None:
            pre = self.pc_processor.refine_filter(pre, ctx)
        self.preprocessed = pre
        self.processing_times["1. preprocessing"] += time.perf_counter() - t0

        if self.is_first_frame:
            # bootstrap (host path; the min-points gate pays its one sync here)
            if int(pre.count()) <= p.registration.min_num_points:
                self.error_message = "point cloud size is too small"
                return ResultType.small_number_of_points
            t0 = time.perf_counter()
            self.submap.add_first_frame(pre, timestamp, self.odom)
            self._dropped_seen = int(self.submap.map_state.dropped)
            self.processing_times["4. build submap"] += time.perf_counter() - t0
            self.is_first_frame = False
            self.last_frame_time = timestamp
            if self.imu_preintegration is not None:
                T_il = p.imu.T_imu_to_lidar_matrix()
                self.imu_R_world_at_reset = self.odom[:3, :3] @ T_il[:3, :3]
                self.imu_v_world_at_reset = np.zeros(3, np.float32)
                self.imu_preintegration.reset(
                    self.imu_bias_gyro, self.imu_bias_accel,
                    R_world_body=self.imu_R_world_at_reset,
                )
                self.last_imu_reset_timestamp = timestamp
            return ResultType.first_frame

        # IMU window integration (hpp:222-238)
        if self.imu_preintegration is not None:
            window = build_measurement_window(
                list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp
            )
            tol = 1e-6
            self.imu_window_complete = (
                len(window) >= 2
                and abs(window[0].timestamp - self.last_imu_reset_timestamp) <= tol
                and abs(window[-1].timestamp - timestamp) <= tol
            )
            self.imu_preintegration.integrate_batch(window)

        return self._process_fused(pre, timestamp)

    # ------------------------------------------------------------------
    def _process_fused(self, pre: PointCloud, timestamp: float) -> ResultType:
        """Registration + submapping with ONE device->host sync."""
        p = self.params

        # ---- motion prediction (host math on the previous frame's stats) ---
        t0 = time.perf_counter()
        mode = p.motion_prediction.mode.upper()
        has_imu_pred = (
            self.imu_preintegration is not None
            and self.imu_window_complete
            and self.imu_preintegration.get_dt_total() > 0.0
        )
        gyro_delta = None
        imu_pose = None
        if has_imu_pred:
            # device->host conversions on the preintegration deltas (IMU-on
            # configurations only; counted in sync_count_last_frame)
            delta_R_imu = np.asarray(
                self.imu_preintegration.get_corrected(
                    self.imu_bias_gyro, self.imu_bias_accel
                ).Delta_R
            )
            self.sync_count_last_frame += 1
            R_il = p.imu.T_imu_to_lidar_matrix()[:3, :3]
            gyro_delta = R_il @ delta_R_imu @ R_il.T
            if mode == "IMU_SE3":
                imu_pose = self._imu_motion_prediction()

        init_T = self.motion_predictor.predict(
            self.linear_velocity, self.angular_velocity, self.odom, self.dt,
            self._prev_Hraw_np, self._prev_inlier, self.registrated,
            gyro_delta, imu_pose,
        )

        v_reset = np.zeros(3, np.float32)
        if self.imu_preintegration is not None and mode == "IMU_SE3":
            v_reset = self.imu_velocity_corrector.get_reset_velocity(
                self.imu_preintegration, self.imu_bias_gyro, self.imu_bias_accel,
                self.prev_odom[:3, :3] @ self.linear_velocity,
            )

        # ---- program A: registration + keyframe decision -------------------
        if self.reg_result is not None:
            prev_T = self.reg_result.T
            prev_H = self.reg_result.H_raw
            prev_er = self.reg_result.error_raw
            prev_in = self.reg_result.inlier
        else:
            prev_T = jnp.eye(4, dtype=jnp.float32)
            prev_H = jnp.zeros((6, 6), jnp.float32)
            prev_er = jnp.float32(0.0)
            prev_in = jnp.int32(0)
        kfp = p.submap.keyframe
        kf_dt_exceeded = (
            self.submap.last_keyframe_time <= 0.0
            or (timestamp - self.submap.last_keyframe_time)
            >= kfp.time_threshold_seconds
        )
        misc = np.concatenate(
            [
                np.asarray(init_T, np.float32).ravel(),
                np.asarray(self.odom, np.float32).ravel(),
                np.asarray([self.dt, self.registrated], np.float32),
                np.asarray(self.submap.last_keyframe_pose, np.float32).ravel(),
                np.asarray([kf_dt_exceeded], np.float32),
            ]
        )
        reg_args = (
            pre, self.submap.submap_cloud, self.submap.submap_knn,
            jnp.asarray(misc), prev_T, prev_H, prev_er, prev_in,
        )
        # shape signature for the growth precompile (the registration step
        # retraces when the extract tier changes the target shape)
        self._reg_arg_structs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), reg_args
        )
        result, deskewed, T_eff, is_kf, s1 = self._reg_step_jit(*reg_args)
        self.processing_times["3. registration"] += time.perf_counter() - t0

        # ---- program B: submap update (re-jitted on growth) ----------------
        t0 = time.perf_counter()
        if self._fused_version != self.submap.version:
            self._build_submap_step()
        self.submap._key, k1 = jax.random.split(self.submap._key)
        prev_map_state = self.submap.map_state
        submap_args = (
            prev_map_state, self.submap.submap_cloud, deskewed, T_eff, is_kf, k1
        )
        new_map_state, new_submap, sampled, s2 = self._submap_step_jit(*submap_args)
        start_growth_precompile(self, self._submap_robust_scale, submap_args,
                                enabled=self.growth_precompile,
                                load=self._last_load)

        # ---- THE one fused device->host readback ---------------------------
        self.processing_times["4a. submap dispatch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = np.asarray(self._stats_cat_jit(s1, s2))
        self.sync_count_last_frame += 1
        self.processing_times["4b. stats fetch"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, n_desk, kf_flag, small_flag,
         converged, iterations, error) = stats[16:25]
        H_raw_np = stats[25:61].reshape(6, 6).astype(np.float32)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = stats[_S1:_S1 + 6]
        self._last_load = float(load)

        if small_flag > 0.5:
            self.error_message = "point cloud size is too small"
            self.processing_times["4. build submap"] += time.perf_counter() - t0
            return ResultType.small_number_of_points

        # ---- commit host state --------------------------------------------
        self.reg_result = result
        self._prev_Hraw_np = H_raw_np
        self._prev_inlier = int(n_inlier)
        self.submap.map_state = new_map_state
        self.submap.submap_cloud = new_submap
        self.submap.submap_knn = BruteForceKNN(
            points=new_submap.points, mask=new_submap.mask,
        )
        self.submap.budget_lost = int(budget_lost)
        if kf_flag > 0.5:
            # per-insert telemetry: only keyframes run extraction, so a
            # non-keyframe frame's stats2 overflow=0 must not zero it
            self.submap.extract_overflow = int(overflow)
            self.submap.last_keyframe_cloud = sampled
            # the occupancy backend inserts every frame without keyframe
            # bookkeeping (submapping.hpp:99-121 keyframes are VHM-only)
            if not self.submap.is_occupancy:
                self.submap.last_keyframe_pose = T_np.copy()
                self.submap.last_keyframe_time = timestamp
                self.submap.keyframe_poses.append(self.submap.last_keyframe_pose)

        # growth policy (rare host slow path; syncs only when it fires)
        dropped_delta = int(dropped) - self._dropped_seen
        if dropped_delta > 0:
            self.submap.map_state = prev_map_state  # retry loses nothing
            self.submap.retry_insert_after_drop(sampled, T_np)
            # the retry loop fetched fresh counters (device syncs)
            self._dropped_seen = int(self.submap.map_state.dropped)
            self.sync_count_last_frame += 3
        else:
            self._dropped_seen = int(dropped)  # from the fused stats, no sync
            if float(load) > 0.7:
                self.submap._grow_map(origin=T_np)
        # extract-overflow backstop: the in-range voxel set outgrew the
        # extraction budget without a map growth — grow the tier and
        # re-extract so the target is never silently truncated (counter
        # travels in the fused stats; slow path syncs only when it fires)
        if self.submap.extract_overflow > 0:
            if self.submap.resolve_extract_overflow(T_np):
                self.sync_count_last_frame += 2
        self.processing_times["4. build submap"] += time.perf_counter() - t0

        # full-resolution CV deskew for publishing (hpp:272-277)
        if (
            self.pipeline_params.velocity_update.enable
            and not self._imu_deskew_enabled()
            and self.preprocessed.timestamp_offsets is not None
        ):
            self.preprocessed = self._deskew_jit(
                self.preprocessed,
                jnp.asarray(self.odom), jnp.asarray(T_np), jnp.float32(self.dt),
            )

        # velocity/odometry update (hpp:280-296)
        self.prev_odom = self.odom.copy()
        self.odom = T_np.copy()
        self.last_frame_time = timestamp
        delta = np.linalg.inv(self.prev_odom) @ self.odom
        tw = lie_np.se3_log(delta)
        self.linear_velocity = (delta[:3, 3] / self.dt).astype(np.float32)
        self.angular_velocity = (tw[:3] / self.dt).astype(np.float32)

        if self.imu_preintegration is not None:
            T_il = p.imu.T_imu_to_lidar_matrix()
            self.imu_R_world_at_reset = T_np[:3, :3] @ T_il[:3, :3]
            self.imu_v_world_at_reset = v_reset
            self.imu_preintegration.reset(
                self.imu_bias_gyro, self.imu_bias_accel,
                R_world_body=self.imu_R_world_at_reset,
            )
            self.last_imu_reset_timestamp = timestamp
            if mode == "IMU_SE3":
                R_world_imu_prev = self.prev_odom[:3, :3] @ T_il[:3, :3]
                self.imu_velocity_corrector.update(
                    self.odom[:3, 3] - self.prev_odom[:3, 3],
                    R_world_imu_prev,
                    np.asarray(p.imu.preintegration.gravity, np.float32),
                )

        self.registrated = True
        self.frame_count += 1
        return ResultType.success

    # ------------------------------------------------------------------
    def _imu_deskew_enabled(self) -> bool:
        return self.params.imu.enable and self.params.imu.deskew.enable

    def _needs_covariances(self) -> bool:
        from sycl_points_tpu.registration.factors import RegType

        p = self.params
        return (
            p.registration.factor.reg_type is RegType.GICP
            or p.registration.factor.rotation_constraint.enable
            or p.scan.preprocess.angle_incidence_filter.enable
            or p.scan.intensity_gaussian.enable
            or p.scan.intensity_local_mean_norm.enable
        )

    def _imu_motion_prediction(self) -> np.ndarray:
        """hpp:525-542: absolute pose prediction from preintegration."""
        T_imu_rel = np.asarray(
            self.imu_preintegration.predict_relative_transform(
                self.imu_R_world_at_reset, self.imu_v_world_at_reset,
                self.imu_bias_gyro, self.imu_bias_accel,
            )
        )
        T_il = self.params.imu.T_imu_to_lidar_matrix()
        T_lidar_rel = T_il @ T_imu_rel @ np.linalg.inv(T_il)
        return (self.odom @ T_lidar_rel).astype(np.float32)

    # -- accessors -----------------------------------------------------------
    def get_odometry(self) -> np.ndarray:
        return self.odom.copy()

    def get_keyframe_poses(self):
        return list(self.submap.keyframe_poses)

    def get_processing_times(self) -> Dict[str, float]:
        return dict(self.processing_times)
