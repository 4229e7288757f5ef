"""Tightly-coupled LiDAR-inertial odometry pipeline (15-DOF IEKF-style).

Replaces ``pipeline/lidar_inertial_odometry.hpp:55-712`` and its params
(``lidar_inertial_odometry_params.hpp:15-59``) of fateshelled/sycl_points:
per-frame flow preprocess -> covariances -> refine -> IMU window
integration -> (IMU-only fallback for tiny clouds) -> 15-DOF LIO
registration -> bias clamps -> preintegration reset with P_post sigma
floors -> submapping.

ONE device->host sync per frame (same architecture as
:mod:`.lidar_odometry`): the whole inertial chain — preintegration of the
padded IMU window, state/covariance prediction with the reset sigma
floors, the 15-DOF align, bias clamps, the IMU-only fallback for
too-small clouds, and the keyframe decision — runs as one jitted program
(re-compiled per power-of-two IMU window bucket), chained with the shared
fused submap update; every host-needed scalar rides a single stats fetch.
The filter state (State, P_post) lives on device end-to-end.
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

from sycl_points_tpu.imu.factor import IDX_ROT, IDX_VEL, State
from sycl_points_tpu.imu.initial_alignment import InitialAlignmentEstimator
from sycl_points_tpu.imu.preintegration import (
    IMUMeasurement,
    build_measurement_window,
    init_state,
    integrate_steps,
    pack_steps,
    padded_steps_from_window,
    predict_relative_transform,
    unpack_steps,
)
from sycl_points_tpu.lio import lio_registration as lio
from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.ops.sampling import random_sampling
from sycl_points_tpu.pipeline.fused_submap import (
    build_submap_step,
    precompile_growth_ladder,
    start_growth_precompile,
)
from sycl_points_tpu.pipeline.params import LidarInertialOdometryParams
from sycl_points_tpu.pipeline.pc_processor import PCProcessor
from sycl_points_tpu.pipeline.submap import Submap
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils import lie


class ResultType(enum.Enum):
    success = "success"
    first_frame = "first_frame"
    waiting_initial_alignment = "waiting_initial_alignment"
    error = "error"
    old_timestamp = "old_timestamp"
    small_number_of_points = "small_number_of_points"
    imu_only = "imu_only"


# stats1 layout: T(16) + [inlier, n_pre, n_reg, is_kf, small, finite_ok,
# iterations, error, dt_total](9) + gyro_bias(3) + accel_bias(3) + vel(3)
_S1 = 34


class LidarInertialOdometry:
    def __init__(
        self,
        params: LidarInertialOdometryParams = LidarInertialOdometryParams(),
        collect_trace: bool = False,
    ):
        """``collect_trace=True`` (debug/observability mode) makes every frame
        also fetch the 15-DOF solver's per-iteration trace
        (:data:`lio_registration.TRACE_COLS`) plus the predicted-vs-registered
        innovation into :attr:`last_trace` — the verbose-mode equivalent of
        the reference (lio_registration.hpp per-iteration prints).  Costs one
        extra device fetch per frame; off in production."""
        self.params = params
        self.collect_trace = collect_trace
        self.last_trace: Optional[dict] = None
        self.pc_processor = PCProcessor(params)
        self.submap = Submap(params)
        self._stats_cat_jit = jax.jit(lambda a, b: jnp.concatenate([a, b]))
        self.growth_precompile = True
        self._build_lio_step()
        self._fused_version = -1

        self.x = State(
            position=jnp.asarray(params.pose.initial_matrix()[:3, 3]),
            rotation=jnp.asarray(params.pose.initial_matrix()[:3, :3]),
            velocity=jnp.zeros(3),
            accel_bias=jnp.asarray(params.imu.accel_bias, dtype=jnp.float32),
            gyro_bias=jnp.asarray(params.imu.gyro_bias, dtype=jnp.float32),
        )
        # initial bias uncertainty (see params.initial_*_bias_sigma): the
        # reference's zero-initialized P_post_ leaves bias unobservable in
        # practice; this prior makes the bias states correctable
        P0 = np.zeros((15, 15), np.float32)
        from sycl_points_tpu.imu.factor import IDX_ACC_BIAS, IDX_GYR_BIAS
        P0[IDX_ACC_BIAS:IDX_ACC_BIAS + 3, IDX_ACC_BIAS:IDX_ACC_BIAS + 3] = (
            params.initial_accel_bias_sigma**2 * np.eye(3)
        )
        P0[IDX_GYR_BIAS:IDX_GYR_BIAS + 3, IDX_GYR_BIAS:IDX_GYR_BIAS + 3] = (
            params.initial_gyro_bias_sigma**2 * np.eye(3)
        )
        self.P_post = jnp.asarray(P0)
        self.odom = params.pose.initial_matrix()
        self.prev_odom = self.odom.copy()
        self.dt = 0.1
        self.last_frame_time = -1.0
        self.last_imu_reset_timestamp = -1.0
        self.is_first_frame = True
        self.reg_result = None
        self.preprocessed: Optional[PointCloud] = None
        self.error_message = ""
        self.processing_times: Dict[str, float] = defaultdict(float)
        self.sync_count_last_frame = 0
        self._key = jax.random.key(99)
        self._dropped_seen = 0
        self._last_load: float | None = None  # growth-precompile gate
        # host mirrors of the device filter state (refreshed by the fused
        # stats fetch; used by the host-side deskew path)
        self.gyro_bias_np = np.asarray(params.imu.gyro_bias, np.float32)
        self.accel_bias_np = np.asarray(params.imu.accel_bias, np.float32)
        self.velocity_np = np.zeros(3, np.float32)

        self.imu_buffer: deque = deque()
        self.imu_R_world_at_reset = np.eye(3, dtype=np.float32)
        self.imu_v_world_at_reset = np.zeros(3, np.float32)
        self.alignment_estimator = (
            InitialAlignmentEstimator(
                params.imu.initial_alignment,
                np.asarray(params.imu.preintegration.gravity, np.float32),
                params.imu.T_imu_to_lidar_matrix(),
            )
            if params.imu.initial_alignment.enable
            else None
        )

    # ------------------------------------------------------------------
    def _build_lio_step(self):
        """The fused inertial frame program (jitted once per IMU window
        bucket): preintegration -> prediction (reset sigma floors folded in,
        lidar_inertial_odometry.hpp:402-459) -> 15-DOF align (:513-537) ->
        bias clamps -> IMU-only fallback select (:472-509) -> keyframe
        decision -> stats."""
        p = self.params
        pp = p.imu.preintegration
        kfp = p.submap.keyframe
        min_pts = p.registration.min_num_points
        is_occ = self.submap.is_occupancy
        T_il_np = p.imu.T_imu_to_lidar_matrix()
        sampling = p.registration_sampling

        def _lio_step(pre, submap, knn, x, P_post, imu_pack, misc, key):
            # ONE h2d payload per frame for the IMU window (imu_pack
            # [S,14], see preintegration.pack_steps) and one [18] misc
            # vector (last keyframe pose + host-side flags) — six separate
            # per-frame uploads would each pay a dispatch.
            dt_s, w0, w1, a0, a1, valid = unpack_steps(imu_pack)
            last_kf_pose = misc[:16].reshape(4, 4)
            update_bias = misc[16] > 0.5
            kf_dt_exceeded = misc[17] > 0.5
            T_il = jnp.asarray(T_il_np)
            R_il = T_il[:3, :3]
            g = jnp.asarray(pp.gravity, jnp.float32)

            # ---- preintegration with the reset covariance floors ----------
            P = P_post
            P = P.at[IDX_VEL:IDX_VEL + 3, IDX_VEL:IDX_VEL + 3].add(
                p.fd_velocity_sigma**2 * jnp.eye(3)
            )
            P = P.at[IDX_ROT:IDX_ROT + 3, IDX_ROT:IDX_ROT + 3].add(
                p.icp_rotation_sigma**2 * jnp.eye(3)
            )
            P_imu_init = lio.transform_covariance_lidar_to_imu(P, T_il, x.rotation)
            R_world_imu = x.rotation @ R_il
            raw = integrate_steps(
                pp, init_state(P_imu_init), dt_s, w0, w1, a0, a1, valid,
                x.gyro_bias, x.accel_bias, R_world_imu,
            )

            # ---- state/covariance prediction ------------------------------
            T_imu_rel = predict_relative_transform(pp, raw, R_world_imu, x.velocity)
            T_lidar_rel = T_il @ T_imu_rel @ lie.transform_inverse(T_il)
            T_pred = x.pose() @ T_lidar_rel
            v_pred = x.velocity + g * raw.dt_total + R_world_imu @ raw.Delta_v
            pred = State(
                position=T_pred[:3, 3], rotation=T_pred[:3, :3],
                velocity=v_pred, accel_bias=x.accel_bias, gyro_bias=x.gyro_bias,
            )
            P_pred = lio.transform_covariance_imu_to_lidar(
                raw.covariance, T_il, pred.rotation
            )

            # ---- registration --------------------------------------------
            n_pre = pre.count()
            small = n_pre <= min_pts
            source = pre
            if sampling.enable and sampling.num < pre.capacity:
                source = random_sampling(pre, sampling.num, key)
            aligned = lio.align(
                source, submap, knn, pred, P_pred, P_post,
                factor_params=p.registration.factor, params=p.lio,
                update_bias=update_bias, trace=self.collect_trace,
            )
            result, iter_trace = aligned if self.collect_trace else (aligned, None)
            x_reg = result.state
            if p.max_accel_bias_norm > 0.0:
                x_reg = x_reg._replace(
                    accel_bias=_clamp_norm(x_reg.accel_bias, p.max_accel_bias_norm)
                )
            if p.max_gyro_bias_norm > 0.0:
                x_reg = x_reg._replace(
                    gyro_bias=_clamp_norm(x_reg.gyro_bias, p.max_gyro_bias_norm)
                )

            # ---- IMU-only fallback select (small clouds) ------------------
            def sel(a, b):
                return jax.tree_util.tree_map(
                    lambda u, v: jnp.where(small, u, v), a, b
                )

            x_new = sel(pred, x_reg)
            P_new = sel(P_pred, result.posterior_covariance)
            T_eff = x_new.pose()
            finite_ok = (
                jnp.all(jnp.isfinite(T_eff))
                & jnp.all(jnp.isfinite(x_new.velocity))
                & jnp.all(jnp.isfinite(P_new))
            )

            # ---- keyframe decision (submapping.hpp:99-121) ----------------
            n_reg = source.count()
            ratio = result.inlier.astype(jnp.float32) / jnp.maximum(
                n_reg, 1
            ).astype(jnp.float32)
            if kfp.inlier_ratio_threshold > 0.0:
                inlier_ok = ratio > kfp.inlier_ratio_threshold
            else:
                inlier_ok = jnp.bool_(True)
            if is_occ:
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
            is_kf = (~small) & inlier_ok & geom_kf & finite_ok

            f32 = lambda v: jnp.asarray(v, jnp.float32)
            stats1 = jnp.concatenate([
                T_eff.ravel(),
                jnp.stack([
                    f32(result.inlier), f32(n_pre), f32(n_reg), f32(is_kf),
                    f32(small), f32(finite_ok), f32(result.iterations),
                    f32(result.error), f32(raw.dt_total),
                ]),
                x_new.gyro_bias, x_new.accel_bias, x_new.velocity,
            ])
            if self.collect_trace:
                # innovation: registered-vs-predicted pose twist + state deltas
                innov = lie.se3_log(lie.transform_inverse(T_pred) @ x_reg.pose())
                debug = {
                    "iter_trace": iter_trace,
                    "T_pred": T_pred,
                    "innovation_rot": jnp.linalg.norm(innov[:3]),
                    "innovation_trans": jnp.linalg.norm(innov[3:]),
                    "v_pred": v_pred,
                    "dv_update": jnp.linalg.norm(x_reg.velocity - v_pred),
                }
                return x_new, P_new, source, T_eff, is_kf, stats1, debug
            return x_new, P_new, source, T_eff, is_kf, stats1

        self._lio_step_jit = jax.jit(_lio_step)

    def _build_submap_step(self):
        self._submap_robust_scale = None
        key = (self.submap.map_capacity, self.submap.extract_capacity)
        cached = getattr(self, "_prebuilt_submap", {}).get(key)
        if cached is not None:
            self._submap_step_jit = cached
        else:
            self.submap.compile_log.append(
                {"what": "submap_step_jit_miss", "key": key}
            )
            self._submap_step_jit = build_submap_step(
                self.params, self.submap, robust_scale=None
            )
        self._fused_version = self.submap.version

    def precompile_growth(self, max_capacity: int, wait: bool = True) -> int:
        """Deployment warm-start: compile every map-growth step up to
        ``max_capacity`` ahead of the stream (see
        :func:`fused_submap.precompile_growth_ladder`).  Call after the
        first processed frame."""
        return precompile_growth_ladder(self, max_capacity, wait=wait)

    # ------------------------------------------------------------------
    def add_imu_measurement(self, meas: IMUMeasurement):
        self.imu_buffer.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while self.imu_buffer and self.imu_buffer[0].timestamp < horizon:
            self.imu_buffer.popleft()

    # ------------------------------------------------------------------
    def process(self, scan: PointCloud, timestamp: float, scan_duration_sec: float = 0.1) -> ResultType:
        self.error_message = ""
        p = self.params

        if (
            self.is_first_frame
            and self.alignment_estimator is not None
            and not self.alignment_estimator.is_done()
        ):
            ok, R_gl, gyro_bias, diag = self.alignment_estimator.try_align(
                timestamp, list(self.imu_buffer),
                self.gyro_bias_np, self.accel_bias_np,
            )
            if not ok:
                self.error_message = f"initial_alignment: {diag.error_message}"
                return ResultType.waiting_initial_alignment
            user_R = self.odom[:3, :3]
            yaw = float(np.arctan2(user_R[1, 0], user_R[0, 0]))
            cz, sz = np.cos(yaw), np.sin(yaw)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
            self.odom[:3, :3] = Rz @ R_gl
            self.prev_odom = self.odom.copy()
            self.gyro_bias_np = np.asarray(gyro_bias, np.float32)
            self.x = self.x._replace(
                rotation=jnp.asarray(self.odom[:3, :3]),
                gyro_bias=jnp.asarray(gyro_bias),
            )

        if self.last_frame_time > 0.0:
            dt = timestamp - self.last_frame_time
            if dt > 0.0:
                self.dt = float(dt)
            else:
                self.error_message = "old timestamp"
                return ResultType.old_timestamp
        self.processing_times.clear()
        self.sync_count_last_frame = 0

        # preprocess + covariances + refine (shared with the LO pipeline)
        t0 = time.perf_counter()
        cloud = scan
        if p.imu.deskew.enable:
            if self.is_first_frame:
                R_imu0 = (
                    self.odom[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]
                ).astype(np.float32)
                v0 = self.imu_v_world_at_reset
            else:
                # deskew initial conditions at SCAN START, not at the
                # previous frame's reset: on a turning/accelerating
                # trajectory the one-frame-stale (R, v) injects a*dt-scale
                # point warps that feed back into the map (round-5 fix)
                R_imu0, v0 = self._propagate_to_scan_start(timestamp)
            cloud, _ = self.pc_processor.deskew_with_imu(
                cloud, list(self.imu_buffer), self.odom, timestamp, scan_duration_sec,
                self.gyro_bias_np, self.accel_bias_np,
                v_world_body=v0, R_world_imu=R_imu0,
            )
        pre = self.pc_processor.prefilter(cloud)
        ctx = self.pc_processor.prepare_context(pre)
        pre = self.pc_processor.compute_covariances(pre, ctx)
        pre = self.pc_processor.refine_filter(pre, ctx)
        self.preprocessed = pre
        self.processing_times["1. preprocessing"] += time.perf_counter() - t0

        if self.is_first_frame:
            if int(pre.count()) <= p.registration.min_num_points:
                self.error_message = "point cloud size is too small"
                return ResultType.small_number_of_points
            self.submap.add_first_frame(pre, timestamp, self.odom)
            self._dropped_seen = int(self.submap.map_state.dropped)
            self.is_first_frame = False
            self.last_frame_time = timestamp
            self.last_imu_reset_timestamp = timestamp
            # keep the current velocity state: zeroing here would wipe a
            # caller-seeded initial velocity and put the filter through a
            # multi-frame velocity transient — with IMU deskew enabled that
            # transient WARPS the early scans (deskew uses the velocity
            # estimate) and poisons the map they seed (round-5 root cause of
            # the distorted-replay divergence, REPLAY_DESKEW_LIO_r4)
            self.x = self.x._replace(
                position=jnp.asarray(self.odom[:3, 3]),
                rotation=jnp.asarray(self.odom[:3, :3]),
            )
            self.imu_R_world_at_reset = (
                self.odom[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]
            )
            return ResultType.first_frame

        return self._process_fused(pre, timestamp)

    # ------------------------------------------------------------------
    def _process_fused(self, pre: PointCloud, timestamp: float) -> ResultType:
        """Fused inertial frame: ONE device->host sync (overridden by the
        deep-pipelined variant in pipeline/pipelined_lio.py)."""
        p = self.params
        t0 = time.perf_counter()
        window = build_measurement_window(
            list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp
        )
        imu_pack = pack_steps(*padded_steps_from_window(window))

        kfp = p.submap.keyframe
        kf_dt_exceeded = (
            self.submap.last_keyframe_time <= 0.0
            or (timestamp - self.submap.last_keyframe_time)
            >= kfp.time_threshold_seconds
        )
        misc = np.concatenate(
            [
                np.asarray(self.submap.last_keyframe_pose, np.float32).ravel(),
                np.asarray(
                    [self._imu_bias_observable(), kf_dt_exceeded], np.float32
                ),
            ]
        )
        self._key, k1, k2 = jax.random.split(self._key, 3)
        reg_args = (
            pre, self.submap.submap_cloud, self.submap.submap_knn,
            self.x, self.P_post,
            jnp.asarray(imu_pack), jnp.asarray(misc), k1,
        )
        # shape signature for the growth precompile (the LIO step retraces
        # when the extract tier changes the target shape)
        self._reg_arg_structs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), reg_args
        )
        if self.collect_trace:
            x_new, P_new, reg_input, T_eff, is_kf, s1, dbg = self._lio_step_jit(*reg_args)
            self.last_trace = {k: np.asarray(v) for k, v in dbg.items()}
            self.sync_count_last_frame += 1
        else:
            x_new, P_new, reg_input, T_eff, is_kf, s1 = self._lio_step_jit(*reg_args)
        self.processing_times["3. registration"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        if self._fused_version != self.submap.version:
            self._build_submap_step()
        prev_map_state = self.submap.map_state
        submap_args = (
            prev_map_state, self.submap.submap_cloud, reg_input, T_eff, is_kf, k2
        )
        new_map_state, new_submap, sampled, s2 = self._submap_step_jit(*submap_args)
        start_growth_precompile(self, None, submap_args,
                                enabled=self.growth_precompile,
                                load=self._last_load)

        self.processing_times["4a. submap dispatch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = np.asarray(self._stats_cat_jit(s1, s2))
        self.sync_count_last_frame += 1
        self.processing_times["4b. stats fetch"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, kf_flag, small_flag, finite_ok,
         iterations, error, dt_total) = stats[16:25]
        self.gyro_bias_np = stats[25:28].astype(np.float32)
        self.accel_bias_np = stats[28:31].astype(np.float32)
        self.velocity_np = stats[31:34].astype(np.float32)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = stats[_S1:_S1 + 6]
        self._last_load = float(load)

        if finite_ok < 0.5:
            self.error_message = "imu-only propagation produced non-finite state or covariance"
            self.processing_times["4. build submap"] += time.perf_counter() - t0
            return ResultType.error

        # ---- commit -------------------------------------------------------
        self.x = x_new
        self.P_post = P_new
        self.prev_odom = self.odom.copy()
        self.odom = T_np.copy()
        self.last_frame_time = timestamp
        self.last_imu_reset_timestamp = timestamp
        self.imu_R_world_at_reset = (
            T_np[:3, :3] @ p.imu.T_imu_to_lidar_matrix()[:3, :3]
        )
        self.imu_v_world_at_reset = self.velocity_np

        if small_flag > 0.5:
            self.reg_result = None
            self.error_message = "point cloud size is too small; propagated with IMU only"
            self.processing_times["4. build submap"] += time.perf_counter() - t0
            return ResultType.imu_only

        self.reg_result = None  # per-frame LIO result scalars live in stats
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
            # keyframe bookkeeping is VHM-only (submapping.hpp:99-121)
            if not self.submap.is_occupancy:
                self.submap.last_keyframe_pose = T_np.copy()
                self.submap.last_keyframe_time = timestamp
                self.submap.keyframe_poses.append(self.submap.last_keyframe_pose)

        dropped_delta = int(dropped) - self._dropped_seen
        if dropped_delta > 0:
            self.submap.map_state = prev_map_state
            self.submap.retry_insert_after_drop(sampled, T_np)
            self._dropped_seen = int(self.submap.map_state.dropped)
            self.sync_count_last_frame += 3
        else:
            self._dropped_seen = int(dropped)
            if float(load) > 0.7:
                self.submap._grow_map(origin=T_np)
        # extract-overflow backstop (see LidarOdometry._process_fused)
        if self.submap.extract_overflow > 0:
            if self.submap.resolve_extract_overflow(T_np):
                self.sync_count_last_frame += 2
        self.processing_times["4. build submap"] += time.perf_counter() - t0
        return ResultType.success

    # ------------------------------------------------------------------
    def _propagate_to_scan_start(self, timestamp: float):
        """Host-side midpoint propagation of (R_world_imu, v_world) from the
        last preintegration reset to ``timestamp`` (the scan start) — the
        IMU-deskew initial conditions.  ~tens of numpy 3-vector ops per
        frame; the device-side fused step recomputes the same window anyway
        (imu_deskew.hpp:123-160 semantics: state AT scan start)."""
        from sycl_points_tpu.utils.lie_np import so3_exp_matrix

        window = build_measurement_window(
            list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp
        )
        R = self.imu_R_world_at_reset.astype(np.float64)
        v = self.imu_v_world_at_reset.astype(np.float64)
        g = np.asarray(self.params.imu.preintegration.gravity, np.float64)
        a_scale = self.params.imu.preintegration.accel_scale
        bg = self.gyro_bias_np.astype(np.float64)
        ba = self.accel_bias_np.astype(np.float64)
        for m0, m1 in zip(window[:-1], window[1:]):
            dt = m1.timestamp - m0.timestamp
            if dt <= 1e-9:
                continue
            w = 0.5 * (m0.gyro + m1.gyro).astype(np.float64) - bg
            a = 0.5 * (m0.accel + m1.accel).astype(np.float64) * a_scale - ba
            R_half = R @ so3_exp_matrix(w * (0.5 * dt))
            v = v + (R_half @ a + g) * dt
            R = R @ so3_exp_matrix(w * dt)
        return R.astype(np.float32), v.astype(np.float32)

    # ------------------------------------------------------------------
    def _imu_bias_observable(self) -> bool:
        """lidar_inertial_odometry.hpp:371-393.

        freeze_on_low_excitation is not in the default param surface here;
        reference default is False -> always observable."""
        return True

    def get_odometry(self) -> np.ndarray:
        return self.odom.copy()

    def get_state(self) -> State:
        return self.x


def _clamp_norm(v: jax.Array, max_norm: float) -> jax.Array:
    n = jnp.linalg.norm(v)
    return jnp.where(n > max_norm, v * (max_norm / jnp.maximum(n, 1e-30)), v)
