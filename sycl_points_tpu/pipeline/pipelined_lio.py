"""Deep-pipelined LiDAR-inertial odometry (deferred stats fetch).

Same architecture as :mod:`pipeline.pipelined_odometry` applied to the
15-DOF tightly-coupled pipeline: the filter state ``(x, P_post)`` already
chains frame-to-frame as device handles, so the only state that had to move
on device is the keyframe bookkeeping (:class:`LIOCarry`).  Every frame
uploads one packed IMU window + a ``[timestamp, update_bias]`` vector,
dispatches the fused inertial program + submap update, starts the stats
d2h transfer asynchronously, and resolves frames whenever their transfer
lands (``jax.Array.is_ready``, up to ``max_in_flight`` outstanding).

Semantics deltas vs the synchronous pipeline (documented, all confined to
rare paths):

- ``process()`` returns ``success`` optimistically; authoritative per-frame
  outcomes (``imu_only`` for too-small clouds, ``error`` for non-finite
  propagation) arrive a few frames later in :attr:`pose_log` /
  :attr:`deferred_results` (:meth:`flush` drains the tail).
- The device program guards the non-finite case itself (state and
  covariance hold instead of the host refusing the commit), and the
  preintegration window resets at every dispatched frame, so an error
  frame's IMU measurements are not re-integrated into the next window the
  way the synchronous host loop re-integrates them.
- The host bias/velocity mirrors lag a few frames; they only feed
  telemetry and the (unsupported here) host IMU-deskew path.

Constraints: ``imu.deskew.enable`` must be False — host deskew consumes
the per-frame bias/velocity mirrors at dispatch time, which a deferred
fetch cannot provide fresh.  The reference default is off
(lidar_inertial_odometry.hpp:131-472 runs deskew optionally too).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.imu.preintegration import (
    build_measurement_window,
    init_state,
    integrate_steps,
    pack_steps,
    padded_steps_from_window,
    predict_relative_transform,
    unpack_steps,
)
from sycl_points_tpu.imu.factor import IDX_ROT, IDX_VEL, State
from sycl_points_tpu.lio import lio_registration as lio
from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.ops.sampling import random_sampling
from sycl_points_tpu.pipeline.fused_submap import start_growth_precompile
from sycl_points_tpu.pipeline.lidar_inertial_odometry import (
    _S1,
    LidarInertialOdometry,
    ResultType,
    _clamp_norm,
)
from sycl_points_tpu.pipeline.params import LidarInertialOdometryParams
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils import lie


class LIOCarry(NamedTuple):
    """Device-resident keyframe bookkeeping (x/P already chain on device)."""

    last_kf_pose: jax.Array  # [4,4]
    last_kf_time: jax.Array  # f32


class _Pending(NamedTuple):
    stats: jax.Array
    sampled: PointCloud
    prev_map_state: object
    T_eff: jax.Array
    timestamp: float
    frame_index: int


class PipelinedLidarInertialOdometry(LidarInertialOdometry):
    """15-DOF LIO with an adaptively deep readback pipeline."""

    def __init__(self, params: LidarInertialOdometryParams = LidarInertialOdometryParams(),
                 max_in_flight: int = 16):
        if params.imu.deskew.enable:
            raise ValueError(
                "PipelinedLidarInertialOdometry requires imu.deskew.enable="
                "False (host deskew needs fresh per-frame bias/velocity "
                "mirrors); use the synchronous LidarInertialOdometry."
            )
        super().__init__(params)
        self._carry: Optional[LIOCarry] = None
        self.frame_count = 0
        self._pending: "deque[_Pending]" = deque()
        self._max_in_flight = max(1, max_in_flight)
        self._reconciled_until = -1
        self._load_grown_until = -1
        self.pose_log: list = []
        self.deferred_results: list = []

    # -- device program -----------------------------------------------------
    def _build_lio_step(self):
        """Fused inertial frame, pipelined variant: keyframe bookkeeping in
        a device carry, the non-finite guard on device (state holds), same
        stats layout as the base class."""
        p = self.params
        pp = p.imu.preintegration
        kfp = p.submap.keyframe
        min_pts = p.registration.min_num_points
        is_occ = self.submap.is_occupancy
        T_il_np = p.imu.T_imu_to_lidar_matrix()
        sampling = p.registration_sampling

        def _lio_step(pre, submap, knn, x, P_post, imu_pack, carry: LIOCarry,
                      host_vec, key):
            dt_s, w0, w1, a0, a1, valid = unpack_steps(imu_pack)
            timestamp = host_vec[0]
            update_bias = host_vec[1] > 0.5
            kf_dt_exceeded = (carry.last_kf_time <= 0.0) | (
                (timestamp - carry.last_kf_time) >= kfp.time_threshold_seconds
            )
            T_il = jnp.asarray(T_il_np)
            R_il = T_il[:3, :3]
            g = jnp.asarray(pp.gravity, jnp.float32)

            # ---- preintegration with the reset covariance floors
            # (lidar_inertial_odometry.hpp:402-459) ----
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

            n_pre = pre.count()
            small = n_pre <= min_pts
            source = pre
            if sampling.enable and sampling.num < pre.capacity:
                source = random_sampling(pre, sampling.num, key)
            result = lio.align(
                source, submap, knn, pred, P_pred, P_post,
                factor_params=p.registration.factor, params=p.lio,
                update_bias=update_bias,
            )
            x_reg = result.state
            if p.max_accel_bias_norm > 0.0:
                x_reg = x_reg._replace(
                    accel_bias=_clamp_norm(x_reg.accel_bias, p.max_accel_bias_norm)
                )
            if p.max_gyro_bias_norm > 0.0:
                x_reg = x_reg._replace(
                    gyro_bias=_clamp_norm(x_reg.gyro_bias, p.max_gyro_bias_norm)
                )

            def sel(cond, a, b):
                return jax.tree_util.tree_map(
                    lambda u, v: jnp.where(cond, u, v), a, b
                )

            x_new = sel(small, pred, x_reg)
            P_new = sel(small, P_pred, result.posterior_covariance)
            finite_ok = (
                jnp.all(jnp.isfinite(x_new.pose()))
                & jnp.all(jnp.isfinite(x_new.velocity))
                & jnp.all(jnp.isfinite(P_new))
            )
            # non-finite propagation must not corrupt the chained state: the
            # synchronous host refuses the commit (ResultType.error); here
            # the select does the same on device
            x_new = sel(finite_ok, x_new, x)
            P_new = sel(finite_ok, P_new, P_post)
            T_eff = x_new.pose()

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
                delta = lie.transform_inverse(carry.last_kf_pose) @ T_eff
                tw = lie.se3_log(delta)
                dist = jnp.linalg.norm(delta[:3, 3])
                angle_deg = jnp.linalg.norm(tw[:3]) * (180.0 / math.pi)
                geom_kf = (
                    (dist >= kfp.distance_threshold)
                    | (angle_deg >= kfp.angle_threshold_degrees)
                    | kf_dt_exceeded
                )
            is_kf = (~small) & inlier_ok & geom_kf & finite_ok

            kf_update = is_kf & jnp.bool_(not is_occ)
            new_carry = LIOCarry(
                last_kf_pose=jnp.where(kf_update, T_eff, carry.last_kf_pose),
                last_kf_time=jnp.where(kf_update, timestamp, carry.last_kf_time),
            )

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
            return x_new, P_new, source, T_eff, is_kf, new_carry, stats1

        self._lio_step_fn = _lio_step  # raw traceable (fleet vmaps this)
        self._lio_step_jit = jax.jit(_lio_step)

    def _init_carry(self) -> LIOCarry:
        return LIOCarry(
            last_kf_pose=jnp.asarray(self.submap.last_keyframe_pose, jnp.float32),
            last_kf_time=jnp.float32(self.submap.last_keyframe_time),
        )

    # -- pipelined frame ----------------------------------------------------
    def _process_fused(self, pre: PointCloud, timestamp: float) -> ResultType:
        p = self.params
        t0 = time.perf_counter()
        if self._carry is None:
            self._carry = self._init_carry()

        window = build_measurement_window(
            list(self.imu_buffer), self.last_imu_reset_timestamp, timestamp
        )
        imu_pack = pack_steps(*padded_steps_from_window(window))
        host_vec = np.asarray(
            [timestamp, self._imu_bias_observable()], np.float32
        )
        self._key, k1, k2 = jax.random.split(self._key, 3)
        reg_args = (
            pre, self.submap.submap_cloud, self.submap.submap_knn,
            self.x, self.P_post,
            jnp.asarray(imu_pack), self._carry, jnp.asarray(host_vec), k1,
        )
        # shape signature for the growth precompile (the LIO step retraces
        # when the extract tier changes the target shape)
        self._reg_arg_structs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), reg_args
        )
        x_new, P_new, reg_input, T_eff, is_kf, new_carry, s1 = self._lio_step_jit(*reg_args)
        self._carry = new_carry
        self.x = x_new
        self.P_post = P_new
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
        self.submap.map_state = new_map_state
        self.submap.submap_cloud = new_submap
        self.submap.submap_knn = BruteForceKNN(
            points=new_submap.points, mask=new_submap.mask,
        )
        stats = self._stats_cat_jit(s1, s2)
        stats.copy_to_host_async()
        self.sync_count_last_frame += 1
        self._pending.append(_Pending(
            stats=stats, sampled=sampled, prev_map_state=prev_map_state,
            T_eff=T_eff, timestamp=timestamp, frame_index=self.frame_count,
        ))
        self.processing_times["4a. submap dispatch"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        while self._pending and (
            len(self._pending) > self._max_in_flight
            or self._pending[0].stats.is_ready()
        ):
            self._resolve_one(self._pending.popleft())
        self.processing_times["4b. stats fetch"] += time.perf_counter() - t0

        self.frame_count += 1
        self.last_frame_time = timestamp
        self.last_imu_reset_timestamp = timestamp
        return ResultType.success

    # ------------------------------------------------------------------
    def _resolve_one(self, pend: _Pending) -> None:
        stats = np.asarray(pend.stats)

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, kf_flag, small_flag, finite_ok,
         iterations, error, dt_total) = stats[16:25]
        self.gyro_bias_np = stats[25:28].astype(np.float32)
        self.accel_bias_np = stats[28:31].astype(np.float32)
        self.velocity_np = stats[31:34].astype(np.float32)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = \
            stats[_S1:_S1 + 6]
        self._last_load = float(load)

        if finite_ok < 0.5:
            rtype = ResultType.error
            self.error_message = (
                "imu-only propagation produced non-finite state or covariance"
            )
        elif small_flag > 0.5:
            rtype = ResultType.imu_only
            self.error_message = (
                "point cloud size is too small; propagated with IMU only"
            )
        else:
            rtype = ResultType.success
        self.deferred_results.append((pend.frame_index, rtype))
        self.pose_log.append((pend.frame_index, pend.timestamp, T_np, rtype))

        # host mirrors (telemetry; the authoritative state chains on device)
        if rtype is not ResultType.error:
            self.prev_odom = self.odom.copy()
            self.odom = T_np.copy()
            self.imu_R_world_at_reset = (
                T_np[:3, :3] @ self.params.imu.T_imu_to_lidar_matrix()[:3, :3]
            )
            self.imu_v_world_at_reset = self.velocity_np
        if kf_flag > 0.5:
            # per-insert telemetry: only keyframes run extraction, so a
            # non-keyframe frame's stats2 overflow=0 must not zero it
            self.submap.extract_overflow = int(overflow)
        self.submap.budget_lost = int(budget_lost)
        if kf_flag > 0.5:
            self.submap.last_keyframe_cloud = pend.sampled
            if not self.submap.is_occupancy:
                self.submap.last_keyframe_pose = T_np.copy()
                self.submap.last_keyframe_time = pend.timestamp
                self.submap.keyframe_poses.append(self.submap.last_keyframe_pose)

        if pend.frame_index <= self._reconciled_until:
            return
        dropped_delta = int(dropped) - self._dropped_seen
        if dropped_delta > 0:
            # fused chain reconcile: one program per grow attempt instead of
            # ~4 device->host syncs per stashed frame (see Submap.reconcile_chain)
            self.submap.map_state = pend.prev_map_state
            clouds = [pend.sampled] + [l.sampled for l in self._pending]
            poses = [jnp.asarray(T_np)] + [l.T_eff for l in self._pending]
            self.submap.reconcile_chain(
                clouds, poses, window=self._max_in_flight + 1
            )
            self._reconciled_until = (
                self._pending[-1].frame_index if self._pending
                else pend.frame_index
            )
            self._dropped_seen = int(self.submap.map_state.dropped)
            self.sync_count_last_frame += 3
        else:
            self._dropped_seen = int(dropped)
            if float(load) > 0.7 and pend.frame_index > self._load_grown_until:
                self.submap._grow_map(origin=T_np)
                self._load_grown_until = (
                    self._pending[-1].frame_index if self._pending
                    else pend.frame_index
                )
        # extract-overflow backstop (see LidarOdometry._process_fused)
        if self.submap.extract_overflow > 0:
            if self.submap.resolve_extract_overflow(T_np):
                self.sync_count_last_frame += 2

    def flush(self) -> None:
        """Resolve all in-flight frames (call once after the stream)."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def resolve_oldest(self) -> bool:
        """Force-resolve the oldest in-flight frame (blocking fetch); see
        PipelinedLidarOdometry.resolve_oldest."""
        if not self._pending:
            return False
        self._resolve_one(self._pending.popleft())
        return True

    def get_odometry(self) -> np.ndarray:
        """Latest RESOLVED pose (a few frames behind dispatch until flush)."""
        return self.odom.copy()
