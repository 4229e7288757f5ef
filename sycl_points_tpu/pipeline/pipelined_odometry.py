"""Pipelined LiDAR odometry: device-resident state + deferred stats fetch.

``LidarOdometry`` (pipeline/lidar_odometry.py) already fuses every per-frame
scalar into ONE device->host readback, but that readback is *synchronous*:
the frame blocks on device compute + one device->host transfer every frame.
This subclass removes the block from the frame path entirely:

- **All frame-to-frame state lives on device** in an :class:`OdomCarry`
  pytree (pose, EMA velocities, keyframe bookkeeping, the previous result's
  raw Hessian for the adaptive motion predictor and MAP prior).  The host
  uploads only ``[dt, timestamp]`` per frame.
- **The motion predictor runs on device** (constant-velocity mode with the
  degeneracy-adaptive damping of ``adaptive_motion_predictor.hpp:56-97``,
  3x3 eigenvalues via :func:`utils.eigh3.eigvalsh3`).
- **The stats fetch is adaptively deep-pipelined**: every frame starts its
  d2h transfer asynchronously (``copy_to_host_async``) and frames resolve
  whenever their transfer completes (``jax.Array.is_ready``), up to
  ``max_in_flight`` outstanding.  Small transfers do not serialize each
  other, so with a window deeper than latency/frame-period the host never
  blocks: results lag a few frames and the steady-state wall time is
  dispatch-bound.  The latest pose is
  always available on device (the carry) for any consumer willing to pay
  one fetch.

The rare growth/drop-retry slow path reconciles the whole in-flight window:
on an observed drop at frame *j* the map rolls back to *j*'s stashed
pre-insert state, re-inserts *j* with growth, then re-applies the stashed
sampled clouds of every later in-flight frame in order (their poses come
from program A and are unaffected).  Growth-policy decisions from frames
older than the reconciliation point are skipped.

Semantics deltas vs the synchronous pipeline (both deliberate, both the
standard cost of pipelining a readback):

- ``process()`` returns ``success`` optimistically; the authoritative
  per-frame result arrives one frame later in :attr:`pose_log` /
  :attr:`deferred_results` (call :meth:`flush` to drain the last frame).
- ``dt`` uses wall timestamps even across a rejected (too-small) frame,
  where the synchronous pipeline freezes ``last_frame_time`` until the next
  success.  The device carry itself handles small frames exactly like the
  reference (pose, velocities, keyframe state all hold).
- After a drop-retry rebuild, the next frame's registration ran against the
  pre-retry target cloud (one frame of staleness on a rare path).

Constraints: IMU must be disabled (the IMU prediction/deskew paths are
host-coupled; use :class:`LidarInertialOdometry` or the synchronous
pipeline), so the effective prediction mode is LIDAR_CV.

Reference frame loop being beaten: ``pipeline/lidar_odometry.hpp:115-298``
(host loop over shared memory — zero readback cost by construction; across
PCIe this pipelined design is what recovers that).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.pipeline.fused_submap import start_growth_precompile
from sycl_points_tpu.pipeline.lidar_odometry import _S1, LidarOdometry, ResultType
from sycl_points_tpu.pipeline.params import LidarOdometryParams
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.map_prior import MapPriorParams
from sycl_points_tpu.registration.map_prior import update as map_prior_update
from sycl_points_tpu.registration.pipeline import align_pipeline
from sycl_points_tpu.utils import eigh3, lie, lie_np


class OdomCarry(NamedTuple):
    """Device-resident frame-to-frame odometry state."""

    odom: jax.Array           # [4,4] current pose
    lin_vel: jax.Array        # [3]  velocity from the last successful frame
    ang_vel: jax.Array        # [3]
    lin_smooth: jax.Array     # [3]  EMA predictor state
    ang_smooth: jax.Array     # [3]
    have_smooth: jax.Array    # bool: EMA state initialized
    registrated: jax.Array    # bool: at least one successful registration
    last_kf_pose: jax.Array   # [4,4]
    last_kf_time: jax.Array   # f32
    prev_T: jax.Array         # [4,4] previous RAW result pose (prior input)
    prev_Hraw: jax.Array      # [6,6]
    prev_err_raw: jax.Array   # f32
    prev_inlier: jax.Array    # i32


class _Pending(NamedTuple):
    """In-flight frame: the async stats handle plus everything the resolve
    slow path may need (device handles — holding them costs no sync)."""

    stats: jax.Array
    sampled: PointCloud
    prev_map_state: object
    T_eff: jax.Array          # device pose handle (drop-retry re-insert)
    preprocessed: PointCloud
    timestamp: float
    dt: float
    frame_index: int


def _axis_factor_dev(H_block, inlier, axis):
    """Device port of adaptive_motion_predictor.hpp:56-97 (see
    pipeline/motion_predictor.py for the host original)."""
    w = eigh3.eigvalsh3(0.5 * (H_block + H_block.T))
    min_eig_ratio = jnp.min(w) / jnp.maximum(inlier, 1).astype(jnp.float32)
    lo, hi = axis.min_eigenvalue_low, axis.min_eigenvalue_high
    score = jnp.clip((min_eig_ratio - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    f = axis.factor_max * (1.0 - score) + axis.factor_min * score
    return jnp.where(inlier > 0, f, axis.factor_max)


class PipelinedLidarOdometry(LidarOdometry):
    """LiDAR odometry with a one-frame-deep readback pipeline."""

    def __init__(self, params: LidarOdometryParams = LidarOdometryParams(),
                 map_prior_params: MapPriorParams = MapPriorParams(),
                 max_in_flight: int = 16):
        if params.imu.enable:
            raise ValueError(
                "PipelinedLidarOdometry requires imu.enable=False "
                "(IMU prediction/deskew are host-coupled); use "
                "LidarInertialOdometry or the synchronous LidarOdometry."
            )
        super().__init__(params, map_prior_params)
        self._carry: Optional[OdomCarry] = None
        from collections import deque

        self._pending: "deque[_Pending]" = deque()
        self._max_in_flight = max(1, max_in_flight)
        # frames at or before this index had their map contribution
        # reconciled by a drop-retry rebuild; skip their growth policy
        self._reconciled_until = -1
        # frames at or before this index dispatched before the last
        # proactive growth; their stale load factors must not re-grow
        self._load_grown_until = -1
        # authoritative per-frame outcomes, a few frames behind dispatch:
        # (frame_index, timestamp, pose [4,4] np, ResultType)
        self.pose_log: list = []
        self.deferred_results: list = []

    # -- device program -----------------------------------------------------
    def _build_reg_step(self):
        """Program A, pipelined variant: device motion prediction + MAP
        prior + align + keyframe decision + carry update.  Same stats1
        layout as the base class (host parse is shared)."""
        p = self.params
        kfp = p.submap.keyframe
        mp = p.motion_prediction
        min_pts = p.registration.min_num_points
        is_occ = self.submap.is_occupancy
        prior_enabled = self.map_prior_params.enabled
        ema_a = mp.velocity_ema_alpha

        def _reg_step(pre, submap, knn, carry: OdomCarry, host_vec):
            dt_s = host_vec[0]
            timestamp = host_vec[1]

            # ---- motion prediction (device CV predictor) ----
            rot_f = _axis_factor_dev(
                carry.prev_Hraw[:3, :3], carry.prev_inlier, mp.rotation
            )
            trans_f = _axis_factor_dev(
                carry.prev_Hraw[3:, 3:], carry.prev_inlier, mp.translation
            )
            adaptive = carry.registrated & (carry.prev_inlier > 0)
            rot_f = jnp.where(adaptive, rot_f, mp.rotation.factor_max)
            trans_f = jnp.where(adaptive, trans_f, mp.translation.factor_max)

            lin_s = jnp.where(
                carry.have_smooth,
                ema_a * carry.lin_vel + (1.0 - ema_a) * carry.lin_smooth,
                carry.lin_vel,
            )
            ang_s = jnp.where(
                carry.have_smooth,
                ema_a * carry.ang_vel + (1.0 - ema_a) * carry.ang_smooth,
                carry.ang_vel,
            )
            R_delta = lie.quat_to_matrix(lie.so3_exp(ang_s * dt_s * rot_f))
            init_T = jnp.eye(4, dtype=jnp.float32)
            init_T = init_T.at[:3, :3].set(carry.odom[:3, :3] @ R_delta)
            init_T = init_T.at[:3, 3].set(
                carry.odom[:3, 3] + carry.odom[:3, :3] @ (lin_s * dt_s * trans_f)
            )

            n_pre = pre.count()
            small = n_pre <= min_pts

            prior = None
            if prior_enabled:
                prior = map_prior_update(
                    self.map_prior_params, carry.prev_T, carry.prev_Hraw,
                    carry.prev_err_raw, carry.prev_inlier, init_T,
                )
                prior = prior._replace(active=prior.active & carry.registrated)

            out = align_pipeline(
                pre, submap, knn, self.pipeline_params,
                initial_guess=init_T, prev_pose=carry.odom, dt=dt_s,
                map_prior=prior,
            )
            result = out.result
            T_eff = jnp.where(small, carry.odom, result.T)

            # ---- keyframe decision (lidar_odometry.hpp:599-621) ----
            n_reg = out.registration_input.count()
            n_desk = out.deskewed.count()
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
                kf_dt_exceeded = (carry.last_kf_time <= 0.0) | (
                    (timestamp - carry.last_kf_time)
                    >= kfp.time_threshold_seconds
                )
                delta_kf = lie.transform_inverse(carry.last_kf_pose) @ T_eff
                tw_kf = lie.se3_log(delta_kf)
                dist = jnp.linalg.norm(delta_kf[:3, 3])
                angle_deg = jnp.linalg.norm(tw_kf[:3]) * (180.0 / math.pi)
                geom_kf = (
                    (dist >= kfp.distance_threshold)
                    | (angle_deg >= kfp.angle_threshold_degrees)
                    | kf_dt_exceeded
                )
            is_kf = (~small) & inlier_ok & geom_kf

            # ---- velocity/odometry update (hpp:280-296), small holds ----
            delta = lie.transform_inverse(carry.odom) @ T_eff
            tw = lie.se3_log(delta)
            new_lin = delta[:3, 3] / dt_s
            new_ang = tw[:3] / dt_s
            upd = ~small
            kf_update = is_kf & jnp.bool_(not is_occ)
            new_carry = OdomCarry(
                odom=T_eff,
                lin_vel=jnp.where(upd, new_lin, carry.lin_vel),
                ang_vel=jnp.where(upd, new_ang, carry.ang_vel),
                lin_smooth=lin_s,
                ang_smooth=ang_s,
                have_smooth=jnp.bool_(True),
                registrated=carry.registrated | upd,
                last_kf_pose=jnp.where(kf_update, T_eff, carry.last_kf_pose),
                last_kf_time=jnp.where(kf_update, timestamp, carry.last_kf_time),
                prev_T=jnp.where(upd, result.T, carry.prev_T),
                prev_Hraw=jnp.where(upd, result.H_raw, carry.prev_Hraw),
                prev_err_raw=jnp.where(upd, result.error_raw, carry.prev_err_raw),
                prev_inlier=jnp.where(upd, result.inlier, carry.prev_inlier),
            )

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
            return result, out.deskewed, T_eff, is_kf, new_carry, stats1

        self._reg_step_fn = _reg_step  # raw traceable (fleet vmaps this)
        self._reg_step_jit = jax.jit(_reg_step)

    def _init_carry(self) -> OdomCarry:
        f = lambda a: jnp.asarray(a, jnp.float32)
        return OdomCarry(
            odom=f(self.odom),
            lin_vel=f(self.linear_velocity),
            ang_vel=f(self.angular_velocity),
            lin_smooth=jnp.zeros(3, jnp.float32),
            ang_smooth=jnp.zeros(3, jnp.float32),
            have_smooth=jnp.bool_(False),
            registrated=jnp.bool_(self.registrated),
            last_kf_pose=f(self.submap.last_keyframe_pose),
            last_kf_time=jnp.float32(self.submap.last_keyframe_time),
            prev_T=jnp.eye(4, dtype=jnp.float32),
            prev_Hraw=jnp.zeros((6, 6), jnp.float32),
            prev_err_raw=jnp.float32(0.0),
            prev_inlier=jnp.int32(0),
        )

    # -- pipelined frame ----------------------------------------------------
    def _process_fused(self, pre: PointCloud, timestamp: float) -> ResultType:
        t0 = time.perf_counter()
        if self._carry is None:
            self._carry = self._init_carry()

        # ---- program A: registration (reads only the target cloud) ----
        host_vec = np.asarray([self.dt, timestamp], np.float32)
        reg_args = (
            pre, self.submap.submap_cloud, self.submap.submap_knn,
            self._carry, jnp.asarray(host_vec),
        )
        # shape signature for the growth precompile (the registration step
        # retraces when the extract tier changes the target shape)
        self._reg_arg_structs = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), reg_args
        )
        result, deskewed, T_eff, is_kf, new_carry, s1 = self._reg_step_jit(*reg_args)
        self._carry = new_carry
        self.reg_result = result
        self.processing_times["3. registration"] += time.perf_counter() - t0

        # ---- program B: submap update ----
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
        # commit device handles (no sync)
        self.submap.map_state = new_map_state
        self.submap.submap_cloud = new_submap
        self.submap.submap_knn = BruteForceKNN(
            points=new_submap.points, mask=new_submap.mask,
        )
        stats = self._stats_cat_jit(s1, s2)
        stats.copy_to_host_async()  # transfer rides out the following frames
        self.sync_count_last_frame += 1
        self._pending.append(_Pending(
            stats=stats, sampled=sampled, prev_map_state=prev_map_state,
            T_eff=T_eff, preprocessed=self.preprocessed,
            timestamp=timestamp, dt=self.dt, frame_index=self.frame_count,
        ))
        self.processing_times["4a. submap dispatch"] += time.perf_counter() - t0

        # ---- adaptive drain: resolve every frame whose transfer landed;
        # block only when the in-flight window is full ----
        t0 = time.perf_counter()
        while self._pending and (
            len(self._pending) > self._max_in_flight
            or self._pending[0].stats.is_ready()
        ):
            self._resolve_one(self._pending.popleft())
        self.processing_times["4b. stats fetch"] += time.perf_counter() - t0

        self.frame_count += 1
        self.last_frame_time = timestamp
        return ResultType.success

    # ------------------------------------------------------------------
    def _resolve_one(self, pend: _Pending) -> None:
        """Resolve one in-flight frame: parse its stats (transfer usually
        already complete), commit host mirrors, run the growth policy."""
        stats = np.asarray(pend.stats)  # blocks only on transfer remainder

        T_np = stats[:16].reshape(4, 4).astype(np.float32)
        (n_inlier, n_pre, n_reg, n_desk, kf_flag, small_flag,
         converged, iterations, error) = stats[16:25]
        H_raw_np = stats[25:61].reshape(6, 6).astype(np.float32)
        load, overflow, ext_ok, dropped, budget_lost, n_extracted = \
            stats[_S1:_S1 + 6]
        self._last_load = float(load)

        if small_flag > 0.5:
            rtype = ResultType.small_number_of_points
        else:
            rtype = ResultType.success
        self.deferred_results.append((pend.frame_index, rtype))
        self.pose_log.append((pend.frame_index, pend.timestamp, T_np, rtype))

        # host mirrors (telemetry + accessors; authoritative state is the
        # device carry)
        self._prev_Hraw_np = H_raw_np
        self._prev_inlier = int(n_inlier)
        if kf_flag > 0.5:
            # per-insert telemetry: only keyframes run extraction, so a
            # non-keyframe frame's stats2 overflow=0 must not zero it
            self.submap.extract_overflow = int(overflow)
        self.submap.budget_lost = int(budget_lost)
        if rtype is ResultType.success:
            self.prev_odom = self.odom.copy()
            self.odom = T_np.copy()
            dt = pend.dt
            delta = np.linalg.inv(self.prev_odom) @ self.odom
            tw = lie_np.se3_log(delta)
            self.linear_velocity = (delta[:3, 3] / dt).astype(np.float32)
            self.angular_velocity = (tw[:3] / dt).astype(np.float32)
            self.registrated = True
        else:
            self.error_message = "point cloud size is too small"

        if kf_flag > 0.5:
            self.submap.last_keyframe_cloud = pend.sampled
            if not self.submap.is_occupancy:
                self.submap.last_keyframe_pose = T_np.copy()
                self.submap.last_keyframe_time = pend.timestamp
                self.submap.keyframe_poses.append(self.submap.last_keyframe_pose)

        # publish deskew (full-resolution, CV) — one frame late by design.
        # Twist MUST span exactly this frame: resolution is FIFO, so
        # self.prev_odom (just committed above) is pose[j-1] and pend.dt is
        # frame j's dt — the dispatch-time mirror was k frames stale in the
        # deep-pipeline regime and self.dt belongs to the newest frame.
        if (
            rtype is ResultType.success
            and self.pipeline_params.velocity_update.enable
            and pend.preprocessed is not None
            and pend.preprocessed.timestamp_offsets is not None
        ):
            self.preprocessed = self._deskew_jit(
                pend.preprocessed,
                jnp.asarray(self.prev_odom), jnp.asarray(T_np),
                jnp.float32(pend.dt),
            )

        # growth policy (rare host slow path; syncs when it fires).  Frames
        # whose map contribution was already reconciled by an earlier
        # drop-retry rebuild report counters from the discarded chain —
        # skip their growth decisions.
        if pend.frame_index <= self._reconciled_until:
            return
        dropped_delta = int(dropped) - self._dropped_seen
        if dropped_delta > 0:
            # Roll back to this frame's pre-insert state, then re-apply this
            # frame AND every LATER in-flight frame's stashed sampled cloud
            # in order as ONE fused chain program with grow-and-retry (their
            # poses come from program A and are unaffected by the map
            # rebuild; non-keyframe sampled clouds have empty masks, so
            # re-applying them is a no-op).  The chain replaces a sequential
            # host loop that paid ~4 device->host syncs per stashed frame.
            self.submap.map_state = pend.prev_map_state  # retry loses nothing
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
            # Proactive growth: in-flight frames' load factors were measured
            # on the pre-growth capacity, so gate the load check (NOT drop
            # detection) until the frames dispatched before the growth have
            # drained.
            if float(load) > 0.7 and pend.frame_index > self._load_grown_until:
                self.submap._grow_map(origin=T_np)
                self._load_grown_until = (
                    self._pending[-1].frame_index if self._pending
                    else pend.frame_index
                )
        # extract-overflow backstop (see LidarOdometry._process_fused): grow
        # the extraction tier and re-extract so later dispatches use an
        # untruncated target.  Frames already in flight registered against
        # the truncated one — the standard one-tier-transition cost.
        if self.submap.extract_overflow > 0:
            if self.submap.resolve_extract_overflow(T_np):
                self.sync_count_last_frame += 2

    def flush(self) -> None:
        """Resolve all in-flight frames (call once after the stream)."""
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def resolve_oldest(self) -> bool:
        """Force-resolve the OLDEST in-flight frame with a blocking fetch;
        returns True if one was resolved.  Serving layers idling between
        scans call it so the poses of frames already in flight are published
        without waiting for the next scan to arrive."""
        if not self._pending:
            return False
        self._resolve_one(self._pending.popleft())
        return True

    # -- accessors ----------------------------------------------------------
    def get_odometry(self) -> np.ndarray:
        """Latest RESOLVED pose (one frame behind dispatch until flush())."""
        return self.odom.copy()
