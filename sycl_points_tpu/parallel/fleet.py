"""Fleet odometry: B independent LiDAR odometry streams in one program.

Serving-oriented batching of :class:`PipelinedLidarOdometry`.  The per-frame
programs — preprocess, registration (program A) and submap update (program
B) — are ``vmap``-ed over a leading *stream* axis and dispatched ONCE per
fleet frame, so per-program dispatch overhead, the host orchestration cost,
and the single async stats readback amortize over all ``n_streams`` streams.
Small per-stream matmuls also batch into larger ones.

On a multi-chip ``jax.sharding.Mesh`` the stream axis is sharded (GSPMD):
each chip runs ``n_streams / n_devices`` streams with zero cross-chip
communication — embarrassingly parallel serving, the batch analog of the
reference's one-queue-per-process deployment (SURVEY.md 2.12; the reference
has no multi-stream story at all).

Semantics and scope (v1, documented deltas vs the single-stream pipelines):

- All streams share one parameter set and bootstrap together on the first
  ``process_batch`` call (serving model: a fleet starts as a unit).  The
  first-frame min-points gate is not applied.
- Map capacity is shared (stacked states require a common capacity): the
  growth slow path rolls back and regrows the WHOLE fleet when any stream
  drops a contribution, preserving each stream's zero-loss retry semantics
  (``pipeline/submap.py`` docstrings; voxel_hash_map.hpp:121-124).
- Per-point-timestamp deskew publishing is not supported (same constraint
  as the pipelined single-stream classes, which this layer vmaps).
- Non-increasing per-stream timestamps are processed with a fallback
  dt=0.1 instead of the single-stream ``old_timestamp`` rejection (the
  fleet dispatches one program for all streams; serving clients are
  expected to feed monotone clocks).
  :class:`FleetLIO` batches the full 15-DOF inertial pipeline — per-stream
  IMU windows, preintegration, bias states — with the same program-pair
  structure.

Reference frame loops being batched: pipeline/lidar_odometry.hpp:115-298,
pipeline/lidar_inertial_odometry.hpp:131-472.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.mapping import occupancy_grid as og
from sycl_points_tpu.mapping import voxel_hash_map as vhm
from sycl_points_tpu.ops.knn import BruteForceKNN, approx_knn
from sycl_points_tpu.ops.sampling import random_sampling
from sycl_points_tpu.ops.transform import transform_cloud
from sycl_points_tpu.pipeline.fused_submap import make_submap_step
from sycl_points_tpu.pipeline.lidar_odometry import _S1, ResultType
from sycl_points_tpu.pipeline.params import LidarOdometryParams
from sycl_points_tpu.pipeline.pipelined_odometry import (
    OdomCarry,
    PipelinedLidarOdometry,
)
from sycl_points_tpu.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu.registration.map_prior import MapPriorParams


class _Pending(NamedTuple):
    """One in-flight fleet frame (stacked device handles; holding costs no
    sync)."""

    stats: jax.Array          # [B, S] fused stats, d2h transfer in flight
    sampled: PointCloud       # [B, num, 3] stashed keyframe samples
    prev_map_state: object    # stacked pre-insert map state (drop rollback)
    T_eff: jax.Array          # [B, 4, 4]
    timestamps: np.ndarray    # [B]
    dts: np.ndarray           # [B]
    frame_index: int


def _stack_tree(tree, b: int):
    """Broadcast a single-stream pytree to a stacked [B, ...] pytree."""
    return jax.tree_util.tree_map(
        lambda a: None if a is None else jnp.broadcast_to(
            a[None], (b,) + a.shape
        ),
        tree,
    )


class FleetOdometry:
    """B LiDAR odometry streams, one device program per frame."""

    def __init__(
        self,
        params: LidarOdometryParams = LidarOdometryParams(),
        n_streams: int = 4,
        map_prior_params: MapPriorParams = MapPriorParams(),
        initial_poses: Optional[np.ndarray] = None,  # [B, 4, 4]
        mesh=None,
        mesh_axis: str = "streams",
        max_in_flight: int = 16,
        seed: int = 7,
    ):
        # the template builds (and owns) the raw single-stream traceables;
        # its own jits/threads stay unused, and its single-stream map state
        # (tens of MB of HBM at serving capacities) is freed — the fleet
        # always creates its own stacked states
        t = self._make_template(params, map_prior_params)
        t.growth_precompile = False
        t.submap.map_state = None
        self._t = t
        self.params = params
        self.B = int(n_streams)
        self._max_in_flight = max(1, max_in_flight)
        self._key = jax.random.key(seed)
        self._mapmod = og if t.submap.is_occupancy else vhm
        self._s1 = self._stats1_len()

        self._shard = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._shard = NamedSharding(mesh, P(mesh_axis))

        # ---- vmapped programs (jitted once; capacity-keyed for program B)
        pc = t.pc_processor
        need_cov = getattr(t, "_needs_covariances", lambda: True)()
        k_cov = params.covariance_estimation.neighbor_num

        def _pre_fn(cloud, key):
            c = pc._prefilter_fn(cloud, key)
            if need_cov:
                knn = approx_knn(c.points, c.mask, c.points, k_cov)
                c = pc._covariances_fn(c, knn)
                c = pc._refine_fn(c, knn)
            return c

        self._pre_jit = jax.jit(jax.vmap(_pre_fn))
        self._build_reg_program(t)
        self._robust_scale = self._compute_robust_scale(t, params)
        self._submap_jits: dict = {}
        self._grow_jits: dict = {}
        self._ie_jits: dict = {}
        self._retry_target_jit = None  # built lazily (rare slow path)

        sp = params.submap
        num = sp.point_random_sampling_num
        # The fleet pins ONE extraction tier for all B streams (the vmapped
        # programs share a single target shape); pass it explicitly so the
        # template submap's tiering state can't leak into fleet programs.
        extract_cap = sp.extract_capacity
        self._extract_cap = extract_cap
        finalize = t.submap.finalize_traced
        need_finalize = t.submap._need_covs or t.submap._need_normals

        def _make_bootstrap(cfg):
            ie = self._t.submap.make_insert_extract(cfg, extract_cap)

            def _bootstrap_fn(cloud_pre, pose, key, map_state):
                # add_first_frame semantics (submapping.hpp:85-97): sample
                # into the map; the first target is the FULL preprocessed
                # cloud
                sampled = random_sampling(cloud_pre, num, key)
                new_state, _extracted, load, overflow = ie(
                    map_state, sampled, pose
                )
                tgt = transform_cloud(
                    compact_device(cloud_pre, out_capacity=extract_cap), pose
                )
                target = PointCloud(points=tgt.points, mask=tgt.mask)
                if need_finalize:
                    target = finalize(target)
                return new_state, target, jnp.stack([
                    jnp.asarray(load, jnp.float32),
                    jnp.asarray(overflow, jnp.float32),
                    jnp.asarray(new_state.dropped, jnp.float32),
                    jnp.asarray(new_state.budget_lost, jnp.float32),
                ])

            return _bootstrap_fn

        self._make_bootstrap = _make_bootstrap
        self._bootstrap_jits: dict = {}
        self._cat_jit = jax.jit(
            lambda a, b: jnp.concatenate([a, b], axis=-1)
        )

        # ---- stacked device state
        B = self.B
        if initial_poses is None:
            initial_poses = np.broadcast_to(
                np.asarray(params.pose.initial_matrix(), np.float32),
                (B, 4, 4),
            )
        self._initial_poses = np.asarray(initial_poses, np.float32)
        self.map_state = self._put(
            _stack_tree(self._mapmod.create(t.submap.map_config), B)
        )
        self.submap_cloud: Optional[PointCloud] = None
        self._carry: Optional[OdomCarry] = None

        # ---- host bookkeeping (per stream)
        self._pending: "deque[_Pending]" = deque()
        self.pose_log: List[list] = [[] for _ in range(B)]
        self.deferred_results: List[list] = [[] for _ in range(B)]
        self._dropped_seen = np.zeros(B, np.int64)
        self.extract_overflow = np.zeros(B, np.int64)
        self.budget_lost = np.zeros(B, np.int64)
        self._reconciled_until = -1
        self._load_grown_until = -1
        self.frame_count = 0
        self.growth_events: List[dict] = []
        self.processing_times = {}
        self._last_ts = None

    # ---- pipeline-specific hooks (overridden by FleetLIO) ------------------
    def _make_template(self, params, map_prior_params):
        return PipelinedLidarOdometry(params, map_prior_params)

    def _stats1_len(self) -> int:
        return _S1

    def _build_reg_program(self, t) -> None:
        self._reg_jit = jax.jit(jax.vmap(t._reg_step_fn))

    def _compute_robust_scale(self, t, params):
        # sampling-weight scale for program B (same formula as
        # LidarOdometry._build_submap_step)
        return (
            t.pipeline_params.robust.min_scale
            if t.pipeline_params.robust.auto_scale
            else params.registration.factor.robust.default_scale
        )

    # ------------------------------------------------------------------
    @property
    def map_capacity(self) -> int:
        return self._t.submap.map_capacity

    def _put(self, tree):
        if self._shard is None:
            return tree
        return jax.tree_util.tree_map(
            lambda a: None if a is None else jax.device_put(a, self._shard),
            tree,
        )

    def _cfg_at(self, capacity: int):
        """Map config at an arbitrary capacity tier (capacity is the only
        config field growth changes)."""
        import dataclasses as _dc

        return _dc.replace(self._t.submap.map_config, capacity=capacity)

    def _bootstrap_jit_for(self, capacity: int):
        fn = self._bootstrap_jits.get(capacity)
        if fn is None:
            fn = jax.jit(jax.vmap(self._make_bootstrap(self._cfg_at(capacity))))
            self._bootstrap_jits[capacity] = fn
        return fn

    def _submap_jit_for(self, capacity: int):
        fn = self._submap_jits.get(capacity)
        if fn is None:
            sm = self._t.submap
            cfg = self._cfg_at(capacity)
            raw = make_submap_step(
                self.params, sm,
                robust_scale=self._robust_scale,
                ie=sm.make_insert_extract(cfg, self._extract_cap), cfg=cfg,
            )
            fn = jax.jit(jax.vmap(raw))
            self._submap_jits[capacity] = fn
        return fn

    def _grow_jit_for(self, capacity: int):
        fn = self._grow_jits.get(capacity)
        if fn is None:
            cfg = self._cfg_at(capacity)
            mod = self._mapmod
            fn = jax.jit(jax.vmap(lambda st, _c=cfg: mod.grow(st, _c)[0]))
            self._grow_jits[capacity] = fn
        return fn

    def _ie_jit_for(self, capacity: int):
        fn = self._ie_jits.get(capacity)
        if fn is None:
            fn = jax.jit(jax.vmap(
                self._t.submap.make_insert_extract(
                    self._cfg_at(capacity), self._extract_cap
                )
            ))
            self._ie_jits[capacity] = fn
        return fn

    def precompile_growth(self, max_capacity: int) -> int:
        """Fleet analog of the pipelines' growth-ladder warm start: compile
        the vmapped grow / insert-retry / submap-step programs for every
        capacity tier up to ``max_capacity`` (growth events then swap
        programs instead of paying vmapped recompiles).  Call after at
        least one processed frame (the submap-step signature comes from the
        last dispatched frame).  Returns the number of ladder steps."""
        arg_structs = getattr(self, "_growth_ctx", None)
        if arg_structs is None:
            raise RuntimeError(
                "precompile_growth: process at least one fleet frame first"
            )
        n = 0
        cap = self.map_capacity
        while cap < max_capacity:
            state_s = jax.eval_shape(
                lambda c=self._cfg_at(cap): _stack_tree(
                    self._mapmod.create(c), self.B
                )
            )
            next_cap = cap * 2
            next_state_s = jax.eval_shape(
                lambda c=self._cfg_at(next_cap): _stack_tree(
                    self._mapmod.create(c), self.B
                )
            )
            self._grow_jit_for(cap).lower(state_s).compile()
            sampled_s, pose_s = arg_structs[0], arg_structs[3]
            self._ie_jit_for(next_cap).lower(
                next_state_s, sampled_s, pose_s
            ).compile()
            self._submap_jit_for(next_cap).lower(
                next_state_s, *arg_structs[1:]
            ).compile()
            cap = next_cap
            n += 1
        return n

    def _split_keys(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return jax.random.split(sub, self.B)

    def _init_carry(self) -> OdomCarry:
        B = self.B
        f = lambda a: jnp.asarray(a, jnp.float32)
        eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
        z3 = jnp.zeros((B, 3), jnp.float32)
        poses = f(self._initial_poses)
        return OdomCarry(
            odom=poses,
            lin_vel=z3, ang_vel=z3, lin_smooth=z3, ang_smooth=z3,
            have_smooth=jnp.zeros(B, bool),
            registrated=jnp.zeros(B, bool),
            last_kf_pose=poses,
            last_kf_time=jnp.full(B, -1.0, jnp.float32),
            prev_T=eye,
            prev_Hraw=jnp.zeros((B, 6, 6), jnp.float32),
            prev_err_raw=jnp.zeros(B, jnp.float32),
            prev_inlier=jnp.zeros(B, jnp.int32),
        )

    # ------------------------------------------------------------------
    def process_batch(
        self, clouds: PointCloud, timestamps,
    ) -> None:
        """Process one frame for every stream.  ``clouds`` is a stacked
        PointCloud with leading dimension B; ``timestamps`` is a [B] array
        (or scalar, broadcast).  Results arrive deferred in
        :attr:`pose_log` / :attr:`deferred_results` (call :meth:`flush`
        after the stream ends)."""
        B = self.B
        ts = np.broadcast_to(np.asarray(timestamps, np.float32), (B,)).copy()
        t0 = time.perf_counter()
        clouds = self._put(clouds)
        pre = self._pre_jit(clouds, self._split_keys())
        self.processing_times["1. preprocessing"] = time.perf_counter() - t0

        if self._carry is None:
            self._bootstrap_streams(pre, ts)
            return

        dts = np.where(
            ts > self._last_ts, ts - self._last_ts, np.float32(0.1)
        ).astype(np.float32)
        self._last_ts = ts

        # ---- program A (stacked): predict + align + keyframe ----
        t0 = time.perf_counter()
        cloud_for_submap, T_eff, is_kf, s1 = self._run_reg(pre, ts, dts)
        self.processing_times["3. registration"] = time.perf_counter() - t0
        self._dispatch_submap(cloud_for_submap, T_eff, is_kf, s1, ts, dts)

    def _bootstrap_streams(self, pre: PointCloud, ts: np.ndarray) -> None:
        """Fleet bootstrap: all streams' first frame together, with the
        same grow-and-retry-the-SAME-insert semantics as add_first_frame
        (the pre-insert state is empty, so a retry on a recreated larger
        empty table loses nothing)."""
        t0 = time.perf_counter()
        poses = jnp.asarray(self._initial_poses)
        keys = self._split_keys()  # fixed across retries: same samples
        for attempt in range(9):
            boot = self._bootstrap_jit_for(self.map_capacity)
            new_state, target, stats0 = boot(pre, poses, keys, self.map_state)
            s0 = np.asarray(stats0)
            if (s0[:, 2] == 0).all() or attempt == 8:
                break
            sm = self._t.submap
            if sm.is_occupancy:
                sm.og_config = sm.peek_grown_config()
            else:
                sm.vhm_config = sm.peek_grown_config()
            sm.version += 1
            self.growth_events.append(
                {"frame": 0, "capacity": sm.map_capacity}
            )
            self.map_state = self._put(_stack_tree(
                self._mapmod.create(sm.map_config), self.B
            ))
        self.map_state = new_state
        self.submap_cloud = target
        self._carry = self._init_carry()
        self._post_bootstrap(ts)
        self._dropped_seen = s0[:, 2].astype(np.int64)
        self.extract_overflow = s0[:, 1].astype(np.int64)
        self.budget_lost = s0[:, 3].astype(np.int64)
        if float(s0[:, 0].max()) > 0.7:
            self._grow_fleet()
        self._last_ts = ts
        self.frame_count += 1
        self.processing_times["4a. submap dispatch"] = time.perf_counter() - t0

    def _post_bootstrap(self, ts: np.ndarray) -> None:
        """Extra per-pipeline state init after the fleet bootstrap."""

    def _run_reg(self, pre: PointCloud, ts: np.ndarray, dts: np.ndarray):
        """Dispatch program A; returns (cloud_for_submap, T_eff, is_kf, s1)."""
        host_vec = jnp.asarray(np.stack([dts, ts], axis=1))  # [B, 2]
        knn = BruteForceKNN(
            points=self.submap_cloud.points, mask=self.submap_cloud.mask,
        )
        result, deskewed, T_eff, is_kf, new_carry, s1 = self._reg_jit(
            pre, self.submap_cloud, knn, self._carry, host_vec
        )
        self._carry = new_carry
        return deskewed, T_eff, is_kf, s1

    def _dispatch_submap(self, cloud_for_submap, T_eff, is_kf, s1,
                         ts: np.ndarray, dts: np.ndarray) -> None:
        """Program B (stacked keyframe submap update) + async stats fetch +
        adaptive drain — shared by both fleet pipelines."""
        t0 = time.perf_counter()
        prev_map_state = self.map_state
        submap_fn = self._submap_jit_for(self.map_capacity)
        keys_b = self._split_keys()
        new_map_state, new_submap, sampled, s2 = submap_fn(
            prev_map_state, self.submap_cloud, cloud_for_submap, T_eff,
            is_kf, keys_b
        )
        # growth-ladder compile signature: (sampled | submap-step args
        # after the state) — see precompile_growth
        self._growth_ctx = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
            (sampled, self.submap_cloud, cloud_for_submap, T_eff, is_kf, keys_b),
        )
        self.map_state = new_map_state
        self.submap_cloud = new_submap
        stats = self._cat_jit(s1, s2)
        stats.copy_to_host_async()
        self._pending.append(_Pending(
            stats=stats, sampled=sampled, prev_map_state=prev_map_state,
            T_eff=T_eff, timestamps=ts, dts=dts,
            frame_index=self.frame_count,
        ))
        self.processing_times["4a. submap dispatch"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        while self._pending and (
            len(self._pending) > self._max_in_flight
            or self._pending[0].stats.is_ready()
        ):
            self._resolve_one(self._pending.popleft())
        self.processing_times["4b. stats fetch"] = time.perf_counter() - t0
        self.frame_count += 1

    # ------------------------------------------------------------------
    def _stream_result_types(self, stats: np.ndarray) -> list:
        """Per-stream ResultType from the stats1 block (LO layout)."""
        small = stats[:, 21] > 0.5
        return [
            ResultType.small_number_of_points if small[b]
            else ResultType.success
            for b in range(self.B)
        ]

    def _kf_col(self) -> int:
        """stats1 column of the is_kf flag (LO layout)."""
        return 20

    def _resolve_one(self, pend: _Pending) -> None:
        stats = np.asarray(pend.stats)  # [B, S]
        B = self.B
        s1 = self._s1
        T_np = stats[:, :16].reshape(B, 4, 4).astype(np.float32)
        load = stats[:, s1 + 0]
        overflow = stats[:, s1 + 1]
        dropped = stats[:, s1 + 3].astype(np.int64)
        budget_lost = stats[:, s1 + 4].astype(np.int64)

        rtypes = self._stream_result_types(stats)
        for b in range(B):
            self.deferred_results[b].append((pend.frame_index, rtypes[b]))
            self.pose_log[b].append(
                (pend.frame_index, float(pend.timestamps[b]), T_np[b], rtypes[b])
            )
        # per-insert telemetry: only keyframe streams ran extraction, so a
        # non-keyframe stream's stats2 overflow=0 must not zero its mirror
        kf = stats[:, self._kf_col()] > 0.5
        self.extract_overflow = np.where(
            kf, overflow.astype(np.int64), self.extract_overflow
        )
        self.budget_lost = budget_lost

        if pend.frame_index <= self._reconciled_until:
            return
        deltas = dropped - self._dropped_seen
        if (deltas > 0).any():
            self._retry_after_drop(pend)
            return
        self._dropped_seen = dropped
        if float(load.max()) > 0.7 and pend.frame_index > self._load_grown_until:
            self._grow_fleet()
            self._load_grown_until = (
                self._pending[-1].frame_index if self._pending
                else pend.frame_index
            )

    # ------------------------------------------------------------------
    def _grow_state(self, state):
        """Stacked analog of Submap._grow_map: returns the grown state and
        advances the shared (template-submap-owned) config in lockstep."""
        sm = self._t.submap
        grown = self._grow_jit_for(sm.map_capacity)(state)
        if sm.is_occupancy:
            sm.og_config = sm.peek_grown_config()
        else:
            sm.vhm_config = sm.peek_grown_config()
        sm.version += 1
        self.growth_events.append(
            {"frame": self.frame_count, "capacity": sm.map_capacity}
        )
        return grown

    def _grow_fleet(self) -> None:
        self.map_state = self._grow_state(self.map_state)

    def _retry_after_drop(self, pend: _Pending) -> None:
        """Fleet growth slow path: roll every stream back to this frame's
        pre-insert state, grow the WHOLE fleet, re-run the SAME stacked
        insert (zero-loss per stream: the retry always starts from the
        rolled-back pre-insert base, as in Submap.retry_insert_after_drop),
        then re-apply every later in-flight frame's stashed samples."""
        base = pend.prev_map_state
        max_grow = 8
        for attempt in range(max_grow):
            base = self._grow_state(base)
            ie = self._ie_jit_for(self.map_capacity)
            new_state, extracted, _load, overflow = ie(
                base, pend.sampled, pend.T_eff
            )
            no_new = (
                np.asarray(new_state.dropped, np.int64)
                == np.asarray(base.dropped, np.int64)
            ).all()
            if no_new or attempt == max_grow - 1:
                break
        self.map_state = new_state
        self.extract_overflow = np.asarray(overflow).astype(np.int64)

        for later in self._pending:
            # re-apply with the same grow-on-new-drop retry (the stashed
            # insert usually fits after the first growth, but must never be
            # committed while dropping — Submap.retry_insert_after_drop's
            # grow_first=False semantics)
            base2 = self.map_state
            for attempt in range(max_grow):
                ie = self._ie_jit_for(self.map_capacity)
                new_state, extracted, _load, overflow = ie(
                    base2, later.sampled, later.T_eff
                )
                no_new = (
                    np.asarray(new_state.dropped, np.int64)
                    == np.asarray(base2.dropped, np.int64)
                ).all()
                if no_new or attempt == max_grow - 1:
                    break
                base2 = self._grow_state(base2)
            self.map_state = new_state
            self._reconciled_until = later.frame_index
        self._reconciled_until = max(self._reconciled_until, pend.frame_index)
        self._dropped_seen = np.asarray(self.map_state.dropped, np.int64)

        # rebuild the fleet registration target from the LAST re-applied
        # insert's extraction, so later in-flight keyframe contributions are
        # included (mirrors the single-stream slow path, which rebuilds the
        # target on every re-apply)
        self._rebuild_target(extracted)

    def _rebuild_target(self, extracted: PointCloud) -> None:
        min_pts = self.params.registration.min_num_points
        sm = self._t.submap
        need_finalize = sm._need_covs or sm._need_normals
        finalize = sm.finalize_traced

        if self._retry_target_jit is None:
            def _choose(extracted, old):
                ok = extracted.count() >= min_pts
                tgt = PointCloud(
                    points=jnp.where(ok, extracted.points, old.points),
                    mask=jnp.where(ok, extracted.mask, old.mask),
                )
                return finalize(tgt) if need_finalize else tgt

            self._retry_target_jit = jax.jit(jax.vmap(_choose))
        old = PointCloud(
            points=self.submap_cloud.points, mask=self.submap_cloud.mask
        )
        self.submap_cloud = self._retry_target_jit(extracted, old)

    # ------------------------------------------------------------------
    def flush(self) -> None:
        while self._pending:
            self._resolve_one(self._pending.popleft())

    def get_odometry(self, stream: int) -> np.ndarray:
        """Latest RESOLVED pose of one stream."""
        log = self.pose_log[stream]
        return log[-1][2].copy() if log else self._initial_poses[stream].copy()


class FleetLIO(FleetOdometry):
    """B tightly-coupled 15-DOF LIO streams, one program pair per frame.

    The vmapped analog of :class:`PipelinedLidarInertialOdometry`: per
    stream the full inertial chain — parallel-prefix preintegration of its
    own IMU window, prediction with reset sigma floors, the 15-DOF LIO
    align, bias clamps, the IMU-only fallback on small frames and the
    non-finite guard — runs inside program A; program B is the shared fleet
    submap update.  Per-stream IMU windows are padded to a common
    power-of-two step bucket and stacked into one ``[B, S, 14]`` payload
    (one h2d transfer for the whole fleet's inertial data).

    Constraints (same as the pipelined single-stream class): IMU deskew and
    initial alignment must be disabled; streams share one parameter set and
    bootstrap together.  Reference flagship being batched:
    pipeline/lidar_inertial_odometry.hpp:131-472.
    """

    def __init__(self, params=None, n_streams: int = 4, **kwargs):
        from sycl_points_tpu.pipeline.params import LidarInertialOdometryParams

        params = params if params is not None else LidarInertialOdometryParams()
        if params.imu.initial_alignment.enable:
            raise ValueError(
                "FleetLIO requires imu.initial_alignment.enable=False "
                "(the alignment handshake is host-per-stream; use the "
                "single-stream pipelines)"
            )
        super().__init__(params, n_streams, **kwargs)
        B = self.B
        self._imu_buffers = [deque() for _ in range(B)]
        self._last_reset = np.full(B, -1.0, np.float64)
        self.x = None  # stacked 15-DOF State, set at bootstrap
        self.P = None  # [B, 15, 15]
        self.gyro_bias_np = np.zeros((B, 3), np.float32)
        self.accel_bias_np = np.zeros((B, 3), np.float32)
        self.velocity_np = np.zeros((B, 3), np.float32)

    # ---- hooks -------------------------------------------------------------
    def _make_template(self, params, map_prior_params):
        from sycl_points_tpu.pipeline.pipelined_lio import (
            PipelinedLidarInertialOdometry,
        )

        return PipelinedLidarInertialOdometry(params)

    def _stats1_len(self) -> int:
        from sycl_points_tpu.pipeline.lidar_inertial_odometry import _S1 as S1_LIO

        return S1_LIO

    def _build_reg_program(self, t) -> None:
        self._lio_jit = jax.jit(jax.vmap(t._lio_step_fn))

    def _compute_robust_scale(self, t, params):
        return None  # LIO convention (fused_submap robust_scale=None)

    def _init_carry(self):
        from sycl_points_tpu.pipeline.pipelined_lio import LIOCarry

        poses = jnp.asarray(self._initial_poses)
        return LIOCarry(
            last_kf_pose=poses,
            last_kf_time=jnp.full(self.B, -1.0, jnp.float32),
        )

    def _post_bootstrap(self, ts: np.ndarray) -> None:
        t, B = self._t, self.B
        poses = jnp.asarray(self._initial_poses)
        x0 = _stack_tree(t.x, B)
        self.x = x0._replace(
            position=poses[:, :3, 3],
            rotation=poses[:, :3, :3],
            velocity=jnp.zeros((B, 3), jnp.float32),
        )
        self.P = _stack_tree(t.P_post, B)
        self._last_reset = ts.astype(np.float64).copy()

    # ---- IMU input (per stream) ---------------------------------------------
    def add_imu_measurement(self, stream: int, meas) -> None:
        buf = self._imu_buffers[stream]
        buf.append(meas)
        horizon = meas.timestamp - self.params.imu.buffer_duration_sec
        while buf and buf[0].timestamp < horizon:
            buf.popleft()

    # ---- program A ----------------------------------------------------------
    def _run_reg(self, pre: PointCloud, ts: np.ndarray, dts: np.ndarray):
        from sycl_points_tpu.imu.preintegration import (
            build_measurement_window,
            pack_steps,
            padded_steps_from_window,
        )

        packs = []
        for b in range(self.B):
            w = build_measurement_window(
                list(self._imu_buffers[b]),
                float(self._last_reset[b]), float(ts[b]),
            )
            packs.append(pack_steps(*padded_steps_from_window(w)))
        S = max(p.shape[0] for p in packs)
        packs = [np.pad(p, ((0, S - p.shape[0]), (0, 0))) for p in packs]
        imu_pack = jnp.asarray(np.stack(packs))  # [B, S, 14]
        # [timestamp, update_bias] per stream (bias always observable here,
        # lidar_inertial_odometry.hpp:371-393 reference default)
        host_vec = jnp.asarray(
            np.stack([ts, np.ones(self.B, np.float32)], axis=1)
        )
        knn = BruteForceKNN(
            points=self.submap_cloud.points, mask=self.submap_cloud.mask,
        )
        x_new, P_new, reg_input, T_eff, is_kf, new_carry, s1 = self._lio_jit(
            pre, self.submap_cloud, knn, self.x, self.P, imu_pack,
            self._carry, host_vec, self._split_keys(),
        )
        self.x, self.P, self._carry = x_new, P_new, new_carry
        self._last_reset = ts.astype(np.float64).copy()
        return reg_input, T_eff, is_kf, s1

    # ---- resolve ------------------------------------------------------------
    def _stream_result_types(self, stats: np.ndarray) -> list:
        from sycl_points_tpu.pipeline.lidar_inertial_odometry import (
            ResultType as LIOResult,
        )

        small = stats[:, 20] > 0.5
        finite = stats[:, 21] > 0.5
        # bias/velocity host mirrors (telemetry; device state chains)
        self.gyro_bias_np = stats[:, 25:28].astype(np.float32)
        self.accel_bias_np = stats[:, 28:31].astype(np.float32)
        self.velocity_np = stats[:, 31:34].astype(np.float32)
        out = []
        for b in range(self.B):
            if not finite[b]:
                out.append(LIOResult.error)
            elif small[b]:
                out.append(LIOResult.imu_only)
            else:
                out.append(LIOResult.success)
        return out

    def _kf_col(self) -> int:
        return 19  # LIO stats1 layout
