"""Submap management: keyframing + map insertion + target preparation.

Replaces ``pipeline/submapping.hpp:18-248`` of fateshelled/sycl_points:
keyframe policy (distance >= 2 m OR angle >= 20 deg OR dt >= 1 s; always for
the occupancy backend; inlier-ratio gate), per-keyframe weighted/uniform
sampling to ``point_random_sampling_num`` points, insertion into the
VoxelHashMap or OccupancyGridMap, submap extraction within range, KNN
structure rebuild and covariance/normal estimation per registration-type
needs.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.mapping import occupancy_grid as og
from sycl_points_tpu.mapping import voxel_hash_map as vhm
from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.knn import (
    BruteForceKNN,
    approx_knn,
    brute_force_knn,
    build_target_knn,
)
from sycl_points_tpu.ops.sampling import mixed_sampling, random_sampling
from sycl_points_tpu.ops.transform import transform_cloud
from sycl_points_tpu.points.point_cloud import PointCloud, compact_device
from sycl_points_tpu.pipeline.params import CommonParameters
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.utils import lie_np


class Submap:
    def __init__(self, params: CommonParameters):
        self.params = params
        sp = params.submap
        self.is_occupancy = sp.map_type.upper() == "OCCUPANCY_GRID_MAP"
        if self.is_occupancy:
            ogp = sp.occupancy_grid_map
            self.og_config = og.OccupancyGridConfig(
                voxel_size=sp.voxel_size,
                capacity=sp.map_capacity,
                log_odds_hit=ogp.log_odds_hit,
                log_odds_miss=ogp.log_odds_miss,
                min_log_odds=ogp.log_odds_limits_min,
                max_log_odds=ogp.log_odds_limits_max,
                occupancy_threshold_log_odds=og.probability_to_log_odds(ogp.occupied_threshold),
                stale_frame_threshold=ogp.stale_frame_threshold,
                free_space_updates_enabled=ogp.enable_free_space_updates,
                free_space_update_cycle=ogp.free_space_update_cycle,
                voxel_pruning_enabled=ogp.enable_pruning,
            )
            self.map_state = og.create(self.og_config)
        else:
            self.vhm_config = vhm.VoxelHashMapConfig(
                voxel_size=sp.voxel_size, capacity=sp.map_capacity,
                max_staleness=sp.max_staleness,
                remove_old_data_cycle=sp.remove_old_data_cycle,
            )
            self.map_state = vhm.create(self.vhm_config)

        initial = np.asarray(params.pose.initial_matrix())
        self.last_keyframe_pose = initial
        self.last_keyframe_time = -1.0
        self.keyframe_poses: List[np.ndarray] = [initial]
        self._key = jax.random.key(4321)

        self.submap_cloud: Optional[PointCloud] = None
        self.submap_knn: Optional[BruteForceKNN] = None
        self.last_keyframe_cloud: Optional[PointCloud] = None
        # Telemetry (no silent caps): in-range voxels that did not fit the
        # extract capacity on the latest insert, and cumulative fixed-budget
        # losses (not growth-fixable, see mapping backends).
        self.extract_overflow = 0
        self.budget_lost = 0
        # Extract capacity TIERS with map growth: params.extract_capacity is
        # the BASE tier; when the map doubles, the extraction budget follows
        # at the same ratio (and the overflow counter triggers direct growth
        # as a backstop, see resolve_extract_overflow).  A static budget
        # silently truncated the submap target once the in-range voxel count
        # outgrew it (the r3 pipelined growth replay's 2x ATE regression).
        self.extract_capacity = sp.extract_capacity
        self._extract_ratio = max(1, sp.map_capacity // sp.extract_capacity)
        self._extract_growth = getattr(sp, "extract_capacity_growth", True)
        self._extract_cache: dict = {}

        reg_type = params.registration.factor.reg_type
        self._need_covs = (
            reg_type in (RegType.GICP, RegType.POINT_TO_DISTRIBUTION, RegType.GENZ)
            or params.registration.factor.rotation_constraint.enable
        )
        self._need_normals = reg_type in (RegType.POINT_TO_PLANE, RegType.GENZ)

        # Cached jitted per-keyframe kernels (eager composites are slow on
        # some runtimes and would re-dispatch dozens of ops per keyframe).
        # Growth programs are jit-cached per capacity (an eager grow() call
        # recompiles its embedded loops EVERY call) and both
        # caches accept entries published by the background growth
        # precompile (fused_submap.start_growth_precompile).
        sp_ = params.submap
        self._grow_cache: dict = {}
        self._prebuilt_ie: dict = {}
        self._chain_cache: dict = {}
        # compile/retrace event log (what the growth paths pay for): every
        # jit-cache MISS and every growth-path host block appends a row;
        # benches snapshot it per growth event (r4 verdict ask 6: name the
        # program that still compiles at the 10 s growth stalls)
        self.compile_log: list = []
        self._rebuild_insert_extract()
        self._sample_uniform = jax.jit(
            lambda cl, key: random_sampling(cl, sp_.point_random_sampling_num, key)
        )
        self._sample_mixed = jax.jit(
            lambda cl, w, key: mixed_sampling(
                cl, sp_.point_random_sampling_num, w, key, sp_.weighted_sampling_ratio
            )
        )
        # First-frame target is normalized to the same attribute structure as
        # later map extractions (points + mask only, before finalize): a
        # structure change between frame 1 and 2 would retrace the cached
        # align program.  Cached per extract tier — bootstrap growth can
        # tier the extraction budget up before the first target is built.
        self._first_cache: dict = {}
        self._finalize_jit = jax.jit(self.finalize_traced)

    def first_target_fn_for(self, ext_cap: int):
        fn = self._first_cache.get(ext_cap)
        if fn is None:
            def _first(cl, pose):
                c = transform_cloud(compact_device(cl, out_capacity=ext_cap), pose)
                return PointCloud(points=c.points, mask=c.mask)

            fn = jax.jit(_first)
            self._first_cache[ext_cap] = fn
        return fn

    def _first_target(self, cl, pose):
        return self.first_target_fn_for(self.extract_capacity)(cl, pose)

    # ------------------------------------------------------------------
    def make_insert_extract(self, cfg, ext_cap: Optional[int] = None):
        """Build the insert+extract traceable for an ARBITRARY map config and
        extraction capacity (pure closure over ``cfg``/``ext_cap``; does not
        touch mutable state — safe to call from the background
        growth-precompile thread).  ``ext_cap=None`` uses the CURRENT tiered
        extract capacity."""
        sp_ = self.params.submap
        ext = self.extract_capacity if ext_cap is None else ext_cap
        if self.is_occupancy:
            def _ie(st, cl, pose):
                ns = og.add_point_cloud(st, cfg, cl, pose)
                extracted, overflow = og.extract_occupied_points(
                    ns, cfg, pose[:3, 3],
                    sp_.max_distance_range, out_capacity=ext,
                    with_overflow=True,
                )
                return ns, extracted, og.load_factor(ns, cfg), overflow
        else:
            def _ie(st, cl, pose):
                ns = vhm.add_point_cloud(st, cfg, cl, pose)
                # staleness pruning every remove_old_data_cycle inserts
                # (voxel_hash_map.hpp:134-140)
                if cfg.remove_old_data_cycle > 0:
                    ns = jax.lax.cond(
                        ns.frame % cfg.remove_old_data_cycle == 0,
                        lambda s: vhm.remove_old_data(s, cfg),
                        lambda s: s,
                        ns,
                    )
                extracted, overflow = vhm.extract(
                    ns, cfg, pose[:3, 3],
                    sp_.max_distance_range, out_capacity=ext,
                    with_covs=False, with_overflow=True,
                )
                return ns, extracted, vhm.load_factor(ns, cfg), overflow
        return _ie

    def make_extract_only(self, cfg, ext_cap: int):
        """Extraction-only traceable (no insert): used by the
        extract-overflow slow path to re-extract the submap target at a
        grown budget from an already-committed map state."""
        sp_ = self.params.submap
        if self.is_occupancy:
            def _ex(st, origin):
                return og.extract_occupied_points(
                    st, cfg, origin, sp_.max_distance_range,
                    out_capacity=ext_cap, with_overflow=True,
                )
        else:
            def _ex(st, origin):
                return vhm.extract(
                    st, cfg, origin, sp_.max_distance_range,
                    out_capacity=ext_cap, with_covs=False, with_overflow=True,
                )
        return _ex

    def extract_fn_for(self, cfg, ext_cap: int):
        """Jitted extraction-only program, cached per (capacity, ext_cap);
        also fed by the growth-ladder precompile."""
        key = (cfg.capacity, ext_cap)
        fn = self._extract_cache.get(key)
        if fn is None:
            self.compile_log.append({"what": "extract_jit_miss", "key": key})
            fn = jax.jit(self.make_extract_only(cfg, ext_cap))
            self._extract_cache[key] = fn
        return fn

    @property
    def map_config(self):
        return self.og_config if self.is_occupancy else self.vhm_config

    def peek_grown_config(self):
        """The config a growth WOULD produce (matches og/vhm.grow)."""
        import dataclasses as _dc

        cfg = self.map_config
        return _dc.replace(cfg, capacity=cfg.capacity * 2)

    def _rebuild_insert_extract(self):
        """(Re)build the insert+extract closure for the CURRENT map config —
        called at init and after every capacity growth.  The fused call also
        returns the post-insert load factor so the host growth policy needs
        no extra device round trip.  ``insert_extract_fn`` is the raw
        traceable function (embedded in the fused per-frame program by
        LidarOdometry); ``version`` lets dependents notice growth re-jits.
        """
        self.insert_extract_fn = self.make_insert_extract(self.map_config)
        key = (self.map_capacity, self.extract_capacity)
        cached = self._prebuilt_ie.get(key)
        if cached is None:
            self.compile_log.append({"what": "insert_extract_jit_miss", "key": key})
        self._insert_extract = (
            cached if cached is not None else jax.jit(self.insert_extract_fn)
        )
        self.version = getattr(self, "version", 0) + 1

    def grow_fn_for(self, cfg):
        """Jitted state-only grow program for ``cfg.capacity -> 2x``, cached
        per capacity (also fed by the background growth precompile)."""
        fn = self._grow_cache.get(cfg.capacity)
        if fn is None:
            self.compile_log.append({"what": "grow_jit_miss", "key": cfg.capacity})
            mod = og if self.is_occupancy else vhm
            fn = jax.jit(lambda st, _c=cfg: mod.grow(st, _c)[0])
            self._grow_cache[cfg.capacity] = fn
        return fn

    def extract_tier_for(self, map_capacity: int) -> int:
        """The extract capacity the tiering policy pairs with a map capacity:
        the base budget scaled by the same growth factor as the map.  Never
        shrinks (program shapes only ever widen — below the current tier a
        direct overflow-triggered growth may already have passed it)."""
        if not self._extract_growth:
            return self.extract_capacity
        tier = max(
            self.params.submap.extract_capacity,
            map_capacity // self._extract_ratio,
        )
        return max(tier, self.extract_capacity)

    def _grow_map(self, reextract: bool = True, origin=None):
        """Double the map capacity in place (reference rehash policy,
        voxel_hash_map.hpp:847-934) and re-jit the per-keyframe kernels.
        The extract capacity tiers up with it (extract_tier_for); when the
        tier changes, the submap target is re-extracted at the new shape so
        the fused per-frame programs (whose ``submap_prev`` operand shape is
        the extraction budget) stay consistent.  Callers whose own loop
        re-runs an extraction right after pass ``reextract=False``.

        ``origin`` (a [3] position or [4,4] pose) centers the re-extraction;
        pipelines pass the CURRENT frame pose — ``last_keyframe_pose`` is
        stale in occupancy-grid mode (keyframe bookkeeping is VHM-only,
        submapping.hpp:99-121) and a far-traveled stream would otherwise
        rebuild the target around the wrong center."""
        import time as _time

        _t0 = _time.perf_counter()
        cfg = self.map_config
        self.map_state = self.grow_fn_for(cfg)(self.map_state)
        if self.is_occupancy:
            self.og_config = self.peek_grown_config()
        else:
            self.vhm_config = self.peek_grown_config()
        old_ext = self.extract_capacity
        self.extract_capacity = self.extract_tier_for(self.map_capacity)
        self._rebuild_insert_extract()
        if reextract and self.extract_capacity != old_ext and self.submap_cloud is not None:
            self._reextract_target(
                self.last_keyframe_pose if origin is None else origin
            )
        self.compile_log.append({
            "what": "grow_map_total", "key": self.map_capacity,
            "ms": round((_time.perf_counter() - _t0) * 1e3, 1),
        })

    def grow_extract_capacity(self) -> None:
        """Double the extraction budget directly (overflow-triggered backstop
        for when the in-range voxel count outgrows the tier without the map
        itself growing) and re-jit the per-keyframe kernels."""
        self.extract_capacity = self.extract_capacity * 2
        self._rebuild_insert_extract()

    def _reextract_target(self, origin) -> None:
        """Re-extract the submap target from the committed map state at the
        CURRENT extract capacity and rebuild the correspondence structure
        (slow path: one device sync).  When the extraction comes up short of
        ``min_num_points``, the previous target is kept, mask-padded to the
        new capacity, so program shapes still match."""
        import time as _time

        _t0 = _time.perf_counter()
        origin = np.asarray(origin, np.float32)
        if origin.shape == (4, 4):
            origin = origin[:3, 3]
        ex = self.extract_fn_for(self.map_config, self.extract_capacity)
        extracted, overflow = ex(self.map_state, jnp.asarray(origin))
        self.extract_overflow = int(overflow)
        if (
            int(extracted.count()) >= self.params.registration.min_num_points
            or self.submap_cloud is None
        ):
            target = PointCloud(points=extracted.points, mask=extracted.mask)
        else:
            prev = self.submap_cloud
            pad = self.extract_capacity - prev.capacity
            if pad < 0:  # capacities never shrink, but stay safe
                target = PointCloud(points=extracted.points, mask=extracted.mask)
            else:
                target = PointCloud(
                    points=jnp.concatenate(
                        [prev.points, jnp.zeros((pad, 3), prev.points.dtype)]
                    ),
                    mask=jnp.concatenate(
                        [prev.mask, jnp.zeros((pad,), prev.mask.dtype)]
                    ),
                )
        self.submap_cloud = self._finalize_target(target)
        self.submap_knn = build_target_knn(
            self.submap_cloud,
            max_correspondence_distance=(
                self.params.registration.factor.max_correspondence_distance
            ),
        )
        self.compile_log.append({
            "what": "reextract_total", "key": self.extract_capacity,
            "ms": round((_time.perf_counter() - _t0) * 1e3, 1),
        })

    def resolve_extract_overflow(self, origin, max_grow: int = 6) -> bool:
        """Slow path: the latest extraction overflowed its budget — grow the
        extract capacity and RE-extract the submap target from the committed
        map state around ``origin`` (a [3] position or [4,4] pose) until the
        in-range set fits.  Re-jits the fused per-frame programs via the
        version bump; host syncs here are fine (once per tier).  Returns
        True when the target was rebuilt."""
        if not self._extract_growth or self.extract_overflow <= 0:
            return False
        changed = False
        for _ in range(max_grow):
            if self.extract_overflow <= 0 or self.extract_capacity >= self.map_capacity:
                break
            self.grow_extract_capacity()
            self._reextract_target(origin)
            changed = True
        return changed

    @property
    def map_capacity(self) -> int:
        return (self.og_config if self.is_occupancy else self.vhm_config).capacity

    # ------------------------------------------------------------------
    def add_first_frame(self, cloud: PointCloud, timestamp: float, current_pose: np.ndarray):
        """submapping.hpp:85-97."""
        self.last_keyframe_pose = np.asarray(current_pose)
        self.keyframe_poses = [self.last_keyframe_pose]
        self._build_submap(cloud, self.last_keyframe_pose, is_first_frame=True)
        self.last_keyframe_time = timestamp

    def add_frame(
        self,
        cloud: PointCloud,
        reg_T: np.ndarray,
        reg_result,
        inlier_ratio: float,
        timestamp: float,
        sampling_weights=None,
    ) -> bool:
        """submapping.hpp:99-121: inlier gate, keyframe policy, insertion."""
        kf = self.params.submap.keyframe
        if kf.inlier_ratio_threshold > 0.0 and inlier_ratio <= kf.inlier_ratio_threshold:
            return False
        if self.is_occupancy:
            self._build_submap(cloud, reg_T, False, sampling_weights)
            return True
        if self._is_keyframe(reg_T, timestamp):
            self.last_keyframe_pose = np.asarray(reg_T)
            self.last_keyframe_time = timestamp
            self.keyframe_poses.append(self.last_keyframe_pose)
            self._build_submap(cloud, reg_T, False, sampling_weights)
            return True
        return False

    # ------------------------------------------------------------------
    def _is_keyframe(self, T: np.ndarray, timestamp: float) -> bool:
        delta = np.linalg.inv(self.last_keyframe_pose) @ np.asarray(T)
        dist = float(np.linalg.norm(delta[:3, 3]))
        tw = lie_np.se3_log(delta)  # host math: no per-frame device round trip
        angle = float(np.linalg.norm(tw[:3])) * 180.0 / np.pi
        dt = (
            timestamp - self.last_keyframe_time
            if self.last_keyframe_time > 0.0
            else float("inf")
        )
        kf = self.params.submap.keyframe
        return (
            dist >= kf.distance_threshold
            or angle >= kf.angle_threshold_degrees
            or dt >= kf.time_threshold_seconds
        )

    def _build_submap(self, cloud, pose, is_first_frame, weights=None):
        """submapping.hpp:163-247: sample -> insert -> extract -> KNN/cov."""
        self._key, k1 = jax.random.split(self._key)
        if weights is not None:
            sampled = self._sample_mixed(cloud, weights, k1)
        else:
            sampled = self._sample_uniform(cloud, k1)
        self.last_keyframe_cloud = sampled
        pose_j = jnp.asarray(pose, dtype=jnp.float32)

        # Insert with the reference growth policy: retry the SAME insert on a
        # doubled table if any contribution was dropped on PROBE EXHAUSTION
        # (pre-insert state is kept, so nothing is lost), then grow
        # proactively when post-insert load exceeds 0.7
        # (voxel_hash_map.hpp:121-124, 847-934).  Fixed-budget losses
        # (``budget_lost``: miss-merge budget, extent/coordinate range) do
        # NOT trigger growth — they recur at any capacity and are surfaced
        # as telemetry instead.  The loop structure keeps state and compiled
        # config in lockstep: growth mutates ``self.map_state`` (pre-insert,
        # rehashed) together with the config and re-jits, and the insert is
        # always re-run afterwards — the final committed ``new_state`` came
        # from a table whose capacity matches the current config.
        max_grow = 8
        for attempt in range(max_grow + 1):
            new_state, extracted, load, extract_overflow = self._insert_extract(
                self.map_state, sampled, pose_j
            )
            if (
                int(new_state.dropped) == int(self.map_state.dropped)
                or attempt == max_grow
            ):
                break
            self._grow_map(reextract=False)
        self.map_state = new_state
        self.extract_overflow = int(extract_overflow)
        self.budget_lost = int(new_state.budget_lost)

        target = None
        if is_first_frame:
            target = self._first_target(cloud, pose_j)
        elif int(extracted.count()) >= self.params.registration.min_num_points:
            target = extracted
        elif (
            self.submap_cloud is not None
            and self.submap_cloud.capacity != self.extract_capacity
        ):
            # keep-previous fallback, but the grow-retry loop changed the
            # extract tier: re-pad the kept target to the new shape so the
            # re-jitted programs' operand shapes agree (mirrors
            # retry_insert_after_drop's capacity-mismatch guard)
            self._reextract_target(np.asarray(pose))
        else:
            target = self.submap_cloud  # keep the previous submap

        if target is not None:
            self.submap_cloud = self._finalize_target(target)
            # Auto-select brute-force vs grid buckets by target size; grid
            # cell size = the ICP correspondence gate, so results are exact
            # for registration (see ops.knn.build_target_knn).
            self.submap_knn = build_target_knn(
                self.submap_cloud,
                max_correspondence_distance=(
                    self.params.registration.factor.max_correspondence_distance
                ),
            )
        if not is_first_frame and self.extract_overflow > 0:
            self.resolve_extract_overflow(np.asarray(pose))
        if float(load) > 0.7:
            self._grow_map(origin=np.asarray(pose))

    def retry_insert_after_drop(self, sampled: PointCloud, pose_np,
                                grow_first: bool = True) -> None:
        """Slow-path growth retry for the fused frame step: the caller
        restored the pre-insert ``map_state`` after observing probe-exhaustion
        drops, so growing and re-running the SAME insert loses nothing
        (reference rehash-under-load, voxel_hash_map.hpp:121-124, 847-934).
        Host syncs here are fine — drops are rare by construction.

        ``grow_first=False`` tries the insert at the current capacity before
        growing (used by the pipelined drop-retry to re-apply the stashed
        clouds of later in-flight frames, which usually fit after the first
        growth)."""
        pose_j = jnp.asarray(pose_np, dtype=jnp.float32)
        max_grow = 8
        for attempt in range(max_grow):
            if grow_first or attempt > 0:
                self._grow_map(reextract=False)
            new_state, extracted, load, overflow = self._insert_extract(
                self.map_state, sampled, pose_j
            )
            if (
                int(new_state.dropped) == int(self.map_state.dropped)
                or attempt == max_grow - 1
            ):
                break
        self.map_state = new_state
        self.extract_overflow = int(overflow)
        self.budget_lost = int(new_state.budget_lost)
        if int(extracted.count()) >= self.params.registration.min_num_points:
            target = PointCloud(points=extracted.points, mask=extracted.mask)
            self.submap_cloud = self._finalize_target(target)
            self.submap_knn = build_target_knn(
                self.submap_cloud,
                max_correspondence_distance=(
                    self.params.registration.factor.max_correspondence_distance
                ),
            )
        elif (
            self.submap_cloud is not None
            and self.submap_cloud.capacity != self.extract_capacity
        ):
            # extraction too small but the tier changed: pad the kept target
            # so the fused program shapes stay consistent
            self._reextract_target(pose_np)
        if self.extract_overflow > 0:
            self.resolve_extract_overflow(pose_np)
        if float(load) > 0.7:
            self._grow_map(origin=np.asarray(pose_np))

    # -- pipelined drop-retry reconcile (fused) ------------------------------
    def make_reapply_chain(self, cfg, window: int, ext_cap: Optional[int] = None):
        """Traceable: re-apply a fixed-size window of stashed keyframe
        inserts (oldest first) to a map state, then extract once around the
        newest pose — the pipelined drop-retry reconcile fused into ONE
        program.  The sequential host loop paid ~4 device syncs per stashed
        frame (at a 30+ ms link RTT that was seconds per growth event);
        the chain pays the syncs once for the whole window.

        Padding: slots past the real window carry all-False masks AND a
        False ``valid`` flag — ``lax.cond`` skips the insert work at run
        time, and the map ``frame`` counter (staleness clock) only advances
        for real inserts, matching the sequential semantics.
        """
        sp_ = self.params.submap
        ext = self.extract_capacity if ext_cap is None else ext_cap
        is_occ = self.is_occupancy

        def _insert_one(st, cl, pose):
            if is_occ:
                return og.add_point_cloud(st, cfg, cl, pose)
            ns = vhm.add_point_cloud(st, cfg, cl, pose)
            if cfg.remove_old_data_cycle > 0:
                ns = jax.lax.cond(
                    ns.frame % cfg.remove_old_data_cycle == 0,
                    lambda s: vhm.remove_old_data(s, cfg),
                    lambda s: s,
                    ns,
                )
            return ns

        def _chain(st, clouds_t, poses_t, valid):
            # stacking happens INSIDE the program: eager jnp.stack/zeros on
            # compile per call (design rule 9), which cost the
            # first growth event seconds
            clouds = jax.tree.map(lambda *xs: jnp.stack(xs), *clouds_t)
            poses = jnp.stack(poses_t)

            def body(carry, xs):
                cl, pose, v = xs
                ns = jax.lax.cond(
                    v, lambda s: _insert_one(s, cl, pose), lambda s: s, carry
                )
                return ns, None

            ns, _ = jax.lax.scan(body, st, (clouds, poses, valid),
                                 length=window)
            # newest REAL pose (padded slots may carry anything)
            last = jnp.maximum(jnp.sum(valid.astype(jnp.int32)) - 1, 0)
            origin = poses[last][:3, 3]
            if is_occ:
                extracted, overflow = og.extract_occupied_points(
                    ns, cfg, origin, sp_.max_distance_range,
                    out_capacity=ext, with_overflow=True,
                )
                load = og.load_factor(ns, cfg)
            else:
                extracted, overflow = vhm.extract(
                    ns, cfg, origin, sp_.max_distance_range,
                    out_capacity=ext, with_covs=False,
                    with_overflow=True,
                )
                load = vhm.load_factor(ns, cfg)
            return ns, extracted, load, overflow

        return _chain

    def chain_fn_for(self, cfg, window: int, ext_cap: Optional[int] = None):
        """Jitted reapply-chain program, cached per (capacity, window,
        extract capacity); also fed by the growth-ladder precompile."""
        ext = self.extract_capacity if ext_cap is None else ext_cap
        key = (cfg.capacity, window, ext)
        fn = self._chain_cache.get(key)
        if fn is None:
            self.compile_log.append({"what": "chain_jit_miss", "key": key})
            fn = jax.jit(self.make_reapply_chain(cfg, window, ext))
            self._chain_cache[key] = fn
        return fn

    def reconcile_chain(self, clouds, poses, window: int,
                        grow_first: bool = True) -> None:
        """Fused slow-path reconcile after an in-flight drop: the caller has
        rolled ``self.map_state`` back to the pre-chain state; re-apply the
        whole stashed window (pend + later in-flight frames, oldest first)
        with grow-and-retry until no probe-exhaustion drops remain.  Retries
        restart from the (rehashed) pre-chain state, so nothing is lost.
        Budget-capped losses (``budget_lost``) never trigger growth — same
        policy as :meth:`retry_insert_after_drop`.
        """
        W = len(clouds)
        if W == 0:
            return
        if W > window:
            raise ValueError(f"reconcile window {W} > chain capacity {window}")
        pad = window - W
        # Padding is HOST numpy (device_put'd by the jit call): no eager
        # device op ever runs on this path (design rule 9).
        empty = jax.tree.map(
            lambda a: np.zeros(a.shape, a.dtype), clouds[0]
        )
        clouds_t = tuple(list(clouds) + [empty] * pad)
        poses_t = tuple(list(poses) + [np.eye(4, dtype=np.float32)] * pad)
        valid = np.arange(window) < W

        max_grow = 8
        for attempt in range(max_grow + 1):
            if grow_first or attempt > 0:
                self._grow_map(reextract=False)
            chain = self.chain_fn_for(self.map_config, window)
            ns, extracted, load, overflow = chain(
                self.map_state, clouds_t, poses_t, valid
            )
            if (
                int(ns.dropped) == int(self.map_state.dropped)
                or attempt == max_grow
            ):
                break
        self.map_state = ns
        self.extract_overflow = int(overflow)
        self.budget_lost = int(ns.budget_lost)
        if int(extracted.count()) >= self.params.registration.min_num_points:
            target = PointCloud(points=extracted.points, mask=extracted.mask)
            self.submap_cloud = self._finalize_target(target)
            self.submap_knn = build_target_knn(
                self.submap_cloud,
                max_correspondence_distance=(
                    self.params.registration.factor.max_correspondence_distance
                ),
            )
        elif (
            self.submap_cloud is not None
            and self.submap_cloud.capacity != self.extract_capacity
        ):
            self._reextract_target(np.asarray(poses[W - 1]))
        if self.extract_overflow > 0:
            self.resolve_extract_overflow(np.asarray(poses[W - 1]))
        if float(load) > 0.7:
            self._grow_map(origin=np.asarray(poses[W - 1]))

    def finalize_traced(self, cloud: PointCloud) -> PointCloud:
        """Traceable target finalize: neighborhood covariances (+ normals as
        the registration type requires).  Embedded in the fused per-frame
        program by LidarOdometry; jitted standalone for the legacy path."""
        k_ = self.params.covariance_estimation.neighbor_num
        knn = approx_knn(cloud.points, cloud.mask, cloud.points, k_)
        covs = cloud.covs if cloud.covs is not None else estimate_covariances(cloud.points, knn)
        normals = cloud.normals
        if self._need_normals and normals is None:
            normals = extract_normals(cloud.points, covs)
        return cloud.replace(covs=covs, normals=normals)

    def _finalize_target(self, cloud: PointCloud) -> PointCloud:
        if not (self._need_covs or self._need_normals):
            return cloud
        return self._finalize_jit(cloud)
