"""Shared fused submap-update program for the odometry pipelines.

Both LidarOdometry and LidarInertialOdometry submit the same keyframe
submap update (robust-weighted sampling -> map insert -> in-range
extraction -> covariance finalize, submapping.hpp:163-247) as ONE jitted
program gated by a device-side keyframe flag, so the host needs no
intermediate readbacks.  The program is re-built (re-jitted) after every
map-capacity growth; ``Submap.version`` tracks that.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.ops.sampling import mixed_sampling, random_sampling
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.registration import compute_icp_robust_weights


def make_submap_step(params, submap,
                     robust_scale: Optional[float] = None,
                     *, ie=None, cfg=None):
    """Build the RAW (unjitted) submap-update traceable for the CURRENT map
    config — vmappable by the fleet serving layer (``parallel/fleet.py``).

    Returns a jit of ``(map_state, submap_prev, deskewed, T_eff, is_kf, key)
    -> (new_map_state, target, sampled, stats2)`` where ``stats2`` is
    ``[load, extract_overflow, extract_ok, dropped, budget_lost,
    n_extracted]`` (float32).  ``robust_scale=None`` uses the registration
    params' default scale for the sampling weights (LIO convention).

    ``ie``/``cfg`` override the submap's current insert-extract closure and
    map config — used by the background growth precompile to build the
    NEXT capacity's program ahead of the growth event (pure reads only).
    """
    sp = params.submap
    min_pts = params.registration.min_num_points
    num = sp.point_random_sampling_num
    ie = submap.insert_extract_fn if ie is None else ie
    finalize = submap.finalize_traced
    need_finalize = submap._need_covs or submap._need_normals
    if submap.is_occupancy:
        from sycl_points_tpu.mapping import occupancy_grid as _m
        cfg = submap.og_config if cfg is None else cfg
    else:
        from sycl_points_tpu.mapping import voxel_hash_map as _m
        cfg = submap.vhm_config if cfg is None else cfg

    def _zeros_sampled(deskewed):
        # the samplers return the cloud unchanged when num >= capacity,
        # so the structural dummy must match that shape
        cap = num if num < deskewed.capacity else deskewed.capacity

        def z(a):
            return None if a is None else jnp.zeros((cap,) + a.shape[1:], a.dtype)
        return PointCloud(
            points=jnp.zeros((cap, 3), jnp.float32),
            mask=jnp.zeros((cap,), bool),
            covs=z(deskewed.covs), normals=z(deskewed.normals),
            rgb=z(deskewed.rgb), intensities=z(deskewed.intensities),
            timestamp_offsets=z(deskewed.timestamp_offsets),
        )

    def _submap_step(map_state, submap_prev, deskewed, T_eff, is_kf, key):
        f32 = lambda x: jnp.asarray(x, jnp.float32)

        def do_update(_):
            n_desk = deskewed.count()
            knn_prev = BruteForceKNN(points=submap_prev.points, mask=submap_prev.mask)

            def with_weights(k):
                w = compute_icp_robust_weights(
                    deskewed, submap_prev, knn_prev, T_eff,
                    params.registration.factor,
                    None if robust_scale is None else jnp.float32(robust_scale),
                )
                return mixed_sampling(
                    deskewed, num, w, k, sp.weighted_sampling_ratio
                )

            def without_weights(k):
                return random_sampling(deskewed, num, k)

            sampled = jax.lax.cond(
                n_desk > num, with_weights, without_weights, key
            )
            new_state, extracted, load, overflow = ie(map_state, sampled, T_eff)
            ext_ok = extracted.count() >= min_pts
            target = PointCloud(
                points=jnp.where(ext_ok, extracted.points, submap_prev.points),
                mask=jnp.where(ext_ok, extracted.mask, submap_prev.mask),
            )
            if need_finalize:
                target = finalize(target)
            stats2 = jnp.stack([
                f32(load), f32(overflow), f32(ext_ok),
                f32(new_state.dropped), f32(new_state.budget_lost),
                f32(extracted.count()),
            ])
            return new_state, target, sampled, stats2

        def no_update(_):
            stats2 = jnp.stack([
                f32(_m.load_factor(map_state, cfg)), f32(0.0), f32(0.0),
                f32(map_state.dropped), f32(map_state.budget_lost),
                f32(0.0),
            ])
            return map_state, submap_prev, _zeros_sampled(deskewed), stats2

        return jax.lax.cond(is_kf, do_update, no_update, None)

    return _submap_step


def build_submap_step(params, submap,
                      robust_scale: Optional[float] = None,
                      *, ie=None, cfg=None):
    """Jitted :func:`make_submap_step` (the per-frame program the odometry
    pipelines dispatch)."""
    return jax.jit(make_submap_step(params, submap, robust_scale,
                                    ie=ie, cfg=cfg))


def _struct(tree):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree
    )


# Background growth precompile fires only once the map load is within reach
# of the 0.7 growth threshold — idle-map streams must not pay CPU for
# speculative compiles of tiers they will never visit.
GROWTH_PRECOMPILE_LOAD_GATE = 0.35
# A deliberately-small initial capacity WILL grow and can cross 0.35 -> 0.7
# within a frame or two of the (one-frame-stale) load reading; start its
# ladder earlier (advisor r4).
GROWTH_PRECOMPILE_LOAD_GATE_SMALL = 0.15

# In-flight precompile threads, joined at interpreter exit: a daemon thread
# killed inside a PJRT compile aborts the whole process ("terminate called
# ... FATAL: exception not rethrown") during teardown.
_INFLIGHT: list = []


def _join_inflight():
    for t in list(_INFLIGHT):
        t.join(timeout=300)


import atexit as _atexit

_atexit.register(_join_inflight)


def _spawn_precompile(work, name: str) -> None:
    import os
    import threading

    if os.environ.get("SYCL_POINTS_SYNC_PRECOMPILE") == "1":
        # test mode (set by tests/conftest.py): background compiles racing
        # the main thread's XLA:CPU compiles segfaulted the full suite on
        # the 1-core host (crash inside backend_compile_and_load, position
        # moved with thread timing); inline execution is deterministic
        work()
        return
    _INFLIGHT[:] = [t for t in _INFLIGHT if t.is_alive()]
    t = threading.Thread(target=work, daemon=True, name=name)
    _INFLIGHT.append(t)
    t.start()


def _sampled_struct(params, deskewed) -> PointCloud:
    """Shape/dtype signature of the sampled keyframe cloud the samplers (and
    ``_zeros_sampled``) produce from a ``deskewed``-shaped input."""
    num = params.submap.point_random_sampling_num
    cap = num if num < deskewed.capacity else deskewed.capacity
    sds = lambda a: (
        None if a is None else jax.ShapeDtypeStruct((cap,) + a.shape[1:], a.dtype)
    )
    return PointCloud(
        points=jax.ShapeDtypeStruct((cap, 3), jnp.float32),
        mask=jax.ShapeDtypeStruct((cap,), jnp.bool_),
        covs=sds(deskewed.covs), normals=sds(deskewed.normals),
        rgb=sds(deskewed.rgb), intensities=sds(deskewed.intensities),
        timestamp_offsets=sds(deskewed.timestamp_offsets),
    )


def _target_struct(submap, ext_cap: int):
    """Shape/dtype signature of the finalized submap target at an extraction
    capacity (what the registration step and the fused submap step receive
    as ``submap_prev``)."""
    raw = PointCloud(
        points=jax.ShapeDtypeStruct((ext_cap, 3), jnp.float32),
        mask=jax.ShapeDtypeStruct((ext_cap,), jnp.bool_),
    )
    if submap._need_covs or submap._need_normals:
        return jax.eval_shape(submap.finalize_traced, raw)
    return raw


def _compile_growth_step(pipeline, robust_scale, arg_structs, cfg):
    """Compile and publish the programs a growth event from ``cfg`` pays
    for: the rehash (grow) program ``cfg -> 2x``, the standalone
    insert+extract jit at the grown capacity (``retry_insert_after_drop`` /
    legacy ``_build_submap``), the fused submap-step program at the grown
    capacity, the extraction-only program, and — when the extract tier
    changes shape — the registration-step program at the new target shape.
    Returns the grown config.  Idempotent per (capacity, extract tier) —
    already-published programs are skipped."""
    import dataclasses as _dc

    submap = pipeline.submap
    if submap.is_occupancy:
        from sycl_points_tpu.mapping import occupancy_grid as _m
    else:
        from sycl_points_tpu.mapping import voxel_hash_map as _m
    next_cfg = _dc.replace(cfg, capacity=cfg.capacity * 2)
    next_ext = submap.extract_tier_for(next_cfg.capacity)
    state_struct = jax.eval_shape(lambda: _m.create(cfg))
    next_state_struct = jax.eval_shape(lambda: _m.create(next_cfg))

    # compile unconditionally even when a (possibly lazy, foreground-created)
    # jit is already cached — .lower().compile() populates the shared
    # executable cache, so a later concrete call stays cheap either way
    gfn = submap._grow_cache.get(cfg.capacity)
    if gfn is None:
        gfn = jax.jit(lambda st, _c=cfg: _m.grow(st, _c)[0])
        submap._grow_cache[cfg.capacity] = gfn
    gfn.lower(state_struct).compile()

    ie_key = (next_cfg.capacity, next_ext)
    iefn = submap._prebuilt_ie.get(ie_key)
    if iefn is None:
        iefn = jax.jit(submap.make_insert_extract(next_cfg, next_ext))
        submap._prebuilt_ie[ie_key] = iefn
    sampled = _sampled_struct(pipeline.params, arg_structs[2])
    pose = jax.ShapeDtypeStruct((4, 4), jnp.float32)
    iefn.lower(next_state_struct, sampled, pose).compile()

    # extraction-only program (tier re-extract / overflow slow path)
    exfn = submap._extract_cache.get(ie_key)
    if exfn is None:
        exfn = jax.jit(submap.make_extract_only(next_cfg, next_ext))
        submap._extract_cache[ie_key] = exfn
    exfn.lower(next_state_struct, jax.ShapeDtypeStruct((3,), jnp.float32)).compile()

    target = _target_struct(submap, next_ext)
    # The tier re-extract path finalizes the target standalone
    # (_finalize_target -> _finalize_jit): at a grown extract tier that jit
    # retraces at the new shape — a 15-25 s covariance-program compile that
    # dominated the r4 growth events until precompiled here.
    if submap._need_covs or submap._need_normals:
        raw_target = PointCloud(
            points=jax.ShapeDtypeStruct((next_ext, 3), jnp.float32),
            mask=jax.ShapeDtypeStruct((next_ext,), jnp.bool_),
        )
        submap._finalize_jit.lower(raw_target).compile()
    prebuilt = getattr(pipeline, "_prebuilt_submap", {})
    pipeline._prebuilt_submap = prebuilt
    fn = prebuilt.get(ie_key)
    if fn is None:
        fn = build_submap_step(
            pipeline.params, submap, robust_scale,
            ie=submap.make_insert_extract(next_cfg, next_ext), cfg=next_cfg,
        )
        prebuilt[ie_key] = fn
    fn.lower(next_state_struct, target, *arg_structs[2:]).compile()

    # When the extract tier changes shape, the registration step retraces at
    # the new target shape — precompile it too (the dominant growth compile).
    # Every pipeline's step takes (source, target, knn, ...) in that order.
    reg_structs = getattr(pipeline, "_reg_arg_structs", None)
    reg_jit = getattr(pipeline, "_reg_step_jit", None) or getattr(
        pipeline, "_lio_step_jit", None
    )
    # The runtime target KNN comes from build_target_knn: brute force below
    # GRID_KNN_TARGET_THRESHOLD, GridKNN above it.  Precompile only when the
    # selection is brute force — a GridKNN-shaped operand would make this
    # expensive compile dead weight (advisor r4: keep the signatures from
    # drifting by deriving the choice from the same threshold).
    from sycl_points_tpu.ops.knn import GRID_KNN_TARGET_THRESHOLD

    if (
        reg_structs is not None and reg_jit is not None
        and target.points.shape != reg_structs[1].points.shape
        and next_ext <= GRID_KNN_TARGET_THRESHOLD
    ):
        knn = BruteForceKNN(points=target.points, mask=target.mask)
        reg_jit.lower(reg_structs[0], target, knn, *reg_structs[3:]).compile()

    # Pipelined pipelines additionally pay the fused reconcile-chain program
    # on a drop-retry growth (Submap.reconcile_chain); precompile it at the
    # grown capacity for the pipeline's in-flight window size.
    window = getattr(pipeline, "_max_in_flight", None)
    if window is not None:
        window = window + 1
        key = (next_cfg.capacity, window, next_ext)
        cfn = submap._chain_cache.get(key)
        if cfn is None:
            cfn = jax.jit(submap.make_reapply_chain(next_cfg, window, next_ext))
            submap._chain_cache[key] = cfn
        clouds_t = tuple(sampled for _ in range(window))
        pose_s = jax.ShapeDtypeStruct((4, 4), jnp.float32)
        poses_t = tuple(pose_s for _ in range(window))
        valid = jax.ShapeDtypeStruct((window,), jnp.bool_)
        cfn.lower(next_state_struct, clouds_t, poses_t, valid).compile()
    return next_cfg


def start_growth_precompile(
    pipeline, robust_scale, call_args, steps_ahead: int = 2,
    enabled: bool = True, load: Optional[float] = None,
) -> None:
    """Compile the next ``steps_ahead`` map capacities' growth programs in a
    background daemon thread, so a growth event swaps in ready executables
    instead of stalling the frame stream for 15-30 s recompiles.  Two steps
    ahead because a drop-retry can double the capacity twice within one
    frame (probe exhaustion recurring after the first doubling).

    ``load`` is the latest observed map load factor: below
    ``GROWTH_PRECOMPILE_LOAD_GATE`` growth is far away and the background
    compiles (which now include the registration-step retrace at the grown
    extract tier — a 30-60 s compile) would steal host CPU from the frame
    stream for nothing, so scheduling is deferred.  ``None`` (load unknown)
    also defers — growth-heavy deployments warm the ladder explicitly
    (``precompile_growth_ladder`` / ``precompile_bootstrap_ladder``).

    ``call_args`` are the concrete arguments of a just-dispatched submap
    step — their shapes/dtypes (with the map state swapped for the grown
    capacity's) define the compile signature.  Thread-safety: the worker
    only reads immutable config/params and compiles (PJRT compilation is
    thread-safe); compiled jits are published into dicts
    (``pipeline._prebuilt_submap``, ``submap._prebuilt_ie``,
    ``submap._grow_cache``) that the growth paths consult.
    """
    submap = pipeline.submap
    started = getattr(pipeline, "_prebuilt_started", set())
    pipeline._prebuilt_started = started
    arg_structs = _struct(call_args)
    # remembered for precompile_growth_ladder (shapes are frame-invariant);
    # recorded even when the background thread is disabled
    pipeline._growth_precompile_ctx = (robust_scale, arg_structs)
    if not enabled:
        return
    # A deliberately-small initial capacity WILL grow (that is its point) and
    # can cross 0.35 -> 0.7 within a frame or two, before the one-frame-stale
    # load gate ever opens — use the earlier small-start gate for it.
    from sycl_points_tpu.pipeline.params import SubmapParams

    small_start = submap.map_capacity < SubmapParams().map_capacity
    gate = GROWTH_PRECOMPILE_LOAD_GATE_SMALL if small_start else GROWTH_PRECOMPILE_LOAD_GATE
    if load is None or load < gate:
        return
    cfg = submap.map_config
    caps = [
        (c, submap.extract_tier_for(c))
        for c in (cfg.capacity * (2 ** (i + 1)) for i in range(steps_ahead))
    ]
    if all(c in started for c in caps):
        return
    started.update(caps)

    def work():
        try:
            c = cfg
            for _ in range(steps_ahead):
                c = _compile_growth_step(pipeline, robust_scale, arg_structs, c)
        except Exception:  # precompile is best-effort; growth falls back
            pass

    _spawn_precompile(work, "growth-precompile")


def precompile_bootstrap_ladder(pipeline, max_capacity: int, pre_cloud) -> int:
    """Compile the grow + insert_extract + extract programs for every map
    capacity tier BEFORE the first frame.  The bootstrap insert
    (``Submap.add_first_frame``) can itself trigger drop-retry growth when
    the initial capacity is deliberately small, and at that point no frame
    has been dispatched yet — the full ladder (``precompile_growth_ladder``)
    cannot run, so frame 0 paid eager grow/insert compiles (the r3 growth
    replay's 4.9 s frame-0 event).  This needs only an example PREPROCESSED
    cloud (or its shape struct) for the sampled-cloud signature; the fused
    per-frame programs still compile via the ladder after frame 1."""
    import dataclasses as _dc

    submap = pipeline.submap
    if submap.is_occupancy:
        from sycl_points_tpu.mapping import occupancy_grid as _m
    else:
        from sycl_points_tpu.mapping import voxel_hash_map as _m
    pre_struct = _struct(pre_cloud)
    sampled = _sampled_struct(pipeline.params, pre_struct)
    pose = jax.ShapeDtypeStruct((4, 4), jnp.float32)
    cfg = submap.map_config

    # Frame 0's own programs (sampler, initial-capacity insert+extract,
    # first-target compaction, covariance finalize): compile them here too,
    # so the bootstrap frame executes instead of compiling.
    state0 = jax.eval_shape(lambda: _m.create(cfg))
    key_struct = jax.eval_shape(lambda: jax.random.key(0))
    submap._sample_uniform.lower(pre_struct, key_struct).compile()
    submap._insert_extract.lower(state0, sampled, pose).compile()
    submap.first_target_fn_for(submap.extract_capacity).lower(
        pre_struct, pose
    ).compile()
    if submap._need_covs or submap._need_normals:
        raw_target = PointCloud(
            points=jax.ShapeDtypeStruct((submap.extract_capacity, 3), jnp.float32),
            mask=jax.ShapeDtypeStruct((submap.extract_capacity,), jnp.bool_),
        )
        submap._finalize_jit.lower(raw_target).compile()

    n = 0
    while cfg.capacity < max_capacity:
        state_struct = jax.eval_shape(lambda _c=cfg: _m.create(_c))
        submap.grow_fn_for(cfg).lower(state_struct).compile()
        next_cfg = _dc.replace(cfg, capacity=cfg.capacity * 2)
        next_ext = submap.extract_tier_for(next_cfg.capacity)
        next_state = jax.eval_shape(lambda _c=next_cfg: _m.create(_c))
        key = (next_cfg.capacity, next_ext)
        iefn = submap._prebuilt_ie.get(key)
        if iefn is None:
            iefn = jax.jit(submap.make_insert_extract(next_cfg, next_ext))
            submap._prebuilt_ie[key] = iefn
        iefn.lower(next_state, sampled, pose).compile()
        exfn = submap._extract_cache.get(key)
        if exfn is None:
            exfn = jax.jit(submap.make_extract_only(next_cfg, next_ext))
            submap._extract_cache[key] = exfn
        exfn.lower(next_state, jax.ShapeDtypeStruct((3,), jnp.float32)).compile()
        cfg = next_cfg
        n += 1
    return n


def precompile_growth_ladder(pipeline, max_capacity: int, wait: bool = True) -> int:
    """Deployment warm-start: compile EVERY growth step from the current map
    capacity up to ``max_capacity`` (grow + insert_extract + fused submap
    step per capacity).  Use when the stream's growth pace can outrun the
    background precompile (early-stream growth at full frame rate).  Call
    after at least one processed frame (the compile signature comes from the
    last dispatched submap step).  Returns the number of ladder steps.
    """
    ctx = getattr(pipeline, "_growth_precompile_ctx", None)
    if ctx is None:
        raise RuntimeError(
            "precompile_growth_ladder: process at least one frame first "
            "(submap-step shapes are unknown before the first dispatch)"
        )
    robust_scale, arg_structs = ctx
    started = getattr(pipeline, "_prebuilt_started", set())
    pipeline._prebuilt_started = started

    def work():
        cfg = pipeline.submap.map_config
        n = 0
        while cfg.capacity < max_capacity:
            started.add(
                (cfg.capacity * 2, pipeline.submap.extract_tier_for(cfg.capacity * 2))
            )
            cfg = _compile_growth_step(pipeline, robust_scale, arg_structs, cfg)
            n += 1
        return n

    if wait:
        return work()
    _spawn_precompile(work, "growth-ladder")
    return 0
