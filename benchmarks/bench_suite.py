"""Secondary benchmark suite: BASELINE.json configs 1-8.

(The headline `bench.py` times the full annealed robust-GICP pair; config 3
here sweeps the individual robust losses.)

Each timing is the median host wall time of one jitted call of the config's
body, taken around ``block_until_ready`` after a warm-up call.  Configs 1-7
use bench.py's synthetic 64x2048 scan pair; config 8 its own synthetic pair.
Needs a GPU; prints the card's name and power limit.

Usage: python benchmarks/bench_suite.py [--json out.json] [--only 1,8]
"""

import argparse
import dataclasses
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.filters import box_filter
from sycl_points_tpu.ops.knn import BruteForceKNN, approx_knn
from sycl_points_tpu.ops.polar import polar_downsample
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.ops.sampling import farthest_point_sampling, random_sampling
from sycl_points_tpu.ops.voxel import voxel_downsample
from sycl_points_tpu.points.point_cloud import (
    PointCloud,
    compact_device,
    pad_capacity_for,
)
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.pipeline import (
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    VelocityUpdateParams,
    align_pipeline,
)
from sycl_points_tpu.registration.registration import (
    RegistrationParams,
    RobustParams,
    RotationConstraintParams,
    align,
)

def log(msg):
    print(msg, file=sys.stderr, flush=True)


def wall_ms(body, iters=10):
    """Median wall ms of one jitted ``body(0, x)`` call, outputs ready."""
    run = jax.jit(lambda x: body(0, x))
    return bench.median_ms(run, jnp.float32(0.0), iters=iters, warmup=1)


def wall_ms_carry(body, init_state, iters=10, steps=1):
    """:func:`wall_ms` for state-carrying bodies (map insertion):
    body(i, (state, acc)) -> (state, acc), run ``steps`` times in one call
    from ``init_state``; returns ms per step."""
    run = jax.jit(lambda state, x: jax.lax.fori_loop(0, steps, body, (state, x)))
    return bench.median_ms(run, init_state, jnp.float32(0.0), iters=iters, warmup=1) / steps


def preprocess(cloud, cap, with_features=True):
    c = box_filter(cloud, 0.5, 50.0)
    c = voxel_downsample(c, 0.25, out_capacity=cap)
    if not with_features:
        return c
    knn = approx_knn(c.points, c.mask, c.points, 10)
    covs = estimate_covariances(c.points, knn)
    return c.replace(covs=covs, normals=extract_normals(c.points, covs))


def config1_point_to_point(src, tgt, cap):
    """Config 1: point-to-point ICP on the bundled pair (voxel + brute-force
    KNN), reference cpp/examples semantics with ICP instead of GICP."""
    params = RegistrationParams(
        reg_type=RegType.POINT_TO_POINT,
        optimization_method="gauss_newton",
        max_iterations=20,
    )

    def body(i, acc):
        s = preprocess(src.replace(points=src.points + 1e-12 * acc), cap, False)
        g = preprocess(tgt, cap, False)
        res = align(s, g, BruteForceKNN.build(g), params)
        return acc + res.error

    ms = wall_ms(body)
    return {"config": "1-point-to-point-icp", "ms_per_pair": round(ms, 3)}


def config2_preprocess_suite(src, cap):
    """Config 2: preprocessing ops (voxel + polar downsample, random/FPS
    sampling, box filter, normals+covariances)."""
    out = {}

    def b_box(i, acc):
        c = box_filter(src.replace(points=src.points + 1e-12 * acc), 0.5, 50.0)
        return acc + c.points[0, 0]

    def b_voxel(i, acc):
        c = voxel_downsample(
            box_filter(src.replace(points=src.points + 1e-12 * acc), 0.5, 50.0),
            0.25, out_capacity=cap,
        )
        return acc + c.points[0, 0]

    def b_polar(i, acc):
        c = polar_downsample(
            src.replace(points=src.points + 1e-12 * acc), 0.5, 0.5, 0.5,
        )
        return acc + c.points[0, 0]

    key = jax.random.key(0)
    pre = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap, False))(src))

    def b_random(i, acc):
        c = random_sampling(
            pre.replace(points=pre.points + 1e-12 * acc), 1000,
            jax.random.fold_in(key, i),
        )
        return acc + c.points[0, 0]

    def b_fps(i, acc):
        c = farthest_point_sampling(
            pre.replace(points=pre.points + 1e-12 * acc), 256,
            jax.random.fold_in(key, i),
        )
        return acc + c.points[0, 0]

    def b_features(i, acc):
        p = pre.replace(points=pre.points + 1e-12 * acc)
        knn = approx_knn(p.points, p.mask, p.points, 10)
        covs = estimate_covariances(p.points, knn)
        n = extract_normals(p.points, covs)
        return acc + covs[0, 0, 0] + n[0, 0]

    def put(name, body):
        out[name] = wall_ms(body)

    put("box_filter_ms", b_box)
    put("voxel_downsample_ms", b_voxel)
    put("polar_downsample_ms", b_polar)
    put("random_sampling_ms", b_random)
    put("fps_256_ms", b_fps)
    put("covariances_normals_k10_ms", b_features)
    out["config"] = "2-preprocessing-suite"
    return out


def config3_robust_losses(src, tgt, cap):
    """Config 3 (BASELINE.md): GICP with each robust estimator on the
    bundled pair — the robust-loss axis the reference dispatches at compile
    time (registration.hpp:372-405, robust/robust.hpp:56-114).  Times the
    align loop per loss on prepped features (preprocess timed by config 2)."""
    g_src = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap))(src))
    g_tgt = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap))(tgt))
    knn = BruteForceKNN.build(g_tgt)

    out = {"config": "3-robust-losses"}
    for loss in (RobustLossType.NONE, RobustLossType.HUBER, RobustLossType.TUKEY,
                 RobustLossType.CAUCHY, RobustLossType.GEMAN_MCCLURE):
        params = RegistrationParams(
            reg_type=RegType.GICP,
            robust=RobustParams(type=loss, default_scale=2.5),
            optimization_method="gauss_newton",
            max_iterations=20,
        )

        def body(i, acc, params=params):
            s = g_src.replace(points=g_src.points + 1e-12 * acc)
            res = align(s, g_tgt, knn, params)
            return acc + res.error

        out[f"align_ms_{loss.value}"] = round(wall_ms(body), 3)
        log(f"  config3 {loss.value}: {out[f'align_ms_{loss.value}']} ms")
    return out


def config4_genz_vicp(src, tgt, cap):
    """Config 4: GenZ-ICP + VICP (constant-velocity deskew interleaved with
    alignment) + LogDet rotation constraint, on a timestamped source."""
    n = src.capacity
    ts = jnp.linspace(0.0, 100.0, n, dtype=jnp.float32)  # ms offsets
    src_t = src.replace(timestamp_offsets=ts)

    params = RegistrationPipelineParams(
        registration=RegistrationParams(
            reg_type=RegType.GENZ,
            robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE),
            rotation_constraint=RotationConstraintParams(enable=False),
            optimization_method="levenberg_marquardt",
            max_iterations=10,
        ),
        random_sampling=RandomSamplingParams(enable=True, num=1000),
        robust=RobustScheduleParams(
            auto_scale=True, init_scale=10.0, min_scale=2.5,
            rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=2,
        ),
        velocity_update=VelocityUpdateParams(enable=True, iter=1),
    )
    key = jax.random.key(7)
    prev_pose = jnp.eye(4, dtype=jnp.float32)

    def body(i, acc):
        s = preprocess(src_t.replace(points=src_t.points + 1e-12 * acc), cap)
        # timestamps survive the voxel mean; GenZ needs normals (computed)
        g = preprocess(tgt, cap)
        out = align_pipeline(
            s, g, BruteForceKNN.build(g), params,
            key=key, prev_pose=prev_pose, dt=jnp.float32(0.1),
        )
        return acc + out.result.error

    ms = wall_ms(body)
    return {"config": "4-genz-vicp", "ms_per_pair": round(ms, 3)}


def config5_odometry_step(src, tgt, cap):
    """Config 5: full submap-odometry step, map work INSIDE the timed body:
    preprocess scan -> extract submap from the voxel hash map -> covariances
    on the submap -> robust-GICP align -> insert the scan at the aligned
    pose.  The map state carries across loop iterations, exactly like the
    odometry loop (reference mapping/voxel_hash_map.hpp:614-792 +
    pipeline/submapping.hpp)."""
    from sycl_points_tpu.mapping import voxel_hash_map as vhm

    vcfg = vhm.VoxelHashMapConfig(voxel_size=0.5, capacity=1 << 16)
    eye = jnp.eye(4, dtype=jnp.float32)
    extract_cap = 1 << 14

    params = RegistrationPipelineParams(
        registration=RegistrationParams(
            reg_type=RegType.GICP,
            robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE),
            optimization_method="levenberg_marquardt",
            max_iterations=10,
        ),
        random_sampling=RandomSamplingParams(enable=True, num=1000),
        robust=RobustScheduleParams(
            auto_scale=True, init_scale=10.0, min_scale=2.5,
            rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=2,
        ),
    )
    key = jax.random.key(3)

    # Seed the map with 3 jittered target inserts (untimed).
    g0 = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap, False))(tgt))
    state = vhm.create(vcfg)

    @jax.jit
    def seed(state, dx):
        return vhm.add_point_cloud(
            state, vcfg, g0.replace(points=g0.points + dx), eye
        )

    for j in range(3):
        state = seed(state, jnp.float32(j * 0.02))
    state = jax.block_until_ready(state)

    def body(i, carry):
        state, acc = carry
        s = preprocess(src.replace(points=src.points + 1e-12 * acc), cap)
        sub = vhm.extract(
            state, vcfg, jnp.zeros(3), 100.0,
            out_capacity=extract_cap, with_covs=False,
        )
        knn10 = approx_knn(sub.points, sub.mask, sub.points, 10)
        sub = sub.replace(covs=estimate_covariances(sub.points, knn10))
        out = align_pipeline(s, sub, BruteForceKNN.build(sub), params, key=key)
        state = vhm.add_point_cloud(state, vcfg, s, out.result.T)
        return state, acc + out.result.error

    ms = wall_ms_carry(body, state)
    return {"config": "5-odometry-step", "ms_per_scan": round(ms, 3)}


def config7_mapping_ops(src, tgt, cap):
    """Config 7: the mapping kernels themselves on device — voxel-hash
    insert (log-Euclidean covariance path) and extract, occupancy-grid
    insert with DDA free-space carving, and occupied extraction
    (reference voxel_hash_map.hpp:614-792/936-1065,
    occupancy_grid_map.hpp:821-900/1235-1530)."""
    from sycl_points_tpu.mapping import occupancy_grid as og
    from sycl_points_tpu.mapping import voxel_hash_map as vhm

    out = {"config": "7-mapping-ops"}
    eye = jnp.eye(4, dtype=jnp.float32)
    g0 = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap))(tgt))

    # ---- voxel hash map ---------------------------------------------------
    vcfg = vhm.VoxelHashMapConfig(voxel_size=0.5, capacity=1 << 16)
    state = jax.block_until_ready(
        jax.jit(lambda c: vhm.add_point_cloud(vhm.create(vcfg), vcfg, c, eye))(g0)
    )

    def b_insert(i, carry):
        st, acc = carry
        s = g0.replace(points=g0.points + 1e-12 * acc)
        st = vhm.add_point_cloud(st, vcfg, s, eye)
        return st, acc + st.sum_pos[0, 0]

    out["vhm_insert_ms"] = round(wall_ms_carry(b_insert, state), 3)

    def b_extract(i, acc):
        c = vhm.extract(
            state, vcfg, jnp.zeros(3) + 1e-12 * acc, 100.0,
            out_capacity=1 << 14, with_covs=True,
        )
        return acc + c.points[0, 0]

    out["vhm_extract_ms"] = wall_ms(b_extract)

    # ---- occupancy grid (hits + DDA ray carving) ---------------------------
    # 0.5 m voxels over 50 m rays touch ~200k unique voxels per frame, so the
    # table is sized for the workload (the growth policy would land here).
    ocfg = og.OccupancyGridConfig(
        voxel_size=0.5, capacity=1 << 19, max_ray_distance=50.0,
        voxel_pruning_enabled=True,
    )
    ostate = jax.block_until_ready(
        jax.jit(lambda c: og.add_point_cloud(og.create(ocfg), ocfg, c, eye))(g0)
    )
    out["og_ray_step_budget"] = ocfg.ray_step_budget

    def b_og_insert(i, carry):
        st, acc = carry
        s = g0.replace(points=g0.points + 1e-12 * acc)
        st = og.add_point_cloud(st, ocfg, s, eye)
        return st, acc + st.log_odds[0]

    out["og_insert_carve_ms"] = round(wall_ms_carry(b_og_insert, ostate), 3)

    # Production shape: the pipelines insert keyframe-sampled clouds whose
    # capacity tier is sized to the valid count (pad_capacity_for), not the
    # preprocess buffer.  Same points, same carve result — tighter padding.
    tier = pad_capacity_for(int(jax.device_get(g0.count())))
    g0c = jax.block_until_ready(
        jax.jit(lambda c: compact_device(c, tier))(g0)
    )
    out["og_carve_rays_capacity_tiered"] = g0c.capacity

    def b_og_insert_tiered(i, carry):
        st, acc = carry
        s = g0c.replace(points=g0c.points + 1e-12 * acc)
        st = og.add_point_cloud(st, ocfg, s, eye)
        return st, acc + st.log_odds[0]

    out["og_insert_carve_ms_tiered"] = round(
        wall_ms_carry(b_og_insert_tiered, ostate), 3
    )

    # Carve-on-cycle knob (reference update knobs,
    # occupancy_grid_map.hpp:1072-1235): hits every insert, carve every 2nd —
    # the amortized per-insert cost is the steady-state OG frame budget when
    # the knob is on.  One call runs a whole cycle, so the frame counter
    # takes every lax.cond branch and the per-step mean IS the amortized cost.
    import dataclasses as _dc

    ocfg_c2 = _dc.replace(ocfg, free_space_update_cycle=2)
    ostate_c2 = jax.block_until_ready(
        jax.jit(lambda c: og.add_point_cloud(og.create(ocfg_c2), ocfg_c2, c, eye))(g0c)
    )

    def b_og_insert_c2(i, carry):
        st, acc = carry
        s = g0c.replace(points=g0c.points + 1e-12 * acc)
        st = og.add_point_cloud(st, ocfg_c2, s, eye)
        return st, acc + st.log_odds[0]

    out["og_insert_carve_ms_cycle2"] = round(
        wall_ms_carry(b_og_insert_c2, ostate_c2, steps=2), 3
    )

    # cycle=5: the skip frames run only the hits+prune path, so the
    # amortized insert approaches that path + carve/5
    ocfg_c5 = _dc.replace(ocfg, free_space_update_cycle=5)
    ostate_c5 = jax.block_until_ready(
        jax.jit(lambda c: og.add_point_cloud(og.create(ocfg_c5), ocfg_c5, c, eye))(g0c)
    )

    def b_og_insert_c5(i, carry):
        st, acc = carry
        s = g0c.replace(points=g0c.points + 1e-12 * acc)
        st = og.add_point_cloud(st, ocfg_c5, s, eye)
        return st, acc + st.log_odds[0]

    out["og_insert_carve_ms_cycle5"] = round(
        wall_ms_carry(b_og_insert_c5, ostate_c5, steps=5), 3
    )

    def b_og_extract(i, acc):
        c = og.extract_occupied_points(
            ostate, ocfg, jnp.zeros(3) + 1e-12 * acc, 100.0, out_capacity=1 << 14
        )
        return acc + c.points[0, 0]

    out["og_extract_ms"] = round(wall_ms(b_og_extract), 3)
    out["truncated_rays"] = int(ostate.truncated_rays)
    out["og_clamped_rays"] = int(ostate.clamped_rays)
    out["og_dropped"] = int(ostate.dropped)
    out["og_budget_lost"] = int(ostate.budget_lost)
    out["og_voxels"] = int(np.asarray(og.voxel_count(ostate)))
    return out


def _velodyne_pair():
    from synthetic_velodyne import World, scan_at

    w = World()
    T0 = np.eye(4)
    T0[:3, 3] = [0.0, 0.0, 1.8]
    T1 = T0.copy()
    # ~1 m forward + 2 deg yaw between scans (typical KITTI frame motion)
    yaw = np.deg2rad(2.0)
    T1[:3, :3] = np.array(
        [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    )
    T1[:3, 3] = [1.0, 0.1, 1.8]
    tgt_np = scan_at(w, T0, seed=0)
    src_np = scan_at(w, T1, seed=1)
    T_rel = np.linalg.inv(T0) @ T1  # source sensor frame -> target sensor frame
    return src_np, tgt_np, T_rel


def config8_kitti_scale():
    """Config 8: KITTI-scale tier — synthetic Velodyne pair at 131k raw
    points (reference operating envelope, example_registration.cpp:54-161):
    preprocess ms/scan, KNN throughput at M in {32k, 131k}, and full
    robust-GICP ms/pair at post-voxel scale (~20-25k points)."""
    from sycl_points_tpu.ops.knn import brute_force_knn

    src_np, tgt_np, T_rel = _velodyne_pair()
    raw_cap = pad_capacity_for(max(len(src_np), len(tgt_np)))
    src = PointCloud.from_numpy(src_np, capacity=raw_cap)
    tgt = PointCloud.from_numpy(tgt_np, capacity=raw_cap)

    def post_voxel_count(pts):
        linf = np.max(np.abs(pts), axis=1)
        p = pts[(linf >= 0.5) & (linf <= 50.0)]
        return len(np.unique(np.floor(p / 0.25).astype(np.int64), axis=0))

    n_post = max(post_voxel_count(src_np), post_voxel_count(tgt_np))
    post_cap = pad_capacity_for(n_post)
    out = {"config": "8-kitti-scale", "raw_points": int(len(src_np)),
           "post_voxel_points": int(n_post)}

    # ---- preprocess (box + voxel 0.25 + covariances/normals k=10) ----------
    def b_pre(i, acc):
        c = preprocess(src.replace(points=src.points + 1e-12 * acc), post_cap)
        return acc + c.points[0, 0] + c.covs[0, 0, 0]

    out["preprocess_ms_per_scan"] = round(wall_ms(b_pre), 3)

    # ---- raw-features preprocess (range-image covariances, r5) -------------
    # covariances from the RAW scan's O(N) range-image neighborhoods, carried
    # through the voxel downsample — replaces the dense post-voxel self-KNN
    # (the dense self-KNN dominates the standard preprocess)
    from sycl_points_tpu.ops.range_image_knn import range_image_knn

    def preprocess_rimg(cloud, out_cap):
        c = box_filter(cloud, 0.5, 50.0)
        rr = range_image_knn(c.points, c.mask, 10)
        covs = estimate_covariances(c.points, rr.knn)
        c = voxel_downsample(c.replace(covs=covs), 0.25, out_capacity=out_cap)
        return c.replace(normals=extract_normals(c.points, c.covs))

    def b_pre_rimg(i, acc):
        c = preprocess_rimg(src.replace(points=src.points + 1e-12 * acc), post_cap)
        return acc + c.points[0, 0] + c.covs[0, 0, 0]

    out["preprocess_rawfeat_ms_per_scan"] = round(
        wall_ms(b_pre_rimg), 3
    )

    def b_rimg_knn(i, acc):
        rr = range_image_knn(src.points + 1e-12 * acc, src.mask, 10)
        return acc + rr.knn.distances[0, 0]

    ms_rimg = wall_ms(b_rimg_knn)
    out["knn_k10_rimg_self131k_Mq_per_s"] = round(
        int(src.capacity) / ms_rimg / 1e3, 2
    )

    # ---- KNN throughput -----------------------------------------------------
    pre_s = jax.block_until_ready(jax.jit(lambda c: preprocess(c, post_cap))(src))
    pre_t = jax.block_until_ready(jax.jit(lambda c: preprocess(c, post_cap))(tgt))
    for M in (32768, 131072):
        t_pts = tgt.points[:M]
        t_mask = tgt.mask[:M]
        q = src.points[:8192]
        knn_struct = BruteForceKNN(points=t_pts, mask=t_mask)

        def b_nn1(i, acc):
            # production correspondence path
            r = knn_struct.search(q + 1e-12 * acc, 1)
            return acc + r.distances[0, 0]

        def b_k10(i, acc):
            r = approx_knn(t_pts, t_mask, q + 1e-12 * acc, 10)
            return acc + r.distances[0, 0]

        ms1 = wall_ms(b_nn1)
        ms10 = wall_ms(b_k10)
        out[f"knn_k1_M{M}_Mq_per_s"] = round(8192 / ms1 / 1e3, 2)
        out[f"knn_k10_M{M}_Mq_per_s"] = round(8192 / ms10 / 1e3, 2)

    # ---- robust GICP at post-voxel scale (full clouds, no sampling) --------
    params = RegistrationParams(
        reg_type=RegType.GICP,
        robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE, default_scale=2.5),
        optimization_method="levenberg_marquardt",
        max_iterations=10,
    )
    schedule = ((10.0, 5.0), (5.0, 2.5), (2.5, 2.5))

    def b_gicp(i, acc):
        s = pre_s.replace(points=pre_s.points + 1e-12 * acc)
        res = align(s, pre_t, BruteForceKNN.build(pre_t), params,
                    robust_schedule=schedule)
        return acc + res.error

    out["gicp_full_cloud_ms_per_pair"] = round(wall_ms(b_gicp), 3)

    # coarse-to-fine correspondence schedule: first 20 iterations search a
    # stride-4 target subset, the rest the full cloud (convergence only
    # counts on fine iterations) — the full-cloud-tier speed knob.
    params_cf = dataclasses.replace(params, coarse_to_fine_iters=20, coarse_stride=4)

    def b_gicp_cf(i, acc):
        s = pre_s.replace(points=pre_s.points + 1e-12 * acc)
        res = align(s, pre_t, BruteForceKNN.build(pre_t), params_cf,
                    robust_schedule=schedule)
        return acc + res.error

    out["gicp_full_cloud_c2f_ms_per_pair"] = round(wall_ms(b_gicp_cf), 3)
    res_cf = jax.jit(
        lambda s, t: align(s, t, BruteForceKNN.build(t), params_cf,
                           robust_schedule=schedule)
    )(pre_s, pre_t)
    t_err_cf = np.asarray(res_cf.T)[:3, 3] - np.asarray(T_rel, np.float32)[:3, 3]
    out["gicp_full_cloud_c2f_t_err_cm"] = round(float(np.linalg.norm(t_err_cf)) * 100, 2)

    # production configuration: the registration pipeline's input sampling
    # (1000 pts, reference registration_pipeline_params.hpp default) bounds
    # the per-iteration correspondence cost regardless of scan size.
    pparams = RegistrationPipelineParams(
        registration=params,
        random_sampling=RandomSamplingParams(enable=True, num=1000),
        robust=RobustScheduleParams(
            auto_scale=True, init_scale=10.0, min_scale=2.5,
            rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=3,
        ),
    )
    key = jax.random.key(11)

    def b_gicp_pipe(i, acc):
        s = pre_s.replace(points=pre_s.points + 1e-12 * acc)
        res = align_pipeline(s, pre_t, BruteForceKNN.build(pre_t), pparams, key=key)
        return acc + res.result.error

    out["gicp_pipeline_sampled_ms_per_pair"] = round(
        wall_ms(b_gicp_pipe), 3
    )

    # ---- the BASELINE.json north star, measured as ONE fused body ----------
    # full preprocess of BOTH raw 131k scans (raw-features path) + the
    # production sampled robust-GICP alignment, end to end
    def b_e2e_pair(i, acc):
        s = preprocess_rimg(src.replace(points=src.points + 1e-12 * acc), post_cap)
        g = preprocess_rimg(tgt, post_cap)
        res = align_pipeline(s, g, BruteForceKNN.build(g), pparams, key=key)
        return acc + res.result.error

    out["e2e_pair_rawfeat_ms"] = round(wall_ms(b_e2e_pair), 3)
    res_rf = jax.jit(
        lambda s0: align_pipeline(
            preprocess_rimg(s0, post_cap), preprocess_rimg(tgt, post_cap),
            BruteForceKNN.build(preprocess_rimg(tgt, post_cap)), pparams, key=key,
        ).result.T
    )(src)
    t_err_rf = np.linalg.norm(np.asarray(res_rf)[:3, 3] - T_rel[:3, 3])
    out["e2e_pair_rawfeat_t_err_cm"] = round(float(t_err_rf) * 100.0, 2)

    # accuracy cross-check vs the synthetic ground truth
    res = jax.jit(
        lambda s, t: align(s, t, BruteForceKNN.build(t), params,
                           robust_schedule=schedule).T
    )(pre_s, pre_t)
    t_err = np.linalg.norm(np.asarray(res)[:3, 3] - T_rel[:3, 3])
    out["translation_err_cm"] = round(float(t_err) * 100.0, 2)
    return out


def main():
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=None, help="comma-separated config numbers")
    args = ap.parse_args()
    require_gpu()
    enable_persistent_cache()
    log(f"device: {jax.devices()[0].device_kind}; card: {card_line()}")
    src, tgt, cap, _, _ = bench.load_pair()
    results = []
    for num, fn, a in (
        ("1", config1_point_to_point, (src, tgt, cap)),
        ("2", config2_preprocess_suite, (src, cap)),
        ("3", config3_robust_losses, (src, tgt, cap)),
        ("4", config4_genz_vicp, (src, tgt, cap)),
        ("5", config5_odometry_step, (src, tgt, cap)),
        ("6", config6_lio_step, (src, tgt, cap)),
        ("7", config7_mapping_ops, (src, tgt, cap)),
        ("8", config8_kitti_scale, ()),
    ):
        if args.only and num not in args.only.split(","):
            continue
        t0 = time.perf_counter()
        r = fn(*a)
        r["compile_plus_measure_s"] = round(time.perf_counter() - t0, 1)
        log(json.dumps(r))
        results.append(r)
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


def config6_lio_step(src, tgt, cap):
    """Extra: 15-DOF LIO alignment step (GICP factor + IMU prior) —
    the per-scan solver of the LiDAR-inertial pipeline."""
    from sycl_points_tpu.imu.factor import State
    from sycl_points_tpu.lio import lio_registration as lio

    g0 = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap))(tgt))
    s0 = jax.block_until_ready(jax.jit(lambda c: preprocess(c, cap))(src))
    x_pred = State(
        position=jnp.zeros(3), rotation=jnp.eye(3), velocity=jnp.zeros(3),
        accel_bias=jnp.zeros(3), gyro_bias=jnp.zeros(3),
    )
    P = jnp.eye(15, dtype=jnp.float32) * 0.1

    def body(i, acc):
        s = s0.replace(points=s0.points + 1e-12 * acc)
        res = lio.align(
            s, g0, BruteForceKNN.build(g0), x_pred, P, P,
            factor_params=RegistrationParams(
                reg_type=RegType.GICP,
                robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE, default_scale=2.5),
                optimization_method="levenberg_marquardt",
            ),
        )
        return acc + res.error

    ms = wall_ms(body)
    return {"config": "6-lio-15dof-step", "ms_per_scan": round(ms, 3)}


if __name__ == "__main__":
    main()
