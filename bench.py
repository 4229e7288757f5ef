"""Benchmark: full preprocess + robust-GICP alignment of one scan pair,
mirroring the reference timing harness
(cpp/examples/example_registration.cpp:54-161: box filter 0.5-50 m, voxel
0.25 m, k=10 covariances+normals for BOTH clouds, then GICP with
GEMAN_MCCLURE annealing 10->2.5 over 3 levels, LM, <=10 iterations).

The pair is two synthetic HDL-64E-like scans (64 rings x 2048 azimuths,
131,072 points each) raycast at two poses of
``benchmarks/synthetic_velodyne.figure8_trajectory``, so the relative
transform is known exactly and nothing is read from outside the repository.

Run on the GPU: ``python bench.py``.  It fails when JAX finds no GPU.
Times are host wall clock around ``block_until_ready``, medians over
repeated calls after warm-up.  Prints ONE JSON line:
  {"metric": ..., "value": pairs/s, "unit": "pairs/s", "vs_baseline": x}
vs_baseline is measured against the BASELINE.json target of a <10 ms scan
pair on one H100 (i.e. 100 pairs/s == 1.0).
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks"))

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.filters import box_filter
from sycl_points_tpu.ops.knn import BruteForceKNN, approx_knn
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.ops.voxel import voxel_downsample
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.pipeline import (
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    align_pipeline,
)
from sycl_points_tpu.registration.registration import RegistrationParams, RobustParams

VOXEL = 0.25
K = 10
TARGET_PAIRS_PER_SEC = 100.0  # target: < 10 ms / pair on one H100
PAIR_FRAMES = (10, 12)  # figure-8 frames of the target and source scans


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synthetic_pair(n_az=2048, n_rings=64):
    """(source [N,3], target [N,3], T_target_source [4,4]) float32/float64."""
    from synthetic_velodyne import World, figure8_trajectory, scan_at

    world = World()
    poses = figure8_trajectory(max(PAIR_FRAMES) + 1)
    (i_t, i_s) = PAIR_FRAMES
    tgt = scan_at(world, poses[i_t], n_az=n_az, n_rings=n_rings, seed=i_t)
    src = scan_at(world, poses[i_s], n_az=n_az, n_rings=n_rings, seed=i_s)
    return src, tgt, np.linalg.inv(poses[i_t]) @ poses[i_s]


def host_voxel_count(pts):
    """Voxels left after the box filter (host numpy, picks the capacity)."""
    linf = np.max(np.abs(pts), axis=1)
    pts = pts[(linf >= 0.5) & (linf <= 50.0)]
    return len(np.unique(np.floor(pts / VOXEL).astype(np.int64), axis=0))


def preprocess(cloud: PointCloud, cap: int) -> PointCloud:
    c = box_filter(cloud, 0.5, 50.0)
    # Downsample straight into the post-voxel capacity: the segment reduce
    # already emits voxels densely from slot 0, so no separate compaction
    # pass over the raw-capacity arrays is needed.
    c = voxel_downsample(c, VOXEL, out_capacity=cap)
    knn = approx_knn(c.points, c.mask, c.points, K)
    covs = estimate_covariances(c.points, knn)
    normals = extract_normals(c.points, covs)
    return c.replace(covs=covs, normals=normals)


PIPELINE_PARAMS = RegistrationPipelineParams(
    registration=RegistrationParams(
        reg_type=RegType.GICP,
        robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE),
        optimization_method="levenberg_marquardt",
        max_iterations=10,
    ),
    random_sampling=RandomSamplingParams(enable=True, num=1000),
    robust=RobustScheduleParams(
        auto_scale=True, init_scale=10.0, min_scale=2.5,
        rotation_init_scale=5.0, rotation_min_scale=2.5, auto_scaling_iter=3,
    ),
)


def make_step(cap: int):
    """Jitted (src_raw, tgt_raw, key) -> (T [4,4], inlier, error)."""

    @jax.jit
    def step(src_raw: PointCloud, tgt_raw: PointCloud, key):
        src = preprocess(src_raw, cap)
        tgt = preprocess(tgt_raw, cap)
        out = align_pipeline(src, tgt, BruteForceKNN.build(tgt), PIPELINE_PARAMS, key=key)
        return out.result.T, out.result.inlier, out.result.error

    return step


def load_pair(n_az=2048, n_rings=64):
    """Device clouds of the synthetic pair, the post-voxel capacity, the
    voxel count and the ground truth."""
    src_np, tgt_np, T_gt = synthetic_pair(n_az, n_rings)
    raw_cap = pad_capacity_for(max(len(src_np), len(tgt_np)))
    src = PointCloud.from_numpy(src_np, capacity=raw_cap)
    tgt = PointCloud.from_numpy(tgt_np, capacity=raw_cap)
    n_vox = max(host_voxel_count(src_np), host_voxel_count(tgt_np))
    return src, tgt, pad_capacity_for(n_vox), n_vox, T_gt


def median_ms(fn, *args, iters=20, warmup=2):
    """Median host wall time of ``fn(*args)`` until its outputs are ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    require_gpu()
    enable_persistent_cache()
    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} x{len(jax.devices())}; card: {card_line()}")
    src, tgt, cap, n_vox, T_gt = load_pair()
    log(f"voxels: {n_vox} -> capacity {cap}")

    step = make_step(cap)
    key = jax.random.key(1234)
    t0 = time.perf_counter()
    T, inlier, error = jax.block_until_ready(step(src, tgt, key))
    log(f"compile+first run: {time.perf_counter()-t0:.1f}s")

    ms_pair = median_ms(step, src, tgt, key)
    log(f"scan pair: {ms_pair:.3f} ms")

    pre = jax.jit(lambda c: preprocess(c, cap))
    ms_pre = median_ms(pre, src)
    log(f"preprocess one scan: {ms_pre:.3f} ms")

    pre_src = pre(src)
    knn = jax.jit(lambda p, m: approx_knn(p, m, p, K))
    ms_knn = median_ms(knn, pre_src.points, pre_src.mask)
    log(f"self-KNN k={K} on {cap}: {ms_knn:.3f} ms ({cap/ms_knn/1e3:.1f} Mq/s)")

    t_err = float(np.linalg.norm(np.asarray(T)[:3, 3] - T_gt[:3, 3]))
    log(f"inlier={int(inlier)} error={float(error):.2f} t_err={t_err*100:.2f} cm")

    pairs_per_sec = 1e3 / ms_pair
    print(
        json.dumps(
            {
                "metric": "synthetic 64x2048 pair preprocess+robust-GICP throughput (voxel 0.25, k=10, GEMAN_MCCLURE LM x3 levels)",
                "value": pairs_per_sec,
                "unit": "pairs/s",
                "vs_baseline": pairs_per_sec / TARGET_PAIRS_PER_SEC,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "card": card_line(),
                "extra": {
                    "ms_per_pair": ms_pair,
                    "preprocess_ms_per_scan": ms_pre,
                    "knn_k10_mqueries_per_s": cap / ms_knn / 1e3,
                    "translation_err_cm": t_err * 100,
                    "points_after_voxel": n_vox,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
