"""Scan-pair registration example with the reference's per-stage timing
harness (``cpp/examples/example_registration.cpp:13-162``): box filter 0.5-50,
voxel 0.25, k=10 covariances+normals, robust-annealed GICP, per-stage us
averages over warmup+timed loops.

Usage:
  python -m sycl_points_tpu.apps.example_registration SOURCE.ply TARGET.ply \
      [--voxel 0.25] [--loops 20] [--gt T.txt]
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.filters import box_filter
from sycl_points_tpu.ops.knn import BruteForceKNN, approx_knn
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.ops.voxel import voxel_downsample
from sycl_points_tpu.points import io
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.pipeline import (
    RandomSamplingParams,
    RegistrationPipelineParams,
    RobustScheduleParams,
    align_pipeline,
)
from sycl_points_tpu.registration.registration import RegistrationParams, RobustParams
from sycl_points_tpu.utils import lie
from sycl_points_tpu.utils.timing import StageTimer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("target")
    ap.add_argument("--voxel", type=float, default=0.25)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--loops", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--gt", default=None, help="ground-truth 4x4 matrix txt")
    args = ap.parse_args(argv)
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    src_np = io.read_file(args.source)
    tgt_np = io.read_file(args.target)
    src_raw = PointCloud.from_numpy(src_np["points"])
    tgt_raw = PointCloud.from_numpy(tgt_np["points"])

    count_fn = jax.jit(
        lambda a, b: jnp.maximum(
            voxel_downsample(box_filter(a, 0.5, 50.0), args.voxel).count(),
            voxel_downsample(box_filter(b, 0.5, 50.0), args.voxel).count(),
        )
    )
    n_vox = int(count_fn(src_raw, tgt_raw))
    cap = pad_capacity_for(n_vox)

    downsample = jax.jit(
        lambda c: voxel_downsample(box_filter(c, 0.5, 50.0), args.voxel, out_capacity=cap)
    )
    knn_fn = jax.jit(lambda c: approx_knn(c.points, c.mask, c.points, args.k))
    cov_fn = jax.jit(lambda c, knn: estimate_covariances(c.points, knn))
    nrm_fn = jax.jit(lambda c, covs: extract_normals(c.points, covs))

    pipeline_params = RegistrationPipelineParams(
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
    align_fn = jax.jit(
        lambda s, t: align_pipeline(s, t, BruteForceKNN.build(t), pipeline_params).result.T
    )

    timer = StageTimer()
    T = None
    for i in range(args.loops + args.warmup):
        timed = i >= args.warmup
        tm = timer if timed else StageTimer()
        sd = tm.measure("2. Downsampling", lambda: downsample(src_raw))
        td = tm.measure("2. Downsampling", lambda: downsample(tgt_raw))
        sk = tm.measure("4. kNN Search", lambda: knn_fn(sd))
        tk = tm.measure("4. kNN Search", lambda: knn_fn(td))
        sc = tm.measure("5. compute Covariances", lambda: cov_fn(sd, sk))
        tc = tm.measure("5. compute Covariances", lambda: cov_fn(td, tk))
        sn = tm.measure("6. compute Normals", lambda: nrm_fn(sd, sc))
        tn = tm.measure("6. compute Normals", lambda: nrm_fn(td, tc))
        s = sd.replace(covs=sc, normals=sn)
        t = td.replace(covs=tc, normals=tn)
        T = tm.measure("7. Registration", lambda: align_fn(s, t))

    print(np.asarray(T))
    print()
    print(timer.report())

    if args.gt:
        T_gt = np.loadtxt(args.gt)
        err = np.asarray(lie.se3_log(jnp.asarray(np.linalg.inv(T_gt) @ np.asarray(T), dtype=jnp.float32)))
        print(
            f"\nvs ground truth: translation {np.linalg.norm(err[3:])*100:.2f} cm, "
            f"rotation {np.degrees(np.linalg.norm(err[:3])):.3f} deg"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
