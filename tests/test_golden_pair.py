"""End-to-end golden test: GICP on a scan pair read from PLY files must
recover T_target_source (the reference's accuracy golden; example harness
at cpp/examples/example_registration.cpp:13-162).  The pair is bench.py's
synthetic HDL-64E-like scans at two poses of the figure-8, so the ground
truth is analytic."""

import numpy as np

import jax.numpy as jnp

import bench
from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.knn import BruteForceKNN, brute_force_knn
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.ops.voxel import voxel_downsample
from sycl_points_tpu.points import io
from sycl_points_tpu.points.point_cloud import PointCloud, compact_device, pad_capacity_for
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import (
    RegistrationParams,
    RobustParams,
    align,
)
from sycl_points_tpu.utils import lie

VOXEL = 0.5


def load_preprocessed(path, voxel, k=10):
    raw = io.read_file(path)
    pts = raw["points"]
    n_vox = len(np.unique(np.floor(pts / voxel).astype(np.int64), axis=0))
    cloud = PointCloud.from_numpy(pts)
    down = voxel_downsample(cloud, voxel)
    down = compact_device(down, out_capacity=pad_capacity_for(n_vox))
    knn = brute_force_knn(down.points, down.mask, down.points, k)
    covs = estimate_covariances(down.points, knn)
    normals = extract_normals(down.points, covs)
    return down.replace(covs=covs, normals=normals)


def test_gicp_bundled_pair(tmp_path):
    src_np, tgt_np, T_gt = bench.synthetic_pair()
    for name, pts in (("source", src_np), ("target", tgt_np)):
        io.write_ply(str(tmp_path / f"{name}.ply"), {"points": pts}, binary=True)
    T_gt = T_gt.astype(np.float32)
    # Coarser voxel than the reference example (0.5 vs 0.25) to keep the
    # CPU test fast; bench.py runs the full 0.25 config on the GPU.
    source = load_preprocessed(str(tmp_path / "source.ply"), VOXEL)
    target = load_preprocessed(str(tmp_path / "target.ply"), VOXEL)
    knn = BruteForceKNN.build(target)
    params = RegistrationParams(
        reg_type=RegType.GICP,
        robust=RobustParams(type=RobustLossType.GEMAN_MCCLURE, default_scale=2.5),
        optimization_method="levenberg_marquardt",
        max_iterations=20,
    )
    res = align(source, target, knn, params)
    T = np.asarray(res.T)
    err = np.asarray(lie.se3_log(jnp.asarray(np.linalg.inv(T_gt) @ T)))
    t_err = np.linalg.norm(err[3:])
    r_err = np.linalg.norm(err[:3])
    assert t_err < 0.08, f"translation error {t_err:.3f} m (T={T})"
    assert r_err < 0.01, f"rotation error {r_err:.4f} rad"
    assert int(res.inlier) > 2000
