"""Rotation constraint, degenerate regularization, YAML params."""

import numpy as np
import pytest

import jax.numpy as jnp

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.knn import BruteForceKNN, brute_force_knn
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.degenerate import DegenerateRegularizationParams
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import (
    LinearizedResult,
    RegistrationParams,
    RotationConstraintParams,
    align,
)
from sycl_points_tpu.registration import degenerate
from sycl_points_tpu.utils import lie

RNG = np.random.default_rng(71)


def build_cloud(pts):
    c = PointCloud.from_numpy(pts)
    knn = brute_force_knn(c.points, c.mask, c.points, 10)
    covs = estimate_covariances(c.points, knn)
    return c.replace(covs=covs, normals=extract_normals(c.points, covs))


def corner_scene(n=600):
    per = n // 3
    u = RNG.uniform(0.2, 5, size=(per, 2)).astype(np.float32)
    pts = np.concatenate([
        np.stack([u[:, 0], u[:, 1], np.zeros(per, np.float32)], 1),
        np.stack([np.zeros(per, np.float32), u[:, 0], u[:, 1]], 1),
        np.stack([u[:, 0], np.zeros(per, np.float32), u[:, 1]], 1),
    ]) + RNG.normal(scale=0.004, size=(3 * per, 3)).astype(np.float32)
    return pts


def test_rotation_constraint_align():
    pts = corner_scene()
    target = build_cloud(pts)
    T_true = np.asarray(lie.se3_exp(jnp.asarray([0.05, -0.03, 0.04, 0.2, -0.1, 0.1], dtype=np.float32)))
    source = build_cloud(((pts - T_true[:3, 3]) @ T_true[:3, :3]).astype(np.float32))
    params = RegistrationParams(
        reg_type=RegType.GICP,
        rotation_constraint=RotationConstraintParams(enable=True, weight=0.5),
        max_iterations=30,
    )
    res = align(source, target, BruteForceKNN.build(target), params)
    err = np.asarray(lie.se3_log(jnp.asarray(np.linalg.inv(T_true) @ np.asarray(res.T))))
    assert np.linalg.norm(err) < 0.02
    assert np.isfinite(float(res.error))


def test_degenerate_regularization_pulls_to_initial():
    # rank-deficient H (corridor: no information along x translation)
    H = jnp.diag(jnp.asarray([100.0, 100.0, 100.0, 0.0, 100.0, 100.0]))
    lin = LinearizedResult(H=H, b=jnp.zeros(6), error=jnp.float32(0.0), inlier=jnp.int32(50))
    params = DegenerateRegularizationParams(
        type="nl_reg", trans_eigenvalue_threshold=1.0, rot_eigenvalue_threshold=0.0,
        base_factor=1.0,
    )
    T_init = jnp.eye(4)
    T_cur = jnp.asarray(lie.se3_exp(jnp.asarray([0, 0, 0, 0.5, 0, 0], dtype=jnp.float32)))
    out = degenerate.regularize(params, lin, T_cur, T_init)
    H_out = np.asarray(out.H)
    b_out = np.asarray(out.b)
    # penalty added along the weak x-translation direction
    assert H_out[3, 3] > 10.0
    # gradient points along the drift so the solve pulls back toward T_init
    delta = np.linalg.solve(H_out + 1e-6 * np.eye(6), -b_out)
    assert delta[3] < -0.2


def test_degenerate_none_noop():
    lin = LinearizedResult(H=jnp.eye(6), b=jnp.ones(6), error=jnp.float32(1.0), inlier=jnp.int32(5))
    out = degenerate.regularize(
        DegenerateRegularizationParams(type="none"), lin, jnp.eye(4), jnp.eye(4)
    )
    np.testing.assert_allclose(np.asarray(out.H), np.eye(6))


def test_yaml_param_loading(tmp_path):
    from sycl_points_tpu.pipeline.params import LidarOdometryParams, load_params
    from sycl_points_tpu.ops.robust import RobustLossType

    yaml_text = """
scan:
  downsampling:
    voxel: {enable: true, size: 0.5}
    polar: {enable: false}
    random: {enable: true, num: 2000}
submap:
  map_type: VOXEL_HASH_MAP
  voxel_size: 0.75
registration:
  min_num_points: 42
  factor:
    reg_type: point_to_plane
    max_correspondence_distance: 1.5
    robust: {type: huber, default_scale: 3.0}
"""
    p = tmp_path / "params.yaml"
    p.write_text(yaml_text)
    params = load_params(str(p), LidarOdometryParams)
    assert params.scan.downsampling.voxel.size == 0.5
    assert not params.scan.downsampling.polar.enable
    assert params.submap.map_type == "VOXEL_HASH_MAP"
    assert params.registration.min_num_points == 42
    assert params.registration.factor.reg_type is RegType.POINT_TO_PLANE
    assert params.registration.factor.robust.type is RobustLossType.HUBER
    assert params.registration.factor.robust.default_scale == 3.0
    # untouched defaults survive
    assert params.covariance_estimation.neighbor_num == 10


def test_yaml_unknown_key_rejected(tmp_path):
    from sycl_points_tpu.pipeline.params import LidarOdometryParams, load_params

    with pytest.raises(KeyError):
        load_params({"scan": {"nonexistent_field": 1}}, LidarOdometryParams)


def test_coarse_to_fine_matches_exact():
    """With a coarse-phase budget followed by fine iterations, the final pose
    must match the all-exact align (the last iterations always refine on
    full-target correspondences)."""
    import dataclasses as _dc
    import numpy as np
    import jax.numpy as jnp
    from sycl_points_tpu.ops.covariance import estimate_covariances
    from sycl_points_tpu.ops.knn import BruteForceKNN, brute_force_knn
    from sycl_points_tpu.points.point_cloud import PointCloud
    from sycl_points_tpu.registration.factors import RegType
    from sycl_points_tpu.registration.registration import (
        RegistrationParams, align,
    )
    from sycl_points_tpu.utils import lie

    rng = np.random.default_rng(5)
    per = 600
    u = rng.uniform(-6, 6, size=(per, 2)).astype(np.float32)
    tgt_pts = np.concatenate([
        np.stack([u[:, 0], u[:, 1], np.zeros(per, np.float32)], 1),
        np.stack([np.full(per, 6.0, np.float32), u[:, 0], u[:, 1] * 0.3], 1),
        np.stack([u[:, 0], np.full(per, 6.0, np.float32), u[:, 1] * 0.3], 1),
    ]) + rng.normal(scale=0.004, size=(3 * per, 3)).astype(np.float32)

    def featurize(pts):
        c = PointCloud.from_numpy(pts.astype(np.float32))
        knn = brute_force_knn(c.points, c.mask, c.points, 10)
        return c.replace(covs=estimate_covariances(c.points, knn))

    tgt = featurize(tgt_pts)
    T_true = np.asarray(lie.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.15, -0.1, 0.05])))
    src = featurize((tgt_pts - T_true[:3, 3]) @ T_true[:3, :3])

    knn = BruteForceKNN.build(tgt)
    base = RegistrationParams(reg_type=RegType.GICP, max_iterations=30)
    exact = align(src, tgt, knn, base)
    cf = align(src, tgt, knn,
               _dc.replace(base, coarse_to_fine_iters=8, coarse_stride=4))
    d = np.asarray(lie.se3_log(jnp.asarray(
        np.linalg.inv(np.asarray(exact.T)) @ np.asarray(cf.T))))
    assert np.linalg.norm(d[3:]) < 5e-3, d
    assert np.linalg.norm(d[:3]) < 5e-3, d
    # and both recover the ground truth
    err = np.asarray(cf.T)[:3, 3] - T_true[:3, 3]
    assert np.linalg.norm(err) < 0.02
