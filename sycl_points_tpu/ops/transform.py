"""SE(3) transforms of point-cloud attributes (vectorized; XLA-fused).

Replaces the reference transform kernels (``algorithms/common/transform.hpp``
in fateshelled/sycl_points): one fused elementwise pass over the cloud
instead of per-work-item kernels.
"""

from __future__ import annotations

import jax

from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils.smallmat import matvec3, rotate_mat3


def transform_points(points: jax.Array, T: jax.Array) -> jax.Array:
    """Apply ``T [4,4]`` to ``points [..., 3]`` (kernel::transform_point).

    Elementwise broadcast-sum: exact f32 and one fused kernel, where a
    ``[N,3] @ [3,3]`` dot would follow the default matmul precision (TF32
    on the GPU).
    """
    return matvec3(T[..., :3, :3], points) + T[..., :3, 3]


def rotate_vectors(vecs: jax.Array, T: jax.Array) -> jax.Array:
    """Rotate direction vectors (normals) by the rotation block of ``T``."""
    return matvec3(T[..., :3, :3], vecs)


def rotate_covs(covs: jax.Array, T: jax.Array) -> jax.Array:
    """``R C R^T`` for ``covs [..., 3, 3]`` (kernel::transform_covs)."""
    return rotate_mat3(T[..., :3, :3], covs)


def transform_cloud(cloud: PointCloud, T: jax.Array) -> PointCloud:
    """Whole-cloud transform (async transform at transform.hpp:40-120)."""
    return cloud.replace(
        points=transform_points(cloud.points, T),
        normals=None if cloud.normals is None else rotate_vectors(cloud.normals, T),
        covs=None if cloud.covs is None else rotate_covs(cloud.covs, T),
    )
