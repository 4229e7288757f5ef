"""Per-correspondence ICP factor linearization, whitened-row formulation.

Replaces ``algorithms/registration/factor.hpp`` of fateshelled/sycl_points
(RegType family at factor.hpp:18-32, per-pair linearize kernels at
factor.hpp:130-482).  Design change: instead of accumulating a
6x6 ``H`` per work item, every correspondence is expressed as up to three
*whitened residual rows* ``A [N, 3, 6]``, ``c [N, 3]`` such that

    H_i = A_i^T A_i,   b_i = A_i^T c_i,   err_i = |c_i|^2

which matches the reference exactly (H = J^T M J with M = L L^T and
A = L^T J), but turns the global reduction into two large matmuls
``[6, 3N] @ [3N, 6]`` / ``[6, 3N] @ [3N]`` — the analog
of the reference's fused ``sycl::reduction`` pass
(registration.hpp:513-676).

Conventions (factor.hpp:69-84): J = [R.skew(p) | -R] (rotation-first twist),
residual r = q - T p, and the caller solves (H + lambda I) delta = -b,
T <- T @ se3_exp(delta).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.utils.eigh3 import eigvalsh3, spd_inverse
from sycl_points_tpu.utils.smallmat import (
    cholesky3,
    matmul3,
    matvec3,
    rot_times_skew,
    rotate_mat3,
    solve_lower3,
)


class RegType(enum.Enum):
    POINT_TO_POINT = "point_to_point"
    POINT_TO_PLANE = "point_to_plane"
    POINT_TO_DISTRIBUTION = "point_to_distribution"
    GICP = "gicp"
    GENZ = "genz"

    @staticmethod
    def from_string(s: str) -> "RegType":
        u = s.strip().upper()
        if u == "P2D":
            return RegType.POINT_TO_DISTRIBUTION
        return RegType[u]


class WhitenedRows(NamedTuple):
    A: jax.Array  # [N, 3, 6] whitened Jacobian rows
    c: jax.Array  # [N, 3] whitened residual
    residual_norm: jax.Array  # [N] (unweighted; robust-weight argument)
    genz_weight: jax.Array  # [N] (1.0 for non-GenZ types)


def se3_jacobian(T: jax.Array, src_pts: jax.Array) -> jax.Array:
    """J = [R.skew(p) | -R] per point -> ``[N, 3, 6]`` (factor.hpp:69-84)."""
    R = T[:3, :3]
    Rskew = rot_times_skew(R, src_pts)  # exact f32, one fused kernel
    negR = jnp.broadcast_to(-R, Rskew.shape)
    return jnp.concatenate([Rskew, negR], axis=-1)


def genz_planarity(target_covs: jax.Array, threshold: float = 0.2) -> jax.Array:
    """PCA normalized curvature < threshold => planar (factor.hpp:378-401).

    Pose-independent, so unlike the reference (which re-evaluates per pair
    per iteration) this is precomputed once per target cloud.
    """
    lam = eigvalsh3(target_covs)
    s = jnp.sum(lam, axis=-1)
    curvature = jnp.where(s > 1e-12, lam[..., 0] / jnp.maximum(s, 1e-12), 1.0)
    return curvature < threshold


def _plane_rows(J, r, normals):
    nj = jnp.sum(normals[:, :, None] * J, axis=-2)  # [N, 6]
    s = jnp.sum(normals * r, axis=-1)  # [N]
    A = normals[:, :, None] * nj[:, None, :]
    c = normals * s[:, None]
    return A, c, jnp.abs(s)


def _mahalanobis_rows(J, r, sigma):
    """Whiten with Sigma^-1: A = G^-1 J, c = G^-1 r for Sigma = G G^T.

    Requires a conditioned Sigma (GICP passes plane-regularized covariance
    sums); a near-singular Sigma would overflow 1/g22^2 in f32."""
    G = cholesky3(sigma)
    A = solve_lower3(G, J)
    c = solve_lower3(G, r)
    return A, c, jnp.linalg.norm(c, axis=-1)


def _mahalanobis_rows_from_inverse(J, r, sigma, floor: float = 1e-4):
    """Whiten via the information matrix ``W = Sigma^-1``:
    ``A = Gw^T J``, ``c = Gw^T r`` for ``W = Gw Gw^T``.

    This is the reference's P2D formulation (compute_target_mahalanobis,
    factor.hpp:312-317: 3x3 inverse of the target covariance).  Divergence
    for robustness: estimated f32 covariances of planar LiDAR neighborhoods
    are indefinite to roundoff (eigenvalues down to -1e-4) and the f32
    adjugate inverse of a near-singular Sigma is itself indefinite, which
    makes the reference's unfactored J^T W J silently produce garbage rows;
    here W comes from the eigendecomposition with a (1 cm)^2 eigenvalue floor
    (SPD by construction), so the information Cholesky is always finite."""
    W = spd_inverse(sigma, floor)
    Gw = cholesky3(W)
    Gt = jnp.swapaxes(Gw, -1, -2)
    A = matmul3(Gt, J)
    c = matvec3(Gt, r)
    return A, c, jnp.linalg.norm(c, axis=-1)


def whitened_rows(
    reg_type: RegType,
    T: jax.Array,
    src_pts: jax.Array,
    tgt_pts: jax.Array,
    src_covs_reg: Optional[jax.Array] = None,
    tgt_covs_reg: Optional[jax.Array] = None,
    tgt_covs_raw: Optional[jax.Array] = None,
    tgt_normals: Optional[jax.Array] = None,
    genz_planar: Optional[jax.Array] = None,
    genz_alpha: Optional[jax.Array] = None,
) -> WhitenedRows:
    """Linearize all correspondences at pose ``T`` (factor.hpp:413-448).

    ``tgt_*`` arrays are already gathered to source order ([N, ...]).
    ``src_covs_reg`` / ``tgt_covs_reg`` are plane-regularized covariances
    (precomputed once per alignment — the regularization is pose-independent,
    unlike the reference which recomputes it per pair per iteration).
    """
    N = src_pts.shape[0]
    p_t = matvec3(T[:3, :3], src_pts) + T[:3, 3]
    r = tgt_pts - p_t
    J = se3_jacobian(T, src_pts)
    ones = jnp.ones((N,), src_pts.dtype)

    if reg_type is RegType.POINT_TO_POINT:
        return WhitenedRows(J, r, jnp.linalg.norm(r, axis=-1), ones)

    if reg_type is RegType.POINT_TO_PLANE:
        A, c, rn = _plane_rows(J, r, tgt_normals)
        return WhitenedRows(A, c, rn, ones)

    if reg_type is RegType.GICP:
        sigma = rotate_mat3(T[:3, :3], src_covs_reg) + tgt_covs_reg
        A, c, rn = _mahalanobis_rows(J, r, sigma)
        return WhitenedRows(A, c, rn, ones)

    if reg_type is RegType.POINT_TO_DISTRIBUTION:
        A, c, rn = _mahalanobis_rows_from_inverse(J, r, tgt_covs_raw)
        return WhitenedRows(A, c, rn, ones)

    if reg_type is RegType.GENZ:
        A_pl, c_pl, rn_pl = _plane_rows(J, r, tgt_normals)
        rn_pp = jnp.linalg.norm(r, axis=-1)
        gw = jnp.where(genz_planar, genz_alpha, 1.0 - genz_alpha)
        A = jnp.where(genz_planar[:, None, None], A_pl, J)
        c = jnp.where(genz_planar[:, None], c_pl, r)
        rn = jnp.where(genz_planar, rn_pl, rn_pp)
        return WhitenedRows(A, c, rn, gw)

    raise ValueError(reg_type)


def residual_norms_only(
    reg_type: RegType,
    T: jax.Array,
    src_pts: jax.Array,
    tgt_pts: jax.Array,
    src_covs_reg: Optional[jax.Array] = None,
    tgt_covs_reg: Optional[jax.Array] = None,
    tgt_covs_raw: Optional[jax.Array] = None,
    tgt_normals: Optional[jax.Array] = None,
    genz_planar: Optional[jax.Array] = None,
    genz_alpha: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """(residual_norm, genz_weight) without the Jacobian — the error-only
    path used by LM/dogleg step acceptance (calculate_geometry_error,
    factor.hpp:455-482)."""
    N = src_pts.shape[0]
    p_t = matvec3(T[:3, :3], src_pts) + T[:3, 3]
    r = tgt_pts - p_t
    ones = jnp.ones((N,), src_pts.dtype)

    if reg_type is RegType.POINT_TO_POINT:
        return jnp.linalg.norm(r, axis=-1), ones
    if reg_type is RegType.POINT_TO_PLANE:
        return jnp.abs(jnp.sum(tgt_normals * r, axis=-1)), ones
    if reg_type is RegType.GICP:
        sigma = rotate_mat3(T[:3, :3], src_covs_reg) + tgt_covs_reg
        G = cholesky3(sigma)
        c = solve_lower3(G, r)
        return jnp.linalg.norm(c, axis=-1), ones
    if reg_type is RegType.POINT_TO_DISTRIBUTION:
        W = spd_inverse(tgt_covs_raw, 1e-4)
        Gt = jnp.swapaxes(cholesky3(W), -1, -2)
        c = matvec3(Gt, r)
        return jnp.linalg.norm(c, axis=-1), ones
    if reg_type is RegType.GENZ:
        rn_pl = jnp.abs(jnp.sum(tgt_normals * r, axis=-1))
        rn_pp = jnp.linalg.norm(r, axis=-1)
        gw = jnp.where(genz_planar, genz_alpha, 1.0 - genz_alpha)
        return jnp.where(genz_planar, rn_pl, rn_pp), gw
    raise ValueError(reg_type)
