"""Per-correspondence rotation constraint via Jensen-Bregman LogDet divergence.

Replaces ``algorithms/registration/rotation_constraint.hpp`` of
fateshelled/sycl_points: residual D = max(0, logdet(0.5 (R Cs R^T + Ct)) -
0.5 (logdet Cs + logdet Ct)); analytic gradient wrt the rotation twist
J = -R^T vex([Cs', M^-1]) (rotation_constraint.hpp:47-90); rank-1 H on the
rotation block, robust-weighted, summed alongside the geometric term
(registration.hpp:612-640).  Fully batched over correspondences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.robust import compute_error, compute_weight
from sycl_points_tpu.utils.eigh3 import inv3
from sycl_points_tpu.utils.smallmat import matmul3, matvec3, rotate_mat3


def _logdet3(M: jax.Array) -> jax.Array:
    return jnp.log(jnp.maximum(jnp.linalg.det(M), 1e-10))


def _divergence_and_grad(src_covs, tgt_covs, T):
    """Returns (D [N], J [N,3] gradient in the local rotation frame)."""
    R = T[:3, :3]
    Cs_p = rotate_mat3(R, src_covs)
    M = 0.5 * (Cs_p + tgt_covs)
    D = jnp.maximum(
        _logdet3(M) - 0.5 * (_logdet3(src_covs) + _logdet3(tgt_covs)), 0.0
    )
    M_inv = inv3(M)
    comm = matmul3(Cs_p, M_inv) - matmul3(M_inv, Cs_p)
    g_global = -0.5 * jnp.stack(
        [
            comm[:, 2, 1] - comm[:, 1, 2],
            comm[:, 0, 2] - comm[:, 2, 0],
            comm[:, 1, 0] - comm[:, 0, 1],
        ],
        axis=-1,
    )
    J = matvec3(R.T, g_global)  # R^T g per row (exact f32)
    return D, J


def _gathered_tgt_covs(corr):
    # The constraint uses the *unregularized* covariances (the reference
    # passes the raw stored covs, registration.hpp:612); when the constraint
    # is enabled the align loop gathers them as corr.covs_raw.
    if corr.covs_raw is not None:
        return corr.covs_raw
    return corr.covs_reg


def rotation_constraint_linearized(T, src_covs, tgt_covs, mask, loss, rot_scale, weight):
    """(H [6,6], b [6], error) contribution of the constraint over all pairs."""
    D, J = _divergence_and_grad(src_covs, tgt_covs, T)
    # reference: squared_error = 0.5 * D^2, residual_norm = sqrt(squared_error)
    rn = jnp.sqrt(0.5) * jnp.abs(D)
    w = compute_weight(loss, rn, rot_scale) * mask.astype(D.dtype) * weight
    # H_rot = sum w * J J^T (rotation block), b_rot = sum w * D * J
    H3 = jnp.einsum("n,ni,nj->ij", w, J, J, precision="highest")
    b3 = jnp.einsum("n,n,ni->i", w, D, J, precision="highest")
    err = jnp.sum(
        mask.astype(D.dtype) * weight * compute_error(loss, rn, rot_scale)
    )
    H6 = jnp.zeros((6, 6), D.dtype).at[:3, :3].set(H3)
    b6 = jnp.zeros((6,), D.dtype).at[:3].set(b3)
    return H6, b6, err


def add_rotation_constraint(params, lin, T, src_covs, corr, rot_scale):
    """Add the robust-weighted rotation-constraint term to a LinearizedResult
    (the second term of the fused reduction, registration.hpp:612-640)."""
    tgt_covs = _gathered_tgt_covs(corr)
    if src_covs is None or tgt_covs is None:
        raise ValueError("rotation constraint requires source and target covariances")
    H6, b6, err = rotation_constraint_linearized(
        T, src_covs, tgt_covs, corr.mask, params.robust.type, rot_scale,
        params.rotation_constraint.weight,
    )
    return lin._replace(H=lin.H + H6, b=lin.b + b6, error=lin.error + err)


def rotation_constraint_error(params, T, src_covs, corr, rot_scale):
    tgt_covs = _gathered_tgt_covs(corr)
    R = T[:3, :3]
    Cs_p = rotate_mat3(R, src_covs)
    M = 0.5 * (Cs_p + tgt_covs)
    D = jnp.maximum(
        _logdet3(M) - 0.5 * (_logdet3(src_covs) + _logdet3(tgt_covs)), 0.0
    )
    rn = jnp.sqrt(0.5) * jnp.abs(D)
    return jnp.sum(
        corr.mask.astype(D.dtype)
        * params.rotation_constraint.weight
        * compute_error(params.robust.type, rn, rot_scale)
    )
