"""Batched analytic symmetric 3x3 eigendecomposition and SPD matrix functions.

Replacement for the device-side eigensolver of the reference
library (``utils/eigen_utils.hpp:443`` symmetric_eigen_decomposition_3x3 and
the SPD log/exp at ``eigen_utils.hpp:646,664`` in fateshelled/sycl_points).

``jnp.linalg.eigh`` on millions of tiny 3x3 matrices is iterative and slow;
this module implements the closed-form (trigonometric) eigenvalue
formula plus Eberly's robust cross-product eigenvector construction, fully
vectorized over leading batch dimensions so the whole point cloud is one
fused elementwise computation.

All functions accept ``[..., 3, 3]`` symmetric matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvalsh3(A: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric ``[..., 3, 3]`` in ascending order ``[..., 3]``."""
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p_sq = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p_sq, 0.0))
    p_safe = jnp.maximum(p, 1e-30)
    Bn = B / p_safe[..., None, None]
    half_det = 0.5 * jnp.linalg.det(Bn)
    r = jnp.clip(half_det, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam2 = q + 2.0 * p * jnp.cos(phi)
    lam0 = q + 2.0 * p * jnp.cos(phi + _TWO_PI_3)
    lam1 = 3.0 * q - lam0 - lam2
    return jnp.stack([lam0, lam1, lam2], axis=-1)


def _largest_cross(M: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Best cross product of row pairs of ``M [..., 3, 3]`` -> (vector, sq_norm)."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best12 = n12 > n02
    c_b = jnp.where(best12[..., None], c12, c02)
    n_b = jnp.where(best12, n12, n02)
    best01 = n01 > n_b
    c = jnp.where(best01[..., None], c01, c_b)
    n = jnp.where(best01, n01, n_b)
    return c, n


def _normalize(v: jax.Array) -> jax.Array:
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-30)


def _orthogonal_complement(w: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orthonormal basis {U, V} of the plane orthogonal to unit ``w [..., 3]``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    use_x = jnp.abs(wx) > jnp.abs(wy)
    inv_a = 1.0 / jnp.sqrt(jnp.maximum(wx * wx + wz * wz, 1e-30))
    u_a = jnp.stack([-wz * inv_a, jnp.zeros_like(wx), wx * inv_a], axis=-1)
    inv_b = 1.0 / jnp.sqrt(jnp.maximum(wy * wy + wz * wz, 1e-30))
    u_b = jnp.stack([jnp.zeros_like(wx), wz * inv_b, -wy * inv_b], axis=-1)
    U = jnp.where(use_x[..., None], u_a, u_b)
    V = jnp.cross(w, U)
    return U, V


def eigh3(A: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Eigendecomposition of symmetric ``[..., 3, 3]``.

    Returns ``(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3])`` with
    ``eigenvectors[..., :, i]`` the unit eigenvector of ``eigenvalues[..., i]``
    (column convention, matching Eigen / the reference solver).
    """
    dtype = A.dtype
    eye = jnp.eye(3, dtype=dtype)
    lam = eigvalsh3(A)
    lam0, lam1, lam2 = lam[..., 0], lam[..., 1], lam[..., 2]

    spread = lam2 - lam0
    scale = jnp.maximum(jnp.max(jnp.abs(lam), axis=-1), 1e-30)
    degenerate = spread <= 1e-6 * scale  # all eigenvalues (nearly) equal

    # Pick the extreme eigenvalue with the larger gap: its A - lam*I has rank 2,
    # so the row cross products are well conditioned.
    use_low = (lam1 - lam0) > (lam2 - lam1)
    lam_a = jnp.where(use_low, lam0, lam2)
    lam_b = jnp.where(use_low, lam2, lam0)

    M_a = A - lam_a[..., None, None] * eye
    c_a, _ = _largest_cross(M_a)
    v_a = _normalize(c_a)
    # Guard the fully-degenerate case before building the complement.
    v_a = jnp.where(degenerate[..., None], jnp.broadcast_to(eye[0], v_a.shape), v_a)

    U, W = _orthogonal_complement(v_a)

    # Remaining eigenvectors live in span{U, W}: solve the projected 2x2 problem
    # for lam_b.  (A - lam_b I) restricted to the plane.
    AU = jnp.einsum("...ij,...j->...i", A, U, precision="highest")
    AW = jnp.einsum("...ij,...j->...i", A, W, precision="highest")
    m00 = jnp.sum(U * AU, axis=-1) - lam_b
    m01 = jnp.sum(U * AW, axis=-1)
    m11 = jnp.sum(W * AW, axis=-1) - lam_b
    # Null direction of [[m00, m01], [m01, m11]]: take the larger row.
    row0 = m00 * m00 + m01 * m01
    row1 = m01 * m01 + m11 * m11
    use_r0 = row0 > row1
    p0 = jnp.where(use_r0, m01, m11)
    p1 = jnp.where(use_r0, -m00, -m01)
    pn = jnp.sqrt(jnp.maximum(p0 * p0 + p1 * p1, 0.0))
    tiny = pn <= 1e-30
    p0 = jnp.where(tiny, jnp.ones_like(p0), p0 / jnp.maximum(pn, 1e-30))
    p1 = jnp.where(tiny, jnp.zeros_like(p1), p1 / jnp.maximum(pn, 1e-30))
    v_b = p0[..., None] * U + p1[..., None] * W
    v_c = jnp.cross(v_a, v_b)

    # Scatter back into ascending order: (v_a, v_b) are the (low, high) or
    # (high, low) extremes; v_c is always the middle eigenvector.
    v0 = jnp.where(use_low[..., None], v_a, v_b)
    v2 = jnp.where(use_low[..., None], v_b, v_a)
    V = jnp.stack([v0, v_c, v2], axis=-1)
    V = jnp.where(degenerate[..., None, None], jnp.broadcast_to(eye, V.shape), V)
    return lam, V


def smallest_eigenvector3(A: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric ``[..., 3, 3]``.

    Cheap specialization used by normal extraction and plane regularization
    (the two hottest per-point eigen consumers).
    """
    _, V = eigh3(A)
    return V[..., :, 0]


def plane_regularize(cov: jax.Array, eps: float = 1e-3) -> jax.Array:
    """GICP plane regularization: replace eigenvalues with ``(eps, 1, 1)``.

    Matches ``covariance::kernel::update_covariance_plane``
    (feature/covariance.hpp:67-74).  Algebraic identity:
    ``V diag(eps,1,1) V^T = I - (1-eps) v0 v0^T`` with v0 the smallest
    eigenvector, avoiding the full reconstruction.
    """
    v0 = smallest_eigenvector3(cov)
    eye = jnp.eye(3, dtype=cov.dtype)
    return eye - (1.0 - eps) * v0[..., :, None] * v0[..., None, :]


def normalize_covariance(cov: jax.Array) -> jax.Array:
    """Scale-normalized covariance: eigenvalues divided by the largest, clamped
    to ``[1e-3, 1]``.  Matches ``covariance::kernel::normalize_covariance``
    (feature/covariance.hpp:76-95), including the 1e3 stabilization scaling.
    """
    lam, V = eigh3(cov * 1e3)
    lam_max = lam[..., 2]
    bad = lam_max < 1e-37
    lam_max_safe = jnp.maximum(lam_max, 1e-37)
    l0 = jnp.clip(lam[..., 0] / lam_max_safe, 1e-3, 1.0)
    l1 = jnp.clip(lam[..., 1] / lam_max_safe, 1e-3, 1.0)
    l2 = jnp.ones_like(l0)
    d = jnp.stack([l0, l1, l2], axis=-1)
    out = jnp.einsum("...ik,...k,...jk->...ij", V, d, V, precision="highest")
    eye = jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), cov.shape)
    return jnp.where(bad[..., None, None], eye, out)


def spd_log(A: jax.Array, min_eig: float = 1e-6) -> jax.Array:
    """Matrix log of SPD ``[..., 3, 3]`` (log-Euclidean covariance averaging).

    Matches ``eigen_utils::spd_log_3x3`` (eigen_utils.hpp:646).
    """
    lam, V = eigh3(A)
    lam = jnp.maximum(lam, min_eig)
    return jnp.einsum("...ik,...k,...jk->...ij", V, jnp.log(lam), V, precision="highest")


def spd_exp(A: jax.Array, max_log: float = 30.0) -> jax.Array:
    """Matrix exp of symmetric ``[..., 3, 3]``.

    Matches ``eigen_utils::spd_exp_3x3`` (eigen_utils.hpp:664).
    """
    lam, V = eigh3(A)
    lam = jnp.clip(lam, -max_log, max_log)
    return jnp.einsum("...ik,...k,...jk->...ij", V, jnp.exp(lam), V, precision="highest")


def inv3(A: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse via the adjugate (device-safe analog of
    ``eigen_utils::inverse`` for 3x3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, jnp.inf, det)
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], axis=-1),
            jnp.stack([A10, A11, A12], axis=-1),
            jnp.stack([A20, A21, A22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def ensure_symmetric(A: jax.Array) -> jax.Array:
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def floor_eigenvalues(cov: jax.Array, eps: float = 1e-6) -> jax.Array:
    """Clamp eigenvalues of symmetric ``[..., 3, 3]`` to at least ``eps``.

    Conditions estimated covariances before inversion: f32 moment
    accumulation on LiDAR-scale coordinates leaves planar neighborhoods
    indefinite to roundoff (eigenvalues down to about -1e-4), which breaks
    any Cholesky/inverse downstream.  Reconstruction via
    ``cov + V (max(lam, eps) - lam) V^T``.
    """
    lam, V = eigh3(cov)
    bump = jnp.maximum(lam, eps) - lam  # [..., 3]
    corr = jnp.sum(
        bump[..., None, None, :] * V[..., :, None, :] * V[..., None, :, :], axis=-1
    )
    return ensure_symmetric(cov + corr)


def spd_inverse(cov: jax.Array, min_eig: float = 1e-6) -> jax.Array:
    """SPD-by-construction inverse of symmetric ``[..., 3, 3]``:
    ``V diag(1/max(lam, min_eig)) V^T``.

    The adjugate/determinant inverse (:func:`inv3`) cancels catastrophically
    in f32 for ill-conditioned covariances (det ~ 1e-10 while cofactor
    round-off is ~1e-8), producing *indefinite* results; going through the
    closed-form eigendecomposition costs a few more flops and is always a
    valid information matrix.
    """
    lam, V = eigh3(cov)
    inv_lam = 1.0 / jnp.maximum(lam, min_eig)
    return ensure_symmetric(
        jnp.sum(inv_lam[..., None, None, :] * V[..., :, None, :] * V[..., None, :, :], axis=-1)
    )
