"""Lie-group operations (SO(3)/SE(3)) as batched, jit-friendly JAX functions.

Re-design of the device-side Lie layer of the reference library
(``utils/eigen_utils.hpp:851-1038`` in fateshelled/sycl_points): instead of
per-work-item scalar math, every function here is written over arbitrary
leading batch dimensions so a whole point cloud of twists is one fused XLA
computation.

Conventions (identical to the reference, which follows small_gicp/Sophus):
  * quaternion layout ``[x, y, z, w]``
  * twist layout ``[rx, ry, rz, tx, ty, tz]`` (rotation first)
  * ``se3_exp(delta)`` produces a 4x4 homogeneous matrix; registration updates
    poses as ``T @ se3_exp(delta)`` (right multiplication).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-6


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of ``v[..., 3]`` -> ``[..., 3, 3]``.

    Matches ``eigen_utils::lie::skew`` (eigen_utils.hpp:860).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega: jax.Array) -> jax.Array:
    """SO(3) exponential: rotation vector ``[..., 3]`` -> quaternion ``[..., 4]``.

    Mirrors ``eigen_utils::lie::so3_exp`` (eigen_utils.hpp:886) including the
    small-angle Taylor branch.
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta_quad = theta_sq * theta_sq
    # Small-angle Taylor series of sin(t/2)/t and cos(t/2).
    imag_small = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
    real_small = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS * _EPS))  # safe for grad
    imag_big = jnp.sin(0.5 * theta) / theta
    real_big = jnp.cos(0.5 * theta)
    small = theta_sq < _EPS
    imag = jnp.where(small, imag_small, imag_big)
    real = jnp.where(small, real_small, real_big)
    xyz = imag[..., None] * omega
    return jnp.concatenate([xyz, real[..., None]], axis=-1)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(1e-30)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Quaternion ``[..., 4]`` (xyzw) -> rotation matrix ``[..., 3, 3]``."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (xyzw).

    Vectorized four-branch Shepperd method (numerically robust for all
    rotation magnitudes), replacing ``geometry::rotation_matrix_to_quaternion``.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    # Branch 0: trace dominant.
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], axis=-1)
    # Branch 1: m00 dominant.
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], axis=-1)
    # Branch 2: m11 dominant.
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], axis=-1)
    # Branch 3: m22 dominant.
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], axis=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    return quat_normalize(q)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product of quaternions (xyzw layout)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors ``v[..., 3]`` by quaternions ``q[..., 4]``."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def so3_log(q: jax.Array) -> jax.Array:
    """SO(3) log: quaternion ``[..., 4]`` -> rotation vector ``[..., 3]``.

    Mirrors ``eigen_utils::lie::so3_log`` (eigen_utils.hpp:951) including
    canonicalization (w >= 0) and the small-angle / near-pi branches.
    """
    q = quat_normalize(q)
    q = jnp.where(q[..., 3:4] < 0.0, -q, q)
    w = q[..., 3]
    xyz = q[..., :3]
    xyz_norm = jnp.linalg.norm(xyz, axis=-1)

    w_safe = jnp.maximum(w, _EPS)
    scale_small = 2.0 / w_safe * (1.0 + xyz_norm * xyz_norm / (6.0 * w_safe * w_safe))
    xyz_norm_safe = jnp.maximum(xyz_norm, 1e-30)
    theta_general = 2.0 * jnp.arctan2(xyz_norm, jnp.abs(w))
    scale_general = theta_general / xyz_norm_safe
    scale_pi = jnp.pi / xyz_norm_safe

    scale = jnp.where(
        xyz_norm < _EPS,
        scale_small,
        jnp.where(jnp.abs(w) < _EPS, scale_pi, scale_general),
    )
    return scale[..., None] * xyz


def _so3_left_jacobian_terms(omega: jax.Array):
    """Returns (theta_sq, Omega, Omega_sq, A, B) with V = I + A*Omega + B*Omega^2."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, 1e-30))
    Omega = skew(omega)
    # Omega^2 = w w^T - |w|^2 I, computed elementwise (exact in f32; a matmul
    # here would follow the matmul precision setting, TF32 on the GPU).
    Omega_sq = omega[..., :, None] * omega[..., None, :] - theta_sq[..., None, None] * jnp.eye(
        3, dtype=omega.dtype
    )
    small = theta_sq < _EPS * _EPS
    # Taylor: A = 1/2 - th^2/24, B = 1/6 - th^2/120
    A = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, 1e-30))
    B = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, 1e-30))
    return theta_sq, Omega, Omega_sq, A, B


def se3_exp(twist: jax.Array) -> jax.Array:
    """SE(3) exponential: twist ``[..., 6]`` (rot-first) -> matrix ``[..., 4, 4]``.

    Mirrors ``eigen_utils::lie::se3_exp`` (eigen_utils.hpp:909).
    """
    omega = twist[..., :3]
    v = twist[..., 3:6]
    R = quat_to_matrix(so3_exp(omega))
    _, Omega, Omega_sq, A, B = _so3_left_jacobian_terms(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), R.shape)
    V = eye + A[..., None, None] * Omega + B[..., None, None] * Omega_sq
    t = jnp.einsum("...ij,...j->...i", V, v, precision="highest")
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=twist.dtype), top[..., :1, :].shape
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(T: jax.Array) -> jax.Array:
    """SE(3) log: matrix ``[..., 4, 4]`` -> twist ``[..., 6]`` (rot-first).

    Mirrors ``eigen_utils::lie::se3_log`` (eigen_utils.hpp:993).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(matrix_to_quat(R))
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, 1e-30))
    Omega = skew(omega)
    Omega_sq = omega[..., :, None] * omega[..., None, :] - theta_sq[..., None, None] * jnp.eye(
        3, dtype=omega.dtype
    )
    half = 0.5 * theta
    sin_half = jnp.sin(half)
    cos_half = jnp.cos(half)
    coeff_general = (1.0 - theta * cos_half / jnp.maximum(2.0 * sin_half, 1e-30)) / jnp.maximum(
        theta_sq, 1e-30
    )
    coeff = jnp.where(theta < _EPS, 1.0 / 12.0, coeff_general)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    V_inv = eye - 0.5 * Omega + coeff[..., None, None] * Omega_sq
    v = jnp.einsum("...ij,...j->...i", V_inv, t, precision="highest")
    return jnp.concatenate([omega, v], axis=-1)


def make_transform(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble ``[..., 4, 4]`` homogeneous transforms from R ``[..., 3, 3]``, t ``[..., 3]``."""
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), top[..., :1, :].shape)
    return jnp.concatenate([top, bottom], axis=-2)


def transform_inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse of a rigid transform ``[..., 4, 4]``."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_transform(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision="highest"))
