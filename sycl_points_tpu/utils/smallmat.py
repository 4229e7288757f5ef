"""Small-matrix batched linear algebra (3x3 Cholesky, triangular solves, NxN
PSD solves) — the analog of the device-safe fixed-size solvers in the
reference (``utils/eigen_utils.hpp``: cholesky 3x3 at :515, 6x6 solve at
:571).  Everything is elementwise/fused math; no LAPACK calls in the hot
path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def matmul3(A: jax.Array, B: jax.Array) -> jax.Array:
    """Batched tiny matmul ``A @ B`` for ``[..., 3, 3]`` operands.

    Broadcast-multiply-sum instead of dot_general: exact f32 in one fused
    elementwise kernel, with no matmul-precision setting to get wrong and no
    library call for a 3x3 product.  ``A`` or ``B`` may be a single
    ``[3, 3]``.
    """
    return jnp.sum(A[..., :, :, None] * jnp.expand_dims(B, -3), axis=-2)


def rotate_mat3(R: jax.Array, C: jax.Array) -> jax.Array:
    """``R C R^T`` over batched ``C [..., 3, 3]``; ``R`` is ``[3, 3]`` or
    batched ``[..., 3, 3]``.  Exact f32 (see :func:`matmul3`)."""
    # tmp[...,i,l] = sum_j R[...,i,j] C[...,j,l]
    tmp = jnp.sum(R[..., :, :, None] * jnp.expand_dims(C, -3), axis=-2)
    # out[...,i,l] = sum_k tmp[...,i,k] R[...,l,k]
    return jnp.sum(tmp[..., :, None, :] * jnp.expand_dims(R, -3), axis=-1)


def matvec3(R: jax.Array, v: jax.Array) -> jax.Array:
    """``R v`` for one ``R [3,3]`` over batched ``v [..., 3]`` (exact f32)."""
    return jnp.sum(R * v[..., None, :], axis=-1)


def rot_times_skew(R: jax.Array, p: jax.Array) -> jax.Array:
    """``R @ skew(p)`` per point -> ``[..., 3, 3]`` without a matmul:
    column j is a signed combination of R's columns (exact f32, fused)."""
    x, y, z = p[..., 0, None], p[..., 1, None], p[..., 2, None]
    c0, c1, c2 = R[:, 0], R[:, 1], R[:, 2]
    col0 = z * c1 - y * c2
    col1 = -z * c0 + x * c2
    col2 = y * c0 - x * c1
    return jnp.stack([col0, col1, col2], axis=-1)


def cholesky3(A: jax.Array, jitter: float = 0.0) -> jax.Array:
    """Lower Cholesky factor of SPD ``[..., 3, 3]`` (analytic, batched)."""
    a00 = A[..., 0, 0] + jitter
    a10, a11 = A[..., 1, 0], A[..., 1, 1] + jitter
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2] + jitter
    eps = 1e-30
    g00 = jnp.sqrt(jnp.maximum(a00, eps))
    g10 = a10 / g00
    g20 = a20 / g00
    g11 = jnp.sqrt(jnp.maximum(a11 - g10 * g10, eps))
    g21 = (a21 - g20 * g10) / g11
    g22 = jnp.sqrt(jnp.maximum(a22 - g20 * g20 - g21 * g21, eps))
    zero = jnp.zeros_like(g00)
    return jnp.stack(
        [
            jnp.stack([g00, zero, zero], axis=-1),
            jnp.stack([g10, g11, zero], axis=-1),
            jnp.stack([g20, g21, g22], axis=-1),
        ],
        axis=-2,
    )


def solve_lower3(L: jax.Array, B: jax.Array) -> jax.Array:
    """Forward-substitute ``L y = B`` for lower-triangular ``L [..., 3, 3]``.

    ``B`` may be ``[..., 3]`` or ``[..., 3, m]``.
    """
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    y0 = B[..., 0, :] / L[..., 0, 0, None]
    y1 = (B[..., 1, :] - L[..., 1, 0, None] * y0) / L[..., 1, 1, None]
    y2 = (B[..., 2, :] - L[..., 2, 0, None] * y0 - L[..., 2, 1, None] * y1) / L[..., 2, 2, None]
    Y = jnp.stack([y0, y1, y2], axis=-2)
    return Y[..., 0] if vec else Y


def solve_psd(H: jax.Array, b: jax.Array):
    """Solve ``H x = b`` for symmetric positive (semi-)definite ``H [N, N]``
    via Cholesky; returns ``(x, ok)`` with ``ok`` False when the factorization
    encounters a non-positive pivot or non-finite input (the analog of the
    reference LDLT-failure -> zero-step fallback,
    registration/registration.hpp:791-801)."""
    L = jnp.linalg.cholesky(H)
    finite = jnp.all(jnp.isfinite(L))
    x = jax.scipy.linalg.cho_solve((L, True), b)
    ok = finite & jnp.all(jnp.isfinite(x))
    return jnp.where(ok, x, jnp.zeros_like(b)), ok
