"""On-manifold IMU preintegration (Forster-style, midpoint/RK2).

Replaces ``algorithms/imu/imu_preintegration.hpp`` of fateshelled/sycl_points:
measurement window extraction with boundary interpolation
(imu_preintegration.hpp:49-89), bias-linearized midpoint integration with
first-order bias Jacobians (:360-418), 15x15 error-state covariance
propagation (:420-517; ordering [dp, dphi, dv, dba, dbg]), first-order bias
correction (:243-270), and absolute/relative pose prediction with gravity and
initial-velocity compensation (:280-337).

Design: the per-step recurrence is a ``lax.scan`` over padded
step arrays, so a whole window integrates as one jitted computation;
:class:`IMUPreintegration` is a thin streaming wrapper with the reference's
reset/integrate/predict API (host-side buffering, float64 timestamps).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.utils import lie

GRAVITY = (0.0, 0.0, -9.80665)


@dataclasses.dataclass(frozen=True)
class IMUPreintegrationParams:
    gravity: tuple = GRAVITY
    accel_scale: float = 1.0
    gyro_noise_density: float = 0.0  # [rad/s/sqrt(Hz)]
    accel_noise_density: float = 0.0  # [m/s^2/sqrt(Hz)]
    gyro_bias_rw_density: float = 0.0  # [rad/s^2/sqrt(Hz)]
    accel_bias_rw_density: float = 0.0  # [m/s^3/sqrt(Hz)]


class PreintegrationState(NamedTuple):
    Delta_R: jax.Array  # [3, 3]
    Delta_v: jax.Array  # [3]
    Delta_p: jax.Array  # [3]
    dt_total: jax.Array  # scalar
    J_R_bg: jax.Array  # [3, 3]
    J_v_bg: jax.Array
    J_v_ba: jax.Array
    J_p_bg: jax.Array
    J_p_ba: jax.Array
    covariance: jax.Array  # [15, 15]


def init_state(initial_covariance: Optional[jax.Array] = None) -> PreintegrationState:
    z = jnp.zeros((3, 3), jnp.float32)
    return PreintegrationState(
        Delta_R=jnp.eye(3, dtype=jnp.float32),
        Delta_v=jnp.zeros(3, jnp.float32),
        Delta_p=jnp.zeros(3, jnp.float32),
        dt_total=jnp.float32(0.0),
        J_R_bg=z, J_v_bg=z, J_v_ba=z, J_p_bg=z, J_p_ba=z,
        covariance=(
            jnp.zeros((15, 15), jnp.float32)
            if initial_covariance is None
            else initial_covariance
        ),
    )


def right_jacobian_so3(phi: jax.Array) -> jax.Array:
    """Jr(phi) with the small-angle Taylor branch
    (imu_preintegration.hpp:341-356)."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, 1e-30))
    S = lie.skew(phi)
    S2 = phi[..., :, None] * phi[..., None, :] - theta_sq[..., None, None] * jnp.eye(3, dtype=phi.dtype)
    small = theta < 1e-4
    A = jnp.where(small, 0.5, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, 1e-30))
    B = jnp.where(small, 1.0 / 6.0, (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, 1e-30))
    return jnp.eye(3, dtype=phi.dtype) - A[..., None, None] * S + B[..., None, None] * S2


def _integrate_scan(
    params: IMUPreintegrationParams,
    state: PreintegrationState,
    dt: jax.Array,  # [S]
    omega0: jax.Array,  # [S, 3] raw gyro at step start
    omega1: jax.Array,  # [S, 3] raw gyro at step end
    accel0: jax.Array,  # [S, 3]
    accel1: jax.Array,  # [S, 3]
    valid: jax.Array,  # [S] bool
    gyro_bias: jax.Array,  # [3]
    accel_bias: jax.Array,  # [3]
    R_world_body: Optional[jax.Array] = None,
) -> PreintegrationState:
    """Scan the midpoint recurrence over padded step arrays. Jittable.

    Mirrors ``integrate_step`` (imu_preintegration.hpp:360-517); invalid or
    non-positive-dt steps are skipped.
    """
    R0 = jnp.eye(3, dtype=jnp.float32) if R_world_body is None else R_world_body
    g = jnp.asarray(params.gravity, jnp.float32)
    has_noise = (
        params.gyro_noise_density > 0.0
        or params.accel_noise_density > 0.0
        or params.gyro_bias_rw_density > 0.0
        or params.accel_bias_rw_density > 0.0
    )

    def step(s: PreintegrationState, inp):
        dt_f, w0, w1, a0, a1, ok = inp
        ok = ok & (dt_f > 1e-9)
        dt_f = jnp.where(ok, dt_f, 0.0)

        omega_mid = 0.5 * (w0 + w1) - gyro_bias
        a_mid = 0.5 * (a0 + a1) * params.accel_scale - accel_bias

        phi_mid = omega_mid * dt_f
        R_step = lie.quat_to_matrix(lie.so3_exp(phi_mid))
        phi_half = omega_mid * (0.5 * dt_f)
        R_half = lie.quat_to_matrix(lie.so3_exp(phi_half))
        Delta_R_mid = s.Delta_R @ R_half

        a_nav = Delta_R_mid @ a_mid

        Delta_R_new = s.Delta_R @ R_step
        Delta_p_new = s.Delta_p + s.Delta_v * dt_f + 0.5 * a_nav * dt_f * dt_f
        Delta_v_new = s.Delta_v + a_nav * dt_f

        Jr = right_jacobian_so3(phi_mid)
        Jr_half = right_jacobian_so3(phi_half)
        skew_a = lie.skew(a_mid)

        J_R_mid_bg = R_half.T @ s.J_R_bg - Jr_half * (0.5 * dt_f)
        J_R_bg_new = R_step.T @ s.J_R_bg - Jr * dt_f
        J_v_bg_new = s.J_v_bg - Delta_R_mid @ skew_a @ J_R_mid_bg * dt_f
        J_v_ba_new = s.J_v_ba - Delta_R_mid * dt_f
        J_p_bg_new = s.J_p_bg + s.J_v_bg * dt_f - 0.5 * Delta_R_mid @ skew_a @ J_R_mid_bg * dt_f * dt_f
        J_p_ba_new = s.J_p_ba + s.J_v_ba * dt_f - 0.5 * Delta_R_mid * dt_f * dt_f

        # --- covariance propagation (imu_preintegration.hpp:420-517) ---
        dt2 = dt_f * dt_f
        dt3 = dt2 * dt_f
        R_world_mid = R0 @ Delta_R_mid
        rot_err_to_mid = R_half.T
        gyro_bias_to_mid = -Jr_half * (0.5 * dt_f)
        eye3 = jnp.eye(3, dtype=jnp.float32)

        F = jnp.eye(15, dtype=jnp.float32)
        F = F.at[0:3, 3:6].set(-0.5 * R_world_mid @ skew_a @ rot_err_to_mid * dt2)
        F = F.at[0:3, 6:9].set(eye3 * dt_f)
        F = F.at[0:3, 9:12].set(-0.5 * R_world_mid * dt2)
        F = F.at[0:3, 12:15].set(-0.5 * R_world_mid @ skew_a @ gyro_bias_to_mid * dt2)
        F = F.at[3:6, 3:6].set(R_step.T)
        F = F.at[3:6, 12:15].set(-Jr * dt_f)
        F = F.at[6:9, 3:6].set(-R_world_mid @ skew_a @ rot_err_to_mid * dt_f)
        F = F.at[6:9, 9:12].set(-R_world_mid * dt_f)
        F = F.at[6:9, 12:15].set(-R_world_mid @ skew_a @ gyro_bias_to_mid * dt_f)

        cov = F @ s.covariance @ F.T
        if has_noise:
            dt_safe = jnp.maximum(dt_f, 1e-9)
            sa2 = params.accel_noise_density**2
            sg2 = params.gyro_noise_density**2
            sba2 = params.accel_bias_rw_density**2
            sbg2 = params.gyro_bias_rw_density**2
            G = jnp.zeros((15, 12), jnp.float32)
            G = G.at[0:3, 0:3].set(-0.5 * R_world_mid * dt2)
            G = G.at[6:9, 0:3].set(-R_world_mid * dt_f)
            G = G.at[3:6, 3:6].set(-Jr * dt_f)
            G = G.at[0:3, 3:6].set(0.25 * R_world_mid @ skew_a @ Jr_half * dt3)
            G = G.at[6:9, 3:6].set(0.5 * R_world_mid @ skew_a @ Jr_half * dt2)
            G = G.at[9:12, 6:9].set(eye3)
            G = G.at[12:15, 9:12].set(eye3)
            qd = jnp.concatenate(
                [
                    jnp.full(3, sa2 / dt_safe), jnp.full(3, sg2 / dt_safe),
                    jnp.full(3, sba2 * dt_safe), jnp.full(3, sbg2 * dt_safe),
                ]
            ).astype(jnp.float32)
            cov = cov + (G * qd[None, :]) @ G.T
        cov = 0.5 * (cov + cov.T)

        new = PreintegrationState(
            Delta_R=Delta_R_new, Delta_v=Delta_v_new, Delta_p=Delta_p_new,
            dt_total=s.dt_total + dt_f,
            J_R_bg=J_R_bg_new, J_v_bg=J_v_bg_new, J_v_ba=J_v_ba_new,
            J_p_bg=J_p_bg_new, J_p_ba=J_p_ba_new, covariance=cov,
        )
        out = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new, s)
        return out, (out.Delta_R, out.Delta_p, out.dt_total)

    return jax.lax.scan(step, state, (dt, omega0, omega1, accel0, accel1, valid))


def _parallel_prefix_integrate(params, state, dt, omega0, omega1, accel0, accel1,
                               valid, gyro_bias, accel_bias, R_world_body=None):
    """Parallel-prefix (associative-scan) preintegration — the log-depth
    formulation of the midpoint recurrence.

    Each step of a sequential ``lax.scan`` has a fixed cost regardless of
    body size (docs/design.md rule 8), so a 64-step IMU window would pay it
    64 times inside the fused LIO frame program.  Every quantity of
    the recurrence is instead expressed in closed form over prefix products:

      * ``Delta_R``: one ``associative_scan`` of batched 3x3 products;
      * ``Delta_v`` / ``Delta_p``: cumsums of prefix-rotated midpoint
        contributions (the (R, v, p, t) updates form a Galilean-style group);
      * bias Jacobians: the rotation-Jacobian recurrence
        ``J' = R_stepᵀ J - Jr dt`` unrolls to
        ``J_k = M_kᵀ (J_0 + Σ_{i<=k} M_i (-Jr_i dt_i))`` (M_i orthogonal),
        i.e. ONE cumsum; the v/p Jacobians are cumsums of terms built from
        those prefixes;
      * covariance: an ``associative_scan`` over (F, Q) pairs with
        ``combine((F1,Q1),(F2,Q2)) = (F2 F1, F2 Q1 F2ᵀ + Q2)``.

    Matches the sequential scan to fp tolerance (tests); log-depth instead
    of S sequential dispatches.  Returns ``(final_state, (Delta_R [S,3,3],
    Delta_p [S,3], dt_total [S]))`` like :func:`_integrate_scan`.
    """
    R0w = jnp.eye(3, dtype=jnp.float32) if R_world_body is None else R_world_body
    S = dt.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)

    ok = valid & (dt > 1e-9)
    dt = jnp.where(ok, dt, 0.0)
    okf = ok.astype(jnp.float32)

    omega_mid = 0.5 * (omega0 + omega1) - gyro_bias  # [S,3]
    a_mid = 0.5 * (accel0 + accel1) * params.accel_scale - accel_bias
    phi_mid = omega_mid * dt[:, None]
    phi_half = 0.5 * phi_mid
    R_step = lie.quat_to_matrix(lie.so3_exp(phi_mid))  # [S,3,3]; I when dt=0
    R_half = lie.quat_to_matrix(lie.so3_exp(phi_half))
    Jr = right_jacobian_so3(phi_mid)
    Jr_half = right_jacobian_so3(phi_half)
    skew_a = lie.skew(a_mid)

    # ---- rotation prefixes -------------------------------------------------
    M = jax.lax.associative_scan(
        lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), R_step
    )  # inclusive: M_k = R_1 ... R_k
    E = jnp.concatenate([eye3[None], M[:-1]], axis=0)  # exclusive prefix
    # full (initial-state-composed) prefixes
    R0 = state.Delta_R
    E_full = jnp.einsum("ij,sjk->sik", R0, E)
    M_full = jnp.einsum("ij,sjk->sik", R0, M)
    DR_mid = jnp.einsum("sij,sjk->sik", E_full, R_half)  # Delta_R at midpoint

    # ---- translation/velocity prefixes ------------------------------------
    c = jnp.einsum("sij,sj->si", R_half, a_mid * dt[:, None])  # local dv
    a_nav = jnp.einsum("sij,sj->si", E_full, c)  # = Delta_R_mid a_mid dt
    v_inc = jnp.cumsum(a_nav, axis=0)
    v_pref = state.Delta_v + v_inc  # inclusive Delta_v
    v_excl = jnp.concatenate([state.Delta_v[None], v_pref[:-1]], axis=0)
    p_terms = v_excl * dt[:, None] + 0.5 * a_nav * dt[:, None]
    p_pref = state.Delta_p + jnp.cumsum(p_terms, axis=0)
    t_pref = state.dt_total + jnp.cumsum(dt)

    # ---- bias Jacobians ----------------------------------------------------
    # J_R_bg_k = M_kᵀ (J0 + Σ_{i<=k} M_i (-Jr_i dt_i))
    terms_R = jnp.einsum("sij,sjk->sik", E, jnp.einsum("sij,sjk->sik", R_step, -Jr) * dt[:, None, None])
    # note M_i = E_i R_step_i, so M_i(-Jr_i dt_i) = E_i R_step_i (-Jr_i) dt_i
    sum_R = state.J_R_bg + jnp.cumsum(terms_R, axis=0)
    J_R_bg = jnp.einsum("sji,sjk->sik", M, sum_R)  # M_kᵀ @ sum
    J_R_bg_excl = jnp.concatenate([state.J_R_bg[None], J_R_bg[:-1]], axis=0)
    J_R_mid = (
        jnp.einsum("sji,sjk->sik", R_half, J_R_bg_excl)
        - Jr_half * (0.5 * dt[:, None, None])
    )
    DRS = jnp.einsum("sij,sjk->sik", DR_mid, skew_a)  # Delta_R_mid skew(a)
    DRSJ = jnp.einsum("sij,sjk->sik", DRS, J_R_mid)
    J_v_bg = state.J_v_bg + jnp.cumsum(-DRSJ * dt[:, None, None], axis=0)
    J_v_ba = state.J_v_ba + jnp.cumsum(-DR_mid * dt[:, None, None], axis=0)
    J_v_bg_excl = jnp.concatenate([state.J_v_bg[None], J_v_bg[:-1]], axis=0)
    J_v_ba_excl = jnp.concatenate([state.J_v_ba[None], J_v_ba[:-1]], axis=0)
    dt2 = (dt * dt)[:, None, None]
    J_p_bg = state.J_p_bg + jnp.cumsum(
        J_v_bg_excl * dt[:, None, None] - 0.5 * DRSJ * dt2, axis=0
    )
    J_p_ba = state.J_p_ba + jnp.cumsum(
        J_v_ba_excl * dt[:, None, None] - 0.5 * DR_mid * dt2, axis=0
    )

    # ---- covariance: (F, Q) pair scan -------------------------------------
    dtc = dt[:, None, None]
    R_world_mid = jnp.einsum("ij,sjk->sik", R0w, DR_mid)
    RWS = jnp.einsum("sij,sjk->sik", R_world_mid, skew_a)
    rot_err_to_mid = jnp.swapaxes(R_half, -1, -2)
    gyro_bias_to_mid = -Jr_half * (0.5 * dtc)

    F = jnp.broadcast_to(jnp.eye(15, dtype=jnp.float32), (S, 15, 15))
    F = F.at[:, 0:3, 3:6].set(-0.5 * jnp.einsum("sij,sjk->sik", RWS, rot_err_to_mid) * dtc * dtc)
    F = F.at[:, 0:3, 6:9].set(eye3 * dtc)
    F = F.at[:, 0:3, 9:12].set(-0.5 * R_world_mid * dtc * dtc)
    F = F.at[:, 0:3, 12:15].set(-0.5 * jnp.einsum("sij,sjk->sik", RWS, gyro_bias_to_mid) * dtc * dtc)
    F = F.at[:, 3:6, 3:6].set(jnp.swapaxes(R_step, -1, -2))
    F = F.at[:, 3:6, 12:15].set(-Jr * dtc)
    F = F.at[:, 6:9, 3:6].set(-jnp.einsum("sij,sjk->sik", RWS, rot_err_to_mid) * dtc)
    F = F.at[:, 6:9, 9:12].set(-R_world_mid * dtc)
    F = F.at[:, 6:9, 12:15].set(-jnp.einsum("sij,sjk->sik", RWS, gyro_bias_to_mid) * dtc)
    # invalid steps must be identity transitions
    F = jnp.where(ok[:, None, None], F, jnp.eye(15, dtype=jnp.float32))

    has_noise = (
        params.gyro_noise_density > 0.0
        or params.accel_noise_density > 0.0
        or params.gyro_bias_rw_density > 0.0
        or params.accel_bias_rw_density > 0.0
    )
    if has_noise:
        dt_safe = jnp.maximum(dt, 1e-9)[:, None, None]
        dt3 = dtc * dtc * dtc
        sa2 = params.accel_noise_density**2
        sg2 = params.gyro_noise_density**2
        sba2 = params.accel_bias_rw_density**2
        sbg2 = params.gyro_bias_rw_density**2
        G = jnp.zeros((S, 15, 12), jnp.float32)
        G = G.at[:, 0:3, 0:3].set(-0.5 * R_world_mid * dtc * dtc)
        G = G.at[:, 6:9, 0:3].set(-R_world_mid * dtc)
        G = G.at[:, 3:6, 3:6].set(-Jr * dtc)
        G = G.at[:, 0:3, 3:6].set(0.25 * jnp.einsum("sij,sjk->sik", RWS, Jr_half) * dt3)
        G = G.at[:, 6:9, 3:6].set(0.5 * jnp.einsum("sij,sjk->sik", RWS, Jr_half) * dtc * dtc)
        G = G.at[:, 9:12, 6:9].set(eye3)
        G = G.at[:, 12:15, 9:12].set(eye3)
        qd = jnp.concatenate([
            jnp.broadcast_to(sa2 / dt_safe[:, :, 0], (S, 3)),
            jnp.broadcast_to(sg2 / dt_safe[:, :, 0], (S, 3)),
            jnp.broadcast_to(sba2 * dt_safe[:, :, 0], (S, 3)),
            jnp.broadcast_to(sbg2 * dt_safe[:, :, 0], (S, 3)),
        ], axis=1).astype(jnp.float32)
        Q = jnp.einsum("sij,sjk->sik", G * qd[:, None, :], jnp.swapaxes(G, -1, -2))
        Q = jnp.where(ok[:, None, None], Q, 0.0)
    else:
        Q = jnp.zeros((S, 15, 15), jnp.float32)

    def combine(x, y):
        F1, Q1 = x
        F2, Q2 = y
        Fp = jnp.einsum("...ij,...jk->...ik", F2, F1)
        Qp = jnp.einsum(
            "...ij,...jk->...ik",
            jnp.einsum("...ij,...jk->...ik", F2, Q1),
            jnp.swapaxes(F2, -1, -2),
        ) + Q2
        return Fp, Qp

    F_prod, Q_acc = jax.lax.associative_scan(combine, (F, Q))
    Fp, Qp = F_prod[-1], Q_acc[-1]
    cov = Fp @ state.covariance @ Fp.T + Qp
    cov = 0.5 * (cov + cov.T)

    final = PreintegrationState(
        Delta_R=M_full[-1], Delta_v=v_pref[-1], Delta_p=p_pref[-1],
        dt_total=t_pref[-1],
        J_R_bg=J_R_bg[-1], J_v_bg=J_v_bg[-1], J_v_ba=J_v_ba[-1],
        J_p_bg=J_p_bg[-1], J_p_ba=J_p_ba[-1], covariance=cov,
    )
    return final, (M_full, p_pref, t_pref)


def integrate_steps(params, state, dt, omega0, omega1, accel0, accel1, valid,
                    gyro_bias, accel_bias, R_world_body=None,
                    parallel: bool = True) -> PreintegrationState:
    """Integrate padded step arrays (jittable).  ``parallel=True`` (default)
    uses the log-depth parallel-prefix formulation; the sequential scan is
    kept as the reference implementation for equivalence tests."""
    if parallel:
        final, _ = _parallel_prefix_integrate(
            params, state, dt, omega0, omega1, accel0, accel1,
            valid, gyro_bias, accel_bias, R_world_body)
        return final
    final, _ = _integrate_scan(params, state, dt, omega0, omega1, accel0, accel1,
                               valid, gyro_bias, accel_bias, R_world_body)
    return final


def integrate_steps_with_outputs(params, state, dt, omega0, omega1, accel0, accel1,
                                 valid, gyro_bias, accel_bias, R_world_body=None,
                                 parallel: bool = True):
    """Like :func:`integrate_steps` but also returns per-step cumulative
    (Delta_R [S,3,3], Delta_p [S,3], dt_total [S]) — the trajectory samples
    used by the IMU deskew."""
    if parallel:
        return _parallel_prefix_integrate(
            params, state, dt, omega0, omega1, accel0, accel1,
            valid, gyro_bias, accel_bias, R_world_body)
    return _integrate_scan(params, state, dt, omega0, omega1, accel0, accel1,
                           valid, gyro_bias, accel_bias, R_world_body)


def get_corrected(
    state: PreintegrationState,
    gyro_bias_lin: jax.Array,
    accel_bias_lin: jax.Array,
    gyro_bias_new: jax.Array,
    accel_bias_new: jax.Array,
) -> PreintegrationState:
    """First-order bias correction (imu_preintegration.hpp:243-270)."""
    d_bg = gyro_bias_new - gyro_bias_lin
    d_ba = accel_bias_new - accel_bias_lin
    phi = state.J_R_bg @ d_bg
    R_corr = state.Delta_R @ lie.quat_to_matrix(lie.so3_exp(phi))
    # quaternion roundtrip renormalization
    R_corr = lie.quat_to_matrix(lie.matrix_to_quat(R_corr))
    return state._replace(
        Delta_R=R_corr,
        Delta_v=state.Delta_v + state.J_v_bg @ d_bg + state.J_v_ba @ d_ba,
        Delta_p=state.Delta_p + state.J_p_bg @ d_bg + state.J_p_ba @ d_ba,
    )


def predict_transform(
    params: IMUPreintegrationParams,
    corrected: PreintegrationState,
    T_world_body_i: jax.Array,
    v_world_i: jax.Array,
) -> jax.Array:
    """Absolute end-of-window pose (imu_preintegration.hpp:280-300)."""
    g = jnp.asarray(params.gravity, jnp.float32)
    dt = corrected.dt_total
    R_i = T_world_body_i[:3, :3]
    p_i = T_world_body_i[:3, 3]
    R_j = R_i @ corrected.Delta_R
    p_j = p_i + v_world_i * dt + 0.5 * g * dt * dt + R_i @ corrected.Delta_p
    return lie.make_transform(R_j, p_j)


def predict_relative_transform(
    params: IMUPreintegrationParams,
    corrected: PreintegrationState,
    R_world_body_i: jax.Array,
    v_world_i: jax.Array,
) -> jax.Array:
    """Relative start->end transform with gravity + initial-velocity
    compensation (imu_preintegration.hpp:305-337); the ICP initial guess."""
    g = jnp.asarray(params.gravity, jnp.float32)
    dt = corrected.dt_total
    dp = (
        corrected.Delta_p
        + 0.5 * (R_world_body_i.T @ g) * dt * dt
        + R_world_body_i.T @ v_world_i * dt
    )
    return lie.make_transform(corrected.Delta_R, dp)


# ---------------------------------------------------------------------------
# Host-side measurement windowing + streaming wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IMUMeasurement:
    timestamp: float  # absolute wall time [s], float64
    gyro: np.ndarray  # [3] rad/s
    accel: np.ndarray  # [3] m/s^2


def interpolate_measurement(before: IMUMeasurement, after: IMUMeasurement, timestamp: float) -> IMUMeasurement:
    span = after.timestamp - before.timestamp
    if span <= 0.0:
        return before
    a = min(max((timestamp - before.timestamp) / span, 0.0), 1.0)
    return IMUMeasurement(
        timestamp=timestamp,
        gyro=((1 - a) * before.gyro + a * after.gyro).astype(np.float32),
        accel=((1 - a) * before.accel + a * after.accel).astype(np.float32),
    )


def build_measurement_window(
    measurements: Sequence[IMUMeasurement], start: float, end: float
) -> list:
    """Window extraction with boundary interpolation
    (imu_preintegration.hpp:49-89)."""
    window: list = []
    if end <= start:
        return window
    before_start = None
    for m in measurements:
        if m.timestamp <= start:
            before_start = m
            continue
        if m.timestamp > end:
            if not window and before_start is not None:
                window.append(interpolate_measurement(before_start, m, start))
            if window and window[-1].timestamp < end:
                window.append(interpolate_measurement(window[-1], m, end))
            break
        if not window and before_start is not None:
            window.append(
                interpolate_measurement(before_start, m, start)
                if before_start.timestamp < start
                else before_start
            )
        window.append(m)
    return window


def padded_steps_from_window(window: Sequence[IMUMeasurement], min_bucket: int = 32):
    """:func:`steps_from_window` padded to a power-of-two bucket so device
    programs consuming the arrays compile once per bucket, not once per
    window length (real IMU windows jitter by a step or two every frame)."""
    dt, w0, w1, a0, a1, valid = steps_from_window(window)
    S = len(dt)
    Sp = max(min_bucket, 1 << (max(S, 1) - 1).bit_length())
    if Sp != S:
        pad = Sp - S
        z = np.zeros((pad, 3), np.float32)
        dt = np.concatenate([dt, np.zeros(pad, np.float32)])
        w0, w1 = np.concatenate([w0, z]), np.concatenate([w1, z])
        a0, a1 = np.concatenate([a0, z]), np.concatenate([a1, z])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    return dt, w0, w1, a0, a1, valid


def pack_steps(dt, w0, w1, a0, a1, valid) -> np.ndarray:
    """Pack the per-step arrays into ONE [S, 14] f32 host->device payload
    (dt | w0 | w1 | a0 | a1 | valid).

    Six separate ``jnp.asarray`` uploads per frame each pay a dispatch; one
    packed transfer keeps the fused LIO frame at a single h2d (see
    pipeline/lidar_inertial_odometry.py).
    """
    return np.concatenate(
        [
            np.asarray(dt, np.float32)[:, None],
            np.asarray(w0, np.float32),
            np.asarray(w1, np.float32),
            np.asarray(a0, np.float32),
            np.asarray(a1, np.float32),
            np.asarray(valid, np.float32)[:, None],
        ],
        axis=1,
    )


def unpack_steps(packed):
    """Inverse of :func:`pack_steps` (jit-traceable)."""
    dt = packed[:, 0]
    w0 = packed[:, 1:4]
    w1 = packed[:, 4:7]
    a0 = packed[:, 7:10]
    a1 = packed[:, 10:13]
    valid = packed[:, 13] > 0.5
    return dt, w0, w1, a0, a1, valid


def steps_from_window(window: Sequence[IMUMeasurement]):
    """Per-step (dt, omega0, omega1, accel0, accel1, valid) arrays from a
    measurement window; drops non-increasing timestamps like the streaming
    integrate() (imu_preintegration.hpp:216-230)."""
    if len(window) < 2:
        z = np.zeros((1, 3), np.float32)
        return (np.zeros(1, np.float32), z, z, z, z, np.zeros(1, bool))
    ts = np.array([m.timestamp for m in window], np.float64)
    gyro = np.stack([m.gyro for m in window]).astype(np.float32)
    accel = np.stack([m.accel for m in window]).astype(np.float32)
    dt = np.diff(ts).astype(np.float32)
    valid = dt > 1e-9
    return dt, gyro[:-1], gyro[1:], accel[:-1], accel[1:], valid


# Cached executable per (params, padded window bucket); params is a frozen
# (hashable) dataclass, so it can be a static argument.
_integrate_steps_jit = jax.jit(integrate_steps, static_argnums=0)


class IMUPreintegration:
    """Streaming wrapper mirroring the reference class API
    (imu_preintegration.hpp:180-339)."""

    def __init__(self, params: IMUPreintegrationParams = IMUPreintegrationParams()):
        self.params = params
        self.reset()

    def reset(self, gyro_bias=None, accel_bias=None, initial_covariance=None, R_world_body=None):
        self.gyro_bias = np.zeros(3, np.float32) if gyro_bias is None else np.asarray(gyro_bias, np.float32)
        self.accel_bias = np.zeros(3, np.float32) if accel_bias is None else np.asarray(accel_bias, np.float32)
        self.R_world_body = (
            np.eye(3, dtype=np.float32) if R_world_body is None else np.asarray(R_world_body, np.float32)
        )
        self._init_cov = initial_covariance
        self._measurements: list = []
        self._state: Optional[PreintegrationState] = None

    def integrate(self, meas: IMUMeasurement):
        if self._measurements and meas.timestamp <= self._measurements[-1].timestamp:
            return
        self._measurements.append(meas)
        self._state = None

    def integrate_batch(self, measurements: Sequence[IMUMeasurement]):
        for m in measurements:
            self.integrate(m)

    @property
    def num_measurements(self) -> int:
        return len(self._measurements)

    def has_measurements(self) -> bool:
        return len(self._measurements) > 0

    def get_raw(self) -> PreintegrationState:
        if self._state is None:
            st = init_state(
                None if self._init_cov is None else jnp.asarray(self._init_cov, jnp.float32)
            )
            # Power-of-two padding: the scan executable is cached per bucket
            # instead of re-traced (and, for the eager path, re-COMPILED)
            # for every distinct window length.
            dt, w0, w1, a0, a1, valid = padded_steps_from_window(self._measurements)
            self._state = _integrate_steps_jit(
                self.params, st,
                jnp.asarray(dt), jnp.asarray(w0), jnp.asarray(w1),
                jnp.asarray(a0), jnp.asarray(a1), jnp.asarray(valid),
                jnp.asarray(self.gyro_bias), jnp.asarray(self.accel_bias),
                jnp.asarray(self.R_world_body),
            )
        return self._state

    def get_corrected(self, gyro_bias, accel_bias) -> PreintegrationState:
        return get_corrected(
            self.get_raw(),
            jnp.asarray(self.gyro_bias), jnp.asarray(self.accel_bias),
            jnp.asarray(gyro_bias, dtype=jnp.float32), jnp.asarray(accel_bias, dtype=jnp.float32),
        )

    def get_dt_total(self) -> float:
        return float(self.get_raw().dt_total)

    def predict_transform(self, T_world_body_i, v_world_i, gyro_bias=None, accel_bias=None):
        c = self._corrected_or_raw(gyro_bias, accel_bias)
        return predict_transform(self.params, c, jnp.asarray(T_world_body_i, dtype=jnp.float32), jnp.asarray(v_world_i, dtype=jnp.float32))

    def predict_relative_transform(self, R_world_body_i, v_world_i, gyro_bias=None, accel_bias=None):
        c = self._corrected_or_raw(gyro_bias, accel_bias)
        return predict_relative_transform(
            self.params, c, jnp.asarray(R_world_body_i, dtype=jnp.float32), jnp.asarray(v_world_i, dtype=jnp.float32)
        )

    def _corrected_or_raw(self, gyro_bias, accel_bias):
        if gyro_bias is None and accel_bias is None:
            return self.get_raw()
        gb = self.gyro_bias if gyro_bias is None else gyro_bias
        ab = self.accel_bias if accel_bias is None else accel_bias
        return self.get_corrected(gb, ab)
