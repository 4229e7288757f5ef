"""Tightly-coupled 15-DOF LiDAR-inertial registration.

Replaces ``algorithms/lio/`` of fateshelled/sycl_points
(lio_registration.hpp:56-694, params at lio_registration_params.hpp:11-53).
The whole solver — per-iteration correspondence search, fused ICP
linearization, reduced-chi-squared ICP weighting, directional information
shaping, IMU prior, 15x15 solve, manifold retraction — runs inside jitted
``lax.while_loop``s (one per robust annealing level), with zero host syncs.

Key pieces:
  * add_icp_factor: embed the 6x6 ICP system into 15x15 with the body->world
    rotation of the translation block (lio_registration.hpp:94-113);
  * directional ICP weighting: eigendecompose the pose blocks, attenuate
    weak/over-confident directions (lio_registration.hpp:144-201);
  * solve_ldlt 15x15 + posterior covariance (lio_registration.hpp:225-238);
  * IMU <-> LiDAR 15x15 covariance frame transforms with lever-arm Jacobians
    (lio_registration.hpp:283-380).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.imu import factor as imu_factor
from sycl_points_tpu.imu.factor import (
    DOF,
    IDX_ACC_BIAS,
    IDX_GYR_BIAS,
    IDX_POS,
    IDX_ROT,
    IDX_VEL,
    State,
    retract,
)
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration import registration as reg_core
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import (
    CriteriaParams,
    DoglegParams,
    GaussNewtonParams,
    LevenbergMarquardtParams,
    RegistrationParams,
    compute_dogleg_step,
)
from sycl_points_tpu.utils import lie
from sycl_points_tpu.utils.eigh3 import eigh3
from sycl_points_tpu.utils.smallmat import solve_psd


@dataclasses.dataclass(frozen=True)
class LIORobustScheduleParams:
    auto_scale: bool = False
    init_scale: float = 10.0
    min_scale: float = 0.5
    rotation_init_scale: float = 10.0
    rotation_min_scale: float = 0.5
    auto_scaling_iter: int = 4


@dataclasses.dataclass(frozen=True)
class DirectionalIcpWeightingParams:
    enable: bool = True
    trans_min_eigenvalue_per_inlier: float = 10.0
    rot_min_eigenvalue_per_inlier: float = 10.0
    trans_weak_direction_scale: float = 0.2
    rot_weak_direction_scale: float = 0.2


@dataclasses.dataclass(frozen=True)
class LIORegistrationParams:
    total_iterations: int = 10
    criteria: CriteriaParams = CriteriaParams()
    optimization_method: str = "gauss_newton"
    gn: GaussNewtonParams = GaussNewtonParams()
    lm: LevenbergMarquardtParams = LevenbergMarquardtParams()
    dogleg: DoglegParams = DoglegParams()
    robust: LIORobustScheduleParams = LIORobustScheduleParams()
    invalid_regularization_factor: float = 1e4
    directional_icp_weighting: DirectionalIcpWeightingParams = DirectionalIcpWeightingParams()


class LIORegistrationResult(NamedTuple):
    state: State
    posterior_covariance: jax.Array  # [15, 15]
    T: jax.Array  # [4, 4]
    iterations: jax.Array
    inlier: jax.Array
    error: jax.Array


# Per-iteration trace columns (align(..., trace=True)) — the 15-DOF
# equivalent of registration.TRACE_COLS (reference verbose mode,
# lio_registration.hpp per-iteration error/inlier prints).
TRACE_COLS = (
    "level",          # robust annealing level
    "error",          # robust ICP cost at linearization
    "inlier",         # correspondence-gate inliers
    "icp_weight",     # reduced-chi^2 ICP weight this iteration
    "lambda_or_radius",  # LM lambda / dogleg radius after the iteration
    "step_rot",       # |rot| block of the APPLIED 15-DOF step
    "step_trans",     # |pos| block
    "step_vel",       # |vel| block
    "step_bg",        # |gyro bias| block
    "step_ba",        # |accel bias| block
    "accepted",       # 1 if the iteration moved the state
    "converged",      # convergence test on this iteration's step
)


def add_icp_factor(H15, b15, icp_H, icp_b, R_world_lidar, weight):
    """Embed the 6x6 ICP system (twist order [rot, trans]) into the 15-D
    error state (lio_registration.hpp:94-113)."""
    R = R_world_lidar
    H = H15
    H = H.at[IDX_ROT : IDX_ROT + 3, IDX_ROT : IDX_ROT + 3].add(weight * icp_H[0:3, 0:3])
    H = H.at[IDX_POS : IDX_POS + 3, IDX_POS : IDX_POS + 3].add(
        weight * (R @ icp_H[3:6, 3:6] @ R.T)
    )
    H = H.at[IDX_POS : IDX_POS + 3, IDX_ROT : IDX_ROT + 3].add(weight * (R @ icp_H[3:6, 0:3]))
    H = H.at[IDX_ROT : IDX_ROT + 3, IDX_POS : IDX_POS + 3].add(weight * (icp_H[0:3, 3:6] @ R.T))
    b = b15
    b = b.at[IDX_ROT : IDX_ROT + 3].add(weight * icp_b[0:3])
    b = b.at[IDX_POS : IDX_POS + 3].add(weight * (R @ icp_b[3:6]))
    return H, b


def _block_filter(H_block, min_eig_per_inlier, weak_scale, inlier_f):
    """sqrt-scaled eigen filter of a 3x3 information block
    (lio_registration.hpp:160-180)."""
    lam, V = eigh3(0.5 * (H_block + H_block.T))
    lam = jnp.maximum(lam, 0.0)
    min_info = jnp.maximum(min_eig_per_inlier, 0.0) * inlier_f
    ws = jnp.clip(weak_scale, 0.0, 1.0)
    ratio = jnp.clip(lam / jnp.maximum(min_info, 1e-30), 0.0, 1.0)
    scale = jnp.where(lam <= 0.0, 0.0, jnp.maximum(ws, ratio))
    scale = jnp.where(min_info > 0.0, scale, jnp.where(lam <= 0.0, 0.0, 1.0))
    return jnp.einsum("ik,k,jk->ij", V, jnp.sqrt(jnp.clip(scale, 0.0, 1.0)), V, precision="highest")


def apply_directional_icp_weighting(H15, b15, inlier, params: DirectionalIcpWeightingParams):
    """Attenuate weak pose directions of the ICP-only factor
    (lio_registration.hpp:144-201)."""
    if not params.enable:
        return H15, b15
    inlier_f = inlier.astype(jnp.float32)

    Hp = jnp.zeros((6, 6), jnp.float32)
    Hp = Hp.at[0:3, 0:3].set(H15[IDX_POS : IDX_POS + 3, IDX_POS : IDX_POS + 3])
    Hp = Hp.at[0:3, 3:6].set(H15[IDX_POS : IDX_POS + 3, IDX_ROT : IDX_ROT + 3])
    Hp = Hp.at[3:6, 0:3].set(H15[IDX_ROT : IDX_ROT + 3, IDX_POS : IDX_POS + 3])
    Hp = Hp.at[3:6, 3:6].set(H15[IDX_ROT : IDX_ROT + 3, IDX_ROT : IDX_ROT + 3])
    Hp = 0.5 * (Hp + Hp.T)
    bp = jnp.concatenate([b15[IDX_POS : IDX_POS + 3], b15[IDX_ROT : IDX_ROT + 3]])

    f_t = _block_filter(
        Hp[0:3, 0:3], params.trans_min_eigenvalue_per_inlier,
        params.trans_weak_direction_scale, inlier_f,
    )
    f_r = _block_filter(
        Hp[3:6, 3:6], params.rot_min_eigenvalue_per_inlier,
        params.rot_weak_direction_scale, inlier_f,
    )
    F = jnp.zeros((6, 6), jnp.float32).at[0:3, 0:3].set(f_t).at[3:6, 3:6].set(f_r)
    Hf = F @ Hp @ F
    bf = F @ (F @ bp)

    active = inlier > 0
    Hf = jnp.where(active, Hf, Hp)
    bf = jnp.where(active, bf, bp)

    H = H15
    H = H.at[IDX_POS : IDX_POS + 3, IDX_POS : IDX_POS + 3].set(Hf[0:3, 0:3])
    H = H.at[IDX_POS : IDX_POS + 3, IDX_ROT : IDX_ROT + 3].set(Hf[0:3, 3:6])
    H = H.at[IDX_ROT : IDX_ROT + 3, IDX_POS : IDX_POS + 3].set(Hf[3:6, 0:3])
    H = H.at[IDX_ROT : IDX_ROT + 3, IDX_ROT : IDX_ROT + 3].set(Hf[3:6, 3:6])
    b = b15.at[IDX_POS : IDX_POS + 3].set(bf[0:3]).at[IDX_ROT : IDX_ROT + 3].set(bf[3:6])
    return H, b


def solve_ldlt_15(H, b):
    """(delta, ok): solve H d = -b; zero on PD failure
    (lio_registration.hpp:225-238)."""
    return solve_psd(H, -b)


def imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar):
    """delta_x_lidar = J delta_x_imu (lio_registration.hpp:283-330)."""
    J = jnp.eye(DOF, dtype=jnp.float32)
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = R_world_lidar @ R_li
    J = J.at[IDX_ROT : IDX_ROT + 3, IDX_ROT : IDX_ROT + 3].set(R_li)
    J = J.at[IDX_POS : IDX_POS + 3, IDX_ROT : IDX_ROT + 3].set(
        -R_world_imu @ lie.skew(t_lidar_in_imu)
    )
    return J


def transform_covariance_imu_to_lidar(P_imu, T_imu_to_lidar, R_world_lidar):
    J = imu_to_lidar_jacobian(T_imu_to_lidar, R_world_lidar)
    return J @ P_imu @ J.T


def transform_covariance_lidar_to_imu(P_lidar, T_imu_to_lidar, R_world_lidar):
    """Analytic block inverse of the Jacobian (lio_registration.hpp:345-380)."""
    Jinv = jnp.eye(DOF, dtype=jnp.float32)
    R_li = T_imu_to_lidar[:3, :3]
    t_lidar_in_imu = lie.transform_inverse(T_imu_to_lidar)[:3, 3]
    R_world_imu = R_world_lidar @ R_li
    Jinv = Jinv.at[IDX_ROT : IDX_ROT + 3, IDX_ROT : IDX_ROT + 3].set(R_li.T)
    Jinv = Jinv.at[IDX_POS : IDX_POS + 3, IDX_ROT : IDX_ROT + 3].set(
        R_world_imu @ lie.skew(t_lidar_in_imu) @ R_li.T
    )
    return Jinv @ P_lidar @ Jinv.T


def _level_schedule(params: LIORegistrationParams, factor: RegistrationParams):
    """(iterations_per_level, geo_scales, rot_scales) — static python
    (lio_registration.hpp:444-478)."""
    rp = params.robust
    auto = (
        rp.auto_scale
        and params.total_iterations > 0
        and factor.robust.type is not RobustLossType.NONE
        and 0.0 < rp.min_scale < rp.init_scale
        and 0.0 < rp.rotation_min_scale < rp.rotation_init_scale
        and rp.auto_scaling_iter > 0
    )
    levels = min(rp.auto_scaling_iter, params.total_iterations) if auto else 1
    base = params.total_iterations // levels
    extra = params.total_iterations % levels
    iters = [base + (1 if lvl < extra else 0) for lvl in range(levels)]
    if not auto:
        return iters, [factor.robust.default_scale], [factor.rotation_constraint.robust_scale]
    f = (rp.min_scale / rp.init_scale) ** (1.0 / (levels - 1)) if levels > 1 else 1.0
    fr = (rp.rotation_min_scale / rp.rotation_init_scale) ** (1.0 / (levels - 1)) if levels > 1 else 1.0
    return (
        iters,
        [rp.init_scale * f**i for i in range(levels)],
        [rp.rotation_init_scale * fr**i for i in range(levels)],
    )


def align(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    predicted_state: State,
    predicted_covariance: jax.Array,
    previous_posterior_covariance: jax.Array,
    factor_params: RegistrationParams = RegistrationParams(reg_type=RegType.GICP),
    params: LIORegistrationParams = LIORegistrationParams(),
    update_bias: bool | jax.Array = True,
    trace: bool = False,
):
    """LIORegistration::align (lio_registration.hpp:396-694). Jittable.

    ``trace=True`` (static) also returns a ``[total_iterations,
    len(TRACE_COLS)]`` per-iteration trace (NaN rows = not executed):
    ``(result, trace)`` instead of ``result``.
    """
    H_imu, b_imu0, imu_valid = imu_factor.compute_imu_hessian_gradient(
        predicted_state, predicted_state, predicted_covariance
    )
    initial_pose = predicted_state.pose()
    icp_residual_dim = (
        1.0
        if factor_params.reg_type in (RegType.POINT_TO_PLANE, RegType.GENZ)
        else 3.0
    )

    src_covs_reg, tgt = reg_core._precompute_targets(factor_params, source, target)
    src_pts, src_mask = source.points, source.mask
    update_bias = jnp.asarray(update_bias)
    def imu_cost(state: State):
        r = imu_factor.compute_manifold_residual(predicted_state, state)
        return jnp.where(imu_valid, 0.5 * jnp.dot(r, H_imu @ r), 0.0)

    def bias_freeze(delta):
        z = jnp.zeros(3, jnp.float32)
        frozen = delta.at[IDX_ACC_BIAS : IDX_ACC_BIAS + 3].set(z).at[
            IDX_GYR_BIAS : IDX_GYR_BIAS + 3
        ].set(z)
        return jnp.where(update_bias, delta, frozen)

    def is_converged(delta):
        return (
            jnp.linalg.norm(delta[IDX_ROT : IDX_ROT + 3]) < params.criteria.rotation
        ) & (jnp.linalg.norm(delta[IDX_POS : IDX_POS + 3]) < params.criteria.translation)

    iters_per_level, geo_scales, rot_scales = _level_schedule(params, factor_params)

    class Carry(NamedTuple):
        state: State
        it: jax.Array
        done: jax.Array
        lm_lambda: jax.Array
        radius: jax.Array
        H_undamped: jax.Array
        has_H: jax.Array
        last_inlier: jax.Array
        last_error: jax.Array

    def make_body(geo_scale, rot_scale, level_idx=0):
        geo_s = jnp.float32(geo_scale)
        rot_s = jnp.float32(rot_scale)

        def frozen_icp_cost(state: State, corr, alpha, icp_weight):
            err, _ = reg_core._error_at(
                factor_params, state.pose(), src_pts, src_covs_reg, corr, geo_s, alpha
            )
            return icp_weight * err

        def body(c: Carry) -> Carry:
            pose = c.state.pose()
            corr = reg_core._correspondences(factor_params, target_knn, src_pts, src_mask, pose, tgt)
            alpha = (
                reg_core._genz_alpha(corr)
                if factor_params.reg_type is RegType.GENZ
                else jnp.float32(1.0)
            )
            lin = reg_core._linearize(factor_params, pose, src_pts, src_covs_reg, corr, geo_s, alpha)
            if factor_params.rotation_constraint.enable:
                from sycl_points_tpu.registration import rotation_constraint as _rotc

                lin = _rotc.add_rotation_constraint(
                    factor_params, lin, pose, source.covs, corr, rot_s
                )
            if factor_params.degenerate_reg is not None:
                from sycl_points_tpu.registration import degenerate as _degen

                lin = _degen.regularize(factor_params.degenerate_reg, lin, pose, initial_pose)

            b_imu = imu_factor.compute_imu_gradient(predicted_state, c.state, H_imu)

            icp_dof = icp_residual_dim * lin.inlier.astype(jnp.float32) - 6.0
            icp_weight = jnp.where(
                (icp_dof > 0.0) & jnp.isfinite(lin.error) & (lin.error >= 0.0),
                1.0 / jnp.maximum(1.0, 2.0 * lin.error / jnp.maximum(icp_dof, 1.0)),
                1.0,
            )

            H15 = jnp.zeros((DOF, DOF), jnp.float32)
            b15 = jnp.zeros((DOF,), jnp.float32)
            H15, b15 = add_icp_factor(H15, b15, lin.H, lin.b, c.state.rotation, icp_weight)
            H15, b15 = apply_directional_icp_weighting(
                H15, b15, lin.inlier, params.directional_icp_weighting
            )

            reg_diag = jnp.zeros((DOF,), jnp.float32)
            for idx in (IDX_VEL, IDX_ACC_BIAS, IDX_GYR_BIAS):
                reg_diag = reg_diag.at[idx : idx + 3].set(params.invalid_regularization_factor)
            H15 = jnp.where(imu_valid, H15 + H_imu, H15 + jnp.diag(reg_diag))
            b15 = jnp.where(imu_valid, b15 + b_imu, b15)

            I15 = jnp.eye(DOF, dtype=jnp.float32)
            method = params.optimization_method

            if method == "gauss_newton":
                delta, ok = solve_psd(H15 + params.gn.lambda_ * I15, -b15)
                delta = bias_freeze(delta)
                accepted = ok
                stop = ~ok
                new_state = retract(c.state, delta)
                lm_next, radius_next = c.lm_lambda, c.radius
            elif method == "levenberg_marquardt":
                # Parallel-candidate LM (see registration.py): all damping
                # candidates evaluated in one batched pass, first-improving
                # selected — identical to the sequential reference loop
                # (lio_registration.hpp:552-584) with 1 sequential round.
                p = params.lm
                cur_cost = frozen_icp_cost(c.state, corr, alpha, icp_weight) + imu_cost(c.state)
                C = p.max_inner_iterations
                lams = jnp.clip(
                    c.lm_lambda * (p.lambda_factor ** jnp.arange(C, dtype=jnp.float32)),
                    p.min_lambda, p.max_lambda,
                )

                def trial_fn(lam):
                    d, ok = solve_psd(H15 + lam * I15, -b15)
                    d = bias_freeze(d)
                    tr = retract(c.state, d)
                    cost = frozen_icp_cost(tr, corr, alpha, icp_weight) + imu_cost(tr)
                    return d, ok, cost

                ds, oks, costs = jax.vmap(trial_fn)(lams)
                acc = oks & (costs <= cur_cost)
                any_acc = jnp.any(acc)
                idx = jnp.argmax(acc)
                delta = jnp.where(any_acc, ds[idx], jnp.zeros(DOF, jnp.float32))
                accepted = any_acc
                stop = ~accepted
                new_state = retract(c.state, delta)
                lam_exhausted = jnp.clip(
                    c.lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda
                )
                lm_next = jnp.where(
                    any_acc,
                    jnp.clip(lams[idx] / p.lambda_factor, p.min_lambda, p.max_lambda),
                    lam_exhausted,
                )
                radius_next = c.radius
            elif method == "powell_dogleg":
                p = params.dogleg
                cur_cost = frozen_icp_cost(c.state, corr, alpha, icp_weight) + imu_cost(c.state)
                radius = jnp.clip(c.radius, p.min_trust_region_radius, p.max_trust_region_radius)
                step, step_norm, _ = compute_dogleg_step(H15, b15, radius)
                step = bias_freeze(step)
                pred = -(jnp.dot(b15, step) + 0.5 * jnp.dot(step, H15 @ step))
                trial = retract(c.state, step)
                cost = frozen_icp_cost(trial, corr, alpha, icp_weight) + imu_cost(trial)
                rho = (cur_cost - cost) / jnp.maximum(pred, 1e-30)
                reject = (pred <= 0.0) | (rho < p.eta1)
                grow = (rho > p.eta2) & (step_norm >= radius * 0.99)
                radius_next = jnp.clip(
                    jnp.where(reject, radius * p.gamma_decrease,
                              jnp.where(grow, radius * p.gamma_increase, radius)),
                    p.min_trust_region_radius, p.max_trust_region_radius,
                )
                delta = jnp.where(reject, jnp.zeros(DOF, jnp.float32), step)
                accepted = ~reject
                stop = jnp.bool_(False)
                new_state = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(reject, a, b), c.state, retract(c.state, step)
                )
                lm_next = c.lm_lambda
            else:
                raise ValueError(method)

            done = jnp.where(accepted, is_converged(delta), c.done) | stop
            out_state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accepted, new, old), new_state, c.state
            )
            out = Carry(
                state=out_state, it=c.it + 1, done=done,
                lm_lambda=lm_next, radius=radius_next,
                H_undamped=H15, has_H=jnp.bool_(True),
                last_inlier=lin.inlier, last_error=lin.error,
            )
            if method == "powell_dogleg":
                damping_tr = radius_next
            elif method == "gauss_newton":
                damping_tr = jnp.float32(params.gn.lambda_)
            else:
                damping_tr = lm_next
            f32 = lambda v: jnp.asarray(v, jnp.float32)
            applied = jnp.where(accepted, delta, jnp.zeros(DOF, jnp.float32))
            nrm = lambda i: jnp.linalg.norm(applied[i : i + 3])
            row = jnp.stack([
                f32(level_idx), f32(lin.error), f32(lin.inlier), f32(icp_weight),
                f32(damping_tr), nrm(IDX_ROT), nrm(IDX_POS), nrm(IDX_VEL),
                nrm(IDX_GYR_BIAS), nrm(IDX_ACC_BIAS),
                f32(accepted), f32(jnp.where(accepted, is_converged(delta), False)),
            ])
            return out, row

        return body

    carry = Carry(
        state=predicted_state, it=jnp.int32(0), done=jnp.bool_(False),
        lm_lambda=jnp.float32(params.lm.init_lambda),
        radius=jnp.float32(params.dogleg.initial_trust_region_radius),
        H_undamped=jnp.zeros((DOF, DOF), jnp.float32), has_H=jnp.bool_(False),
        last_inlier=jnp.int32(0), last_error=jnp.float32(0.0),
    )
    trace_buf = (
        jnp.full((max(params.total_iterations, 1), len(TRACE_COLS)), jnp.nan, jnp.float32)
        if trace
        else None
    )
    it_base = 0
    for lvl, (n_iters, gs, rs) in enumerate(zip(iters_per_level, geo_scales, rot_scales)):
        body = make_body(gs, rs, lvl)
        limit = it_base + n_iters
        carry = carry._replace(
            done=jnp.bool_(False),
            lm_lambda=jnp.float32(params.lm.init_lambda),
            radius=jnp.float32(params.dogleg.initial_trust_region_radius),
        )
        if trace:
            def body_tr(cb, _body=body):
                c, buf = cb
                c2, row = _body(c)
                return c2, buf.at[c.it].set(row)

            carry, trace_buf = jax.lax.while_loop(
                lambda cb, _limit=limit: (cb[0].it < _limit) & ~cb[0].done,
                body_tr, (carry, trace_buf),
            )
        else:
            carry = jax.lax.while_loop(
                lambda c, _limit=limit: (c.it < _limit) & ~c.done,
                lambda c: body(c)[0], carry,
            )
        carry = carry._replace(it=jnp.maximum(carry.it, limit))
        it_base = limit

    # Posterior covariance: H^-1, damped retry, else previous (hpp:664-688).
    P1, ok1 = solve_psd(carry.H_undamped, jnp.eye(DOF, dtype=jnp.float32))
    P2, ok2 = solve_psd(
        carry.H_undamped + 1e-4 * jnp.eye(DOF, dtype=jnp.float32),
        jnp.eye(DOF, dtype=jnp.float32),
    )
    P_post = jnp.where(
        carry.has_H & ok1, P1,
        jnp.where(carry.has_H & ok2, P2, previous_posterior_covariance),
    )

    result = LIORegistrationResult(
        state=carry.state,
        posterior_covariance=P_post,
        T=carry.state.pose(),
        iterations=carry.it,
        inlier=carry.last_inlier,
        error=carry.last_error,
    )
    return (result, trace_buf) if trace else result
