"""Core ICP registration solver: fully on-device align loop.

Replaces ``algorithms/registration/registration.hpp`` of
fateshelled/sycl_points.  Key architectural difference from the reference:
the reference alternates device kernels (KNN, fused linearize-reduce) with
host logic (6x6 LDLT, LM/dogleg bookkeeping), paying a device<->host sync
per ICP iteration (registration.hpp:201-276).  Here the *entire* align loop
— per-iteration correspondence search, linearization, robust weighting,
reduction, 6x6 solve, optimizer bookkeeping, convergence test — is one
``lax.while_loop`` inside one jitted XLA computation: zero host round trips.

Parity map:
  * params/defaults            -> registration_params.hpp:17-114
  * fused linearize+reduce     -> registration.hpp:513-676 (here: whitened
                                  rows + two matmuls)
  * GenZ adaptive alpha        -> registration.hpp:464-511
  * frozen-correspondence error-only reduction for LM/dogleg acceptance
                               -> registration.hpp:678-789
  * optimize_gauss_newton      -> registration.hpp:803-828
  * optimize_levenberg_marquardt -> registration.hpp:830-895
  * optimize_powell_dogleg     -> registration.hpp:897-964
  * compute_dogleg_step        -> dogleg_step.hpp:36-...
  * compute_icp_robust_weights -> registration.hpp:412-462
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.factors import (
    RegType,
    genz_planarity,
    residual_norms_only,
    whitened_rows,
)
from sycl_points_tpu.ops.robust import RobustLossType, compute_error, compute_weight
from sycl_points_tpu.utils import lie
from sycl_points_tpu.utils.eigh3 import plane_regularize
from sycl_points_tpu.utils.smallmat import solve_psd


# --------------------------------------------------------------------------
# Parameters (static under jit; defaults match registration_params.hpp)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RobustParams:
    type: RobustLossType = RobustLossType.NONE
    default_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class RotationConstraintParams:
    enable: bool = False
    weight: float = 1.0
    robust_scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class GaussNewtonParams:
    lambda_: float = 1.0


@dataclasses.dataclass(frozen=True)
class LevenbergMarquardtParams:
    max_inner_iterations: int = 10
    lambda_factor: float = 2.0
    init_lambda: float = 1.0
    max_lambda: float = 1e3
    min_lambda: float = 1e-6


@dataclasses.dataclass(frozen=True)
class DoglegParams:
    initial_trust_region_radius: float = 1.0
    min_trust_region_radius: float = 1e-4
    max_trust_region_radius: float = 10.0
    eta1: float = 0.25
    eta2: float = 0.75
    gamma_decrease: float = 0.25
    gamma_increase: float = 2.0


@dataclasses.dataclass(frozen=True)
class CriteriaParams:
    translation: float = 1e-3  # [m]
    rotation: float = 1e-3  # [rad]


@dataclasses.dataclass(frozen=True)
class RegistrationParams:
    reg_type: RegType = RegType.GICP
    max_correspondence_distance: float = 2.0
    # Coarse-to-fine correspondence schedule (off by default): the first
    # ``coarse_to_fine_iters`` TOTAL iterations search every
    # ``coarse_stride``-th target point (robust annealing tolerates the
    # approximate matches), later iterations search the full target.
    # Convergence cannot fire during the coarse phase, so the final pose is
    # always refined on exact full-target correspondences.  A large-cloud
    # speed knob: the per-iteration nn1 search is the full-cloud GICP
    # bottleneck (reference hot loop registration.hpp:201-276).
    coarse_to_fine_iters: int = 0
    coarse_stride: int = 4
    robust: RobustParams = RobustParams()
    rotation_constraint: RotationConstraintParams = RotationConstraintParams()
    genz_planarity_threshold: float = 0.2
    optimization_method: str = "gauss_newton"  # gauss_newton | levenberg_marquardt | powell_dogleg
    gn: GaussNewtonParams = GaussNewtonParams()
    lm: LevenbergMarquardtParams = LevenbergMarquardtParams()
    dogleg: DoglegParams = DoglegParams()
    max_iterations: int = 20
    criteria: CriteriaParams = CriteriaParams()
    # Plugged-in extensions (set by higher layers):
    degenerate_reg: Optional[Any] = None  # DegenerateRegularizationParams
    map_prior_enable: bool = False


class LinearizedResult(NamedTuple):
    H: jax.Array  # [6, 6]
    b: jax.Array  # [6]
    error: jax.Array  # scalar robust cost
    inlier: jax.Array  # scalar int32


class RegistrationResult(NamedTuple):
    T: jax.Array  # [4, 4]
    converged: jax.Array
    iterations: jax.Array
    H: jax.Array
    b: jax.Array
    error: jax.Array
    inlier: jax.Array
    H_raw: jax.Array  # pre-regularization/prior linearization (for MAP prior)
    b_raw: jax.Array
    error_raw: jax.Array


# Column layout of the per-iteration trace buffer (align(..., trace=True)):
# the on-device equivalent of the reference's verbose per-iteration print of
# error/inlier/lambda/rho (registration.hpp:821-827, 856-864, 938-946).
# Rows beyond the executed iteration count stay NaN.
TRACE_COLS = (
    "level",          # robust annealing level index
    "error",          # robust cost after the step (accepted candidate's)
    "inlier",         # correspondence-gate inliers at linearization
    "lambda_or_radius",  # LM lambda / dogleg trust radius / GN lambda
    "step_rot",       # |rot| of the APPLIED step twist (0 when rejected)
    "step_trans",     # |trans| of the applied step twist
    "accepted",       # 1 if the iteration moved the pose
    "converged",      # convergence test on this iteration's step
)


class _Targets(NamedTuple):
    """Pose-independent per-alignment precomputation (one-time, not per
    iteration as in the reference).  ``packed``/``layout`` hold all
    attributes flattened into one [M, F] matrix so the hot loop does a
    single gather."""

    points: jax.Array
    mask: jax.Array
    covs_reg: Optional[jax.Array]
    covs_raw: Optional[jax.Array]
    normals: Optional[jax.Array]
    planar: Optional[jax.Array]
    packed: Optional[jax.Array] = None
    layout: tuple = ()


def _pack_targets(tgt: _Targets) -> _Targets:
    """Flatten present attributes into one [M, F] gather matrix."""
    cols = [tgt.points]
    layout = []
    if tgt.covs_reg is not None:
        cols.append(tgt.covs_reg.reshape(-1, 9))
        layout.append(("covs_reg", 9))
    if tgt.covs_raw is not None:
        cols.append(tgt.covs_raw.reshape(-1, 9))
        layout.append(("covs_raw", 9))
    if tgt.normals is not None:
        cols.append(tgt.normals)
        layout.append(("normals", 3))
    if tgt.planar is not None:
        cols.append(tgt.planar.astype(jnp.float32)[:, None])
        layout.append(("planar", 1))
    if not layout:
        return tgt
    return tgt._replace(packed=jnp.concatenate(cols, axis=1), layout=tuple(layout))


def _precompute_targets(params: RegistrationParams, source: PointCloud, target: PointCloud):
    reg = params.reg_type
    src_covs_reg = None
    tgt = _Targets(target.points, target.mask, None, None, None, None)
    if reg is RegType.GICP:
        if source.covs is None or target.covs is None:
            raise ValueError("GICP requires source and target covariances")
        src_covs_reg = plane_regularize(source.covs)
        tgt = tgt._replace(covs_reg=plane_regularize(target.covs))
    elif reg is RegType.POINT_TO_DISTRIBUTION:
        if target.covs is None:
            raise ValueError("POINT_TO_DISTRIBUTION requires target covariances")
        tgt = tgt._replace(covs_raw=target.covs)
    elif reg is RegType.POINT_TO_PLANE:
        if target.normals is None:
            raise ValueError("POINT_TO_PLANE requires target normals")
        tgt = tgt._replace(normals=target.normals)
    elif reg is RegType.GENZ:
        if target.normals is None or target.covs is None:
            raise ValueError("GENZ requires target normals and covariances")
        tgt = tgt._replace(
            normals=target.normals,
            planar=genz_planarity(target.covs, params.genz_planarity_threshold),
        )
    if params.rotation_constraint.enable:
        # The constraint term uses the raw (unregularized) covariances of both
        # clouds (registration.hpp:612, validate at registration.hpp:178-184).
        if source.covs is None or target.covs is None:
            raise ValueError("rotation constraint requires source and target covariances")
        tgt = tgt._replace(covs_raw=target.covs)
    return src_covs_reg, _pack_targets(tgt)


def _gather(arr, idx):
    return None if arr is None else arr[idx]


def _correspondences(params, knn, src_pts, src_mask, T, tgt: _Targets):
    """One NN search with the pose folded into the queries (knn.hpp:44)."""
    res = knn.search(src_pts, 1, pose=T)
    return _gather_correspondences(
        params, res.indices[:, 0], res.distances[:, 0], src_mask, tgt
    )


def _gather_correspondences(params, idx, d2, src_mask, tgt: _Targets):
    """Gather target rows for precomputed nearest indices.

    All target attributes are packed into ONE [M, F] matrix before the align
    loop (see _pack_targets) so the per-iteration gather is a single fused
    kernel instead of one gather per attribute.
    """
    max_d2 = params.max_correspondence_distance**2
    corr_mask = src_mask & (d2 <= max_d2)

    if tgt.packed is not None:
        flat = tgt.packed[idx]  # single gather [N, F]
        out = {"points": flat[:, 0:3], "mask": corr_mask}
        col = 3
        for name, width in tgt.layout:
            block = flat[:, col : col + width]
            col += width
            if name == "planar":
                out[name] = block[:, 0] > 0.5
            elif width == 9:
                out[name] = block.reshape(-1, 3, 3)
            elif width == 3:
                out[name] = block
            else:
                out[name] = block[:, 0]
        return _Targets(
            points=out["points"], mask=corr_mask,
            covs_reg=out.get("covs_reg"), covs_raw=out.get("covs_raw"),
            normals=out.get("normals"), planar=out.get("planar"),
        )

    return _Targets(
        points=tgt.points[idx],
        mask=corr_mask,
        covs_reg=_gather(tgt.covs_reg, idx),
        covs_raw=_gather(tgt.covs_raw, idx),
        normals=_gather(tgt.normals, idx),
        planar=_gather(tgt.planar, idx),
    )


def _genz_alpha(corr: _Targets):
    """Planar fraction among inliers (registration.hpp:464-511)."""
    inl = jnp.sum(corr.mask)
    pl = jnp.sum(corr.mask & corr.planar)
    return jnp.where(inl > 0, pl.astype(jnp.float32) / jnp.maximum(inl, 1).astype(jnp.float32), 1.0)


def _linearize(params: RegistrationParams, T, src_pts, src_covs_reg, corr: _Targets,
               robust_scale, genz_alpha) -> LinearizedResult:
    rows = whitened_rows(
        params.reg_type,
        T,
        src_pts,
        corr.points,
        src_covs_reg=src_covs_reg,
        tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw,
        tgt_normals=corr.normals,
        genz_planar=corr.planar,
        genz_alpha=genz_alpha,
    )
    w_rob = compute_weight(params.robust.type, rows.residual_norm, robust_scale)
    m = corr.mask.astype(src_pts.dtype)
    scale = jnp.sqrt(w_rob * rows.genz_weight) * m

    A = (rows.A * scale[:, None, None]).reshape(-1, 6)
    c = (rows.c * scale[:, None]).reshape(-1)
    H = jnp.dot(A.T, A, precision="highest", preferred_element_type=jnp.float32)
    b = jnp.dot(A.T, c, precision="highest", preferred_element_type=jnp.float32)
    err = jnp.sum(
        m * rows.genz_weight * compute_error(params.robust.type, rows.residual_norm, robust_scale)
    )
    inlier = jnp.sum(corr.mask.astype(jnp.int32))
    return LinearizedResult(H, b, err, inlier)


def _error_at(params: RegistrationParams, T, src_pts, src_covs_reg, corr: _Targets,
              robust_scale, genz_alpha):
    """Robust error + inliers at pose ``T`` over *frozen* correspondences
    (registration.hpp:678-789)."""
    rn, gw = residual_norms_only(
        params.reg_type,
        T,
        src_pts,
        corr.points,
        src_covs_reg=src_covs_reg,
        tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw,
        tgt_normals=corr.normals,
        genz_planar=corr.planar,
        genz_alpha=genz_alpha,
    )
    m = corr.mask.astype(src_pts.dtype)
    err = jnp.sum(m * gw * compute_error(params.robust.type, rn, robust_scale))
    inlier = jnp.sum(corr.mask.astype(jnp.int32))
    return err, inlier


def _is_converged(params: RegistrationParams, delta):
    dr = jnp.linalg.norm(delta[:3])
    dt = jnp.linalg.norm(delta[3:])
    return (dt < params.criteria.translation) & (dr < params.criteria.rotation)


def compute_dogleg_step(H, g, radius):
    """Powell dogleg step for ``H p = -g`` inside a trust region
    (dogleg_step.hpp:36-...).  Returns (p, step_norm, predicted_reduction)."""
    n = g.shape[0]
    p_gn, gn_ok = solve_psd(H, -g)
    norm_gn = jnp.linalg.norm(p_gn)
    gn_ok = gn_ok & jnp.isfinite(norm_gn)

    g_sq = jnp.dot(g, g)
    Hg = H @ g
    gHg = jnp.dot(g, Hg)
    alpha = jnp.where(gHg > jnp.finfo(jnp.float32).eps, g_sq / jnp.maximum(gHg, 1e-30), 1.0)
    alpha = jnp.where(jnp.isfinite(alpha), alpha, 1.0)
    p_sd = -alpha * g
    norm_sd = jnp.linalg.norm(p_sd)

    # Blend point on the trust-region boundary.
    diff = p_gn - p_sd
    a = jnp.dot(diff, diff)
    bq = 2.0 * jnp.dot(p_sd, diff)
    cq = jnp.dot(p_sd, p_sd) - radius * radius
    disc = jnp.maximum(bq * bq - 4.0 * a * cq, 0.0)
    tau = jnp.where(a > jnp.finfo(jnp.float32).eps, (-bq + jnp.sqrt(disc)) / jnp.maximum(2.0 * a, 1e-30), 0.0)
    tau = jnp.clip(tau, 0.0, 1.0)
    p_blend = p_sd + tau * diff

    sd_clipped = jnp.where(norm_sd > 1e-30, (radius / jnp.maximum(norm_sd, 1e-30)) * p_sd, p_sd * 0.0)

    p = jnp.where(
        gn_ok & (norm_gn <= radius),
        p_gn,
        jnp.where(
            norm_sd >= radius,
            sd_clipped,
            jnp.where(gn_ok, p_blend, jnp.where(norm_sd > radius, sd_clipped, p_sd)),
        ),
    )
    step_norm = jnp.linalg.norm(p)
    pred = -(jnp.dot(g, p) + 0.5 * jnp.dot(p, H @ p))
    return p, step_norm, pred


class _LoopState(NamedTuple):
    T: jax.Array
    it: jax.Array  # iterations within the current robust level
    total_it: jax.Array
    level: jax.Array  # robust annealing level index
    finished: jax.Array
    converged: jax.Array
    lm_lambda: jax.Array
    trust_radius: jax.Array
    H: jax.Array
    b: jax.Array
    error: jax.Array
    inlier: jax.Array
    H_raw: jax.Array
    b_raw: jax.Array
    error_raw: jax.Array


def align(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationParams = RegistrationParams(),
    initial_guess: Optional[jax.Array] = None,
    robust_scale: Optional[jax.Array] = None,
    rotation_robust_scale: Optional[jax.Array] = None,
    map_prior=None,
    robust_schedule: Optional[tuple] = None,
    trace: bool = False,
):
    """Run ICP (Registration::align, registration.hpp:201-276). Jittable.

    ``robust_schedule`` (static tuple of (geometry_scale, rotation_scale)
    pairs) runs the full robust-annealing chain of the reference
    RobustAligner inside ONE while loop: each level runs <= max_iterations
    from the previous level's pose with fresh optimizer state — identical
    semantics to chained align() calls, but a single compiled loop (program
    size and per-call overhead are the dominant costs).

    ``trace=True`` (static) additionally returns a fixed-size
    ``[max_iterations * n_levels, len(TRACE_COLS)]`` per-iteration trace
    buffer — the equivalent of the reference's verbose mode
    (registration.hpp:821-827, 856-864, 938-946); unexecuted rows are NaN.
    Returns ``RegistrationResult`` when False, ``(result, trace)`` when True.
    """
    T0 = jnp.eye(4, dtype=jnp.float32) if initial_guess is None else initial_guess
    if robust_schedule:
        geo_scales = jnp.asarray([g for g, _ in robust_schedule], jnp.float32)
        rot_scales = jnp.asarray([r for _, r in robust_schedule], jnp.float32)
        n_levels = len(robust_schedule)
    else:
        geo_scales = jnp.asarray(
            [params.robust.default_scale if robust_scale is None else robust_scale],
            jnp.float32,
        )
        rot_scales = jnp.asarray(
            [
                params.rotation_constraint.robust_scale
                if rotation_robust_scale is None
                else rotation_robust_scale
            ],
            jnp.float32,
        )
        n_levels = 1

    src_covs_reg, tgt = _precompute_targets(params, source, target)
    src_pts, src_mask = source.points, source.mask

    from sycl_points_tpu.registration import degenerate as _degen
    from sycl_points_tpu.registration import rotation_constraint as _rotc

    # Coarse-to-fine correspondence: a strided target subset for the first
    # coarse_to_fine_iters total iterations (see RegistrationParams).
    cf_iters = params.coarse_to_fine_iters
    use_cf = cf_iters > 0 and hasattr(target_knn, "points")
    if use_cf:
        stride = params.coarse_stride
        knn_coarse = type(target_knn)(
            points=target_knn.points[::stride],
            mask=target_knn.mask[::stride],
        )

    def iteration_core(T, r_scale, rot_scale_, total_it):
        if use_cf:
            def c_coarse(_):
                res = knn_coarse.search(src_pts, 1, pose=T)
                return res.indices[:, 0] * stride, res.distances[:, 0]

            def c_fine(_):
                res = target_knn.search(src_pts, 1, pose=T)
                return res.indices[:, 0], res.distances[:, 0]

            idx, d2 = jax.lax.cond(total_it < cf_iters, c_coarse, c_fine, None)
            corr = _gather_correspondences(params, idx, d2, src_mask, tgt)
        else:
            corr = _correspondences(params, target_knn, src_pts, src_mask, T, tgt)
        alpha = _genz_alpha(corr) if params.reg_type is RegType.GENZ else jnp.float32(1.0)
        lin = _linearize(params, T, src_pts, src_covs_reg, corr, r_scale, alpha)
        if params.rotation_constraint.enable:
            lin = _rotc.add_rotation_constraint(
                params, lin, T, source.covs, corr, rot_scale_
            )
        return corr, alpha, lin

    def error_fn(T, corr, alpha, r_scale, rot_scale_):
        err, inl = _error_at(params, T, src_pts, src_covs_reg, corr, r_scale, alpha)
        if params.rotation_constraint.enable:
            err = err + _rotc.rotation_constraint_error(
                params, T, source.covs, corr, rot_scale_
            )
        if map_prior is not None:
            err = err + map_prior.prior_error(T)
        return err, inl

    T_initial = T0

    def body(s: _LoopState) -> _LoopState:
        r_scale = geo_scales[s.level]
        rot_scale_ = rot_scales[s.level]
        corr, alpha, lin_raw = iteration_core(s.T, r_scale, rot_scale_, s.total_it)
        H_raw, b_raw, error_raw = lin_raw.H, lin_raw.b, lin_raw.error

        lin = lin_raw
        if params.degenerate_reg is not None:
            lin = _degen.regularize(params.degenerate_reg, lin, s.T, T_initial)
        if map_prior is not None:
            lin = map_prior.apply(lin, s.T)

        H, g, cur_err, inlier = lin.H, lin.b, lin.error, lin.inlier

        if params.optimization_method == "gauss_newton":
            delta, _ = solve_psd(H + params.gn.lambda_ * jnp.eye(6), -g)
            T_new = s.T @ lie.se3_exp(delta)
            conv = _is_converged(params, delta)
            err_new, inl_new = cur_err, inlier
            lam_next, trust_next = s.lm_lambda, s.trust_radius
            step_tr, accepted_tr = delta, jnp.bool_(True)
        elif params.optimization_method == "levenberg_marquardt":
            # Parallel-candidate LM: the reference sequential inner loop
            # tries lambda, lambda*f, lambda*f^2, ... until a trial improves
            # the cost (registration.hpp:830-895).  Evaluating ALL candidates
            # in one batched pass (vmapped 6x6 solves + error evaluations)
            # selects the *same* first-improving candidate but collapses up
            # to max_inner_iterations sequential device rounds into one.
            p = params.lm
            C = p.max_inner_iterations
            lams = jnp.clip(
                s.lm_lambda * (p.lambda_factor ** jnp.arange(C, dtype=jnp.float32)),
                p.min_lambda, p.max_lambda,
            )
            eye6 = jnp.eye(6, dtype=jnp.float32)

            def trial(lam):
                delta, _ = solve_psd(H + lam * eye6, -g)
                T_c = s.T @ lie.se3_exp(delta)
                err, inl = error_fn(T_c, corr, alpha, r_scale, rot_scale_)
                return delta, T_c, err, inl

            # Two-stage: candidate 0 (the current lambda) accepts on most
            # iterations, so evaluate it alone first and only fall back to
            # the batched candidate sweep when it rejects — lax.cond executes
            # one branch at runtime, cutting the common-case iteration from C
            # full-cloud error evaluations to one.
            delta0, T_c0, err0, inl0 = trial(lams[0])
            accept0 = err0 <= cur_err

            def fast(_):
                lam_next = jnp.clip(
                    lams[0] / p.lambda_factor, p.min_lambda, p.max_lambda
                )
                return (
                    _is_converged(params, delta0), T_c0, err0, inl0, lam_next,
                    delta0, jnp.bool_(True),
                )

            def slow(_):
                deltas, T_cands, errs, inls = jax.vmap(trial)(lams)
                accept = errs <= cur_err
                prev_errs = jnp.concatenate(
                    [jnp.full((1,), jnp.finfo(jnp.float32).max), errs[:-1]]
                )
                plateau = jnp.abs(errs - prev_errs) <= 1e-6
                take = accept | plateau
                any_take = jnp.any(take)
                idx = jnp.argmax(take)  # first taken candidate (reference order)

                accepted = any_take & accept[idx]
                # Exhausted sweep (no accept, no plateau): the reference's
                # inner loop still records converged from the LAST trial's
                # delta (registration.hpp:841-847 runs every inner iteration),
                # so a max-lambda micro-step terminates the outer loop.
                conv = jnp.where(
                    any_take,
                    _is_converged(params, deltas[idx]),
                    _is_converged(params, deltas[-1]),
                )
                T_new = jnp.where(any_take, T_cands[idx], s.T)
                err_new = jnp.where(any_take, errs[idx], cur_err)
                inl_new = jnp.where(any_take, inls[idx], inlier)
                lam_exhausted = jnp.clip(
                    s.lm_lambda * p.lambda_factor**C, p.min_lambda, p.max_lambda
                )
                lam_next = jnp.where(
                    accepted,
                    jnp.clip(lams[idx] / p.lambda_factor, p.min_lambda, p.max_lambda),
                    jnp.where(any_take, lams[idx], lam_exhausted),
                )
                step_tr = jnp.where(any_take, deltas[idx], jnp.zeros(6, jnp.float32))
                return (conv, T_new, err_new, inl_new, lam_next, step_tr, any_take)

            conv, T_new, err_new, inl_new, lam_next, step_tr, accepted_tr = jax.lax.cond(
                accept0, fast, slow, operand=None
            )
            trust_next = s.trust_radius
        elif params.optimization_method == "powell_dogleg":
            p = params.dogleg
            clamp = lambda r: jnp.clip(r, p.min_trust_region_radius, p.max_trust_region_radius)
            radius = clamp(s.trust_radius)
            step, step_norm, pred = compute_dogleg_step(H, g, radius)
            T_c = s.T @ lie.se3_exp(step)
            new_err, new_inl = error_fn(T_c, corr, alpha, r_scale, rot_scale_)
            rho = (cur_err - new_err) / jnp.maximum(pred, 1e-30)
            reject = (pred <= 0.0) | (rho < p.eta1)
            grow = (rho > p.eta2) & (step_norm >= radius * 0.99)
            trust_next = clamp(
                jnp.where(reject, radius * p.gamma_decrease,
                          jnp.where(grow, radius * p.gamma_increase, radius))
            )
            T_new = jnp.where(reject, s.T, T_c)
            conv = jnp.where(reject, False, _is_converged(params, step))
            err_new = jnp.where(reject, cur_err, new_err)
            inl_new = jnp.where(reject, inlier, new_inl)
            lam_next = s.lm_lambda
            step_tr = jnp.where(reject, jnp.zeros(6, jnp.float32), step)
            accepted_tr = ~reject
        else:
            raise ValueError(params.optimization_method)

        # Coarse-phase iterations may not terminate the loop: the final pose
        # must be refined on full-target correspondences.
        if use_cf:
            conv = conv & (s.total_it >= cf_iters)

        # Robust-level transition (RobustAligner chaining, pipeline/robust.hpp).
        it_next = s.it + 1
        exhausted = it_next >= params.max_iterations
        advance = conv | exhausted
        last = s.level >= (n_levels - 1)
        finished = advance & last
        reset = advance & ~last
        if params.optimization_method == "powell_dogleg":
            damping_tr = trust_next
        elif params.optimization_method == "gauss_newton":
            damping_tr = jnp.float32(params.gn.lambda_)
        else:
            damping_tr = lam_next
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        row = jnp.stack([
            f32(s.level), f32(err_new), f32(inl_new), f32(damping_tr),
            jnp.linalg.norm(step_tr[:3]), jnp.linalg.norm(step_tr[3:]),
            f32(accepted_tr), f32(conv),
        ])
        new_s = _LoopState(
            T=T_new,
            it=jnp.where(reset, 0, it_next),
            total_it=s.total_it + 1,
            level=jnp.where(reset, s.level + 1, s.level),
            finished=finished,
            converged=conv,
            lm_lambda=jnp.where(reset, jnp.float32(params.lm.init_lambda), lam_next),
            trust_radius=jnp.where(
                reset, jnp.float32(params.dogleg.initial_trust_region_radius), trust_next
            ),
            H=H, b=g, error=err_new, inlier=inl_new,
            H_raw=H_raw, b_raw=b_raw, error_raw=error_raw,
        )
        return new_s, row

    def cond(s: _LoopState):
        return ~s.finished & (s.total_it < params.max_iterations * n_levels)

    z6 = jnp.zeros((6,), jnp.float32)
    z66 = jnp.zeros((6, 6), jnp.float32)
    init = _LoopState(
        T=T0,
        it=jnp.int32(0),
        total_it=jnp.int32(0),
        level=jnp.int32(0),
        finished=jnp.bool_(False),
        converged=jnp.bool_(False),
        lm_lambda=jnp.float32(params.lm.init_lambda),
        trust_radius=jnp.float32(params.dogleg.initial_trust_region_radius),
        H=z66, b=z6, error=jnp.float32(0.0), inlier=jnp.int32(0),
        H_raw=z66, b_raw=z6, error_raw=jnp.float32(0.0),
    )
    if trace:
        cap = params.max_iterations * n_levels
        buf0 = jnp.full((cap, len(TRACE_COLS)), jnp.nan, jnp.float32)

        def body_tr(carry):
            s, buf = carry
            s2, row = body(s)
            return s2, buf.at[s.total_it].set(row)

        out, trace_buf = jax.lax.while_loop(
            lambda c: cond(c[0]), body_tr, (init, buf0)
        )
    else:
        out = jax.lax.while_loop(cond, lambda s: body(s)[0], init)
    result = RegistrationResult(
        T=out.T, converged=out.converged, iterations=out.total_it,
        H=out.H, b=out.b, error=out.error, inlier=out.inlier,
        H_raw=out.H_raw, b_raw=out.b_raw, error_raw=out.error_raw,
    )
    return (result, trace_buf) if trace else result


def compute_linearized_result(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    pose: jax.Array,
    params: RegistrationParams = RegistrationParams(),
    initial_pose: Optional[jax.Array] = None,
    robust_scale: Optional[jax.Array] = None,
) -> LinearizedResult:
    """One KNN + linearize at ``pose`` (registration.hpp:312), with optional
    degenerate regularization toward ``initial_pose`` — used by the 15-DOF
    LIO solver."""
    r_scale = jnp.float32(params.robust.default_scale if robust_scale is None else robust_scale)
    src_covs_reg, tgt = _precompute_targets(params, source, target)
    corr = _correspondences(params, target_knn, source.points, source.mask, pose, tgt)
    alpha = _genz_alpha(corr) if params.reg_type is RegType.GENZ else jnp.float32(1.0)
    lin = _linearize(params, pose, source.points, src_covs_reg, corr, r_scale, alpha)
    if params.degenerate_reg is not None and initial_pose is not None:
        from sycl_points_tpu.registration import degenerate as _degen

        lin = _degen.regularize(params.degenerate_reg, lin, pose, initial_pose)
    return lin


def compute_icp_robust_weights(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    pose: jax.Array,
    params: RegistrationParams = RegistrationParams(),
    robust_scale: Optional[jax.Array] = None,
) -> jax.Array:
    """Per-source-point robust weights at ``pose`` (registration.hpp:412-462);
    zero outside the correspondence gate.  Used for weighted submap
    sampling."""
    r_scale = jnp.float32(params.robust.default_scale if robust_scale is None else robust_scale)
    src_covs_reg, tgt = _precompute_targets(params, source, target)
    corr = _correspondences(params, target_knn, source.points, source.mask, pose, tgt)
    alpha = _genz_alpha(corr) if params.reg_type is RegType.GENZ else jnp.float32(1.0)
    rn, _ = residual_norms_only(
        params.reg_type, pose, source.points, corr.points,
        src_covs_reg=src_covs_reg, tgt_covs_reg=corr.covs_reg,
        tgt_covs_raw=corr.covs_raw, tgt_normals=corr.normals,
        genz_planar=corr.planar, genz_alpha=alpha,
    )
    w = compute_weight(params.robust.type, rn, r_scale)
    return jnp.where(corr.mask, w, 0.0)
