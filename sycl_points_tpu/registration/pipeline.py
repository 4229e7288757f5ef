"""Registration pipeline wrappers: input sampling -> robust-scale annealing
-> velocity-update (VICP) deskew -> core align.

Replaces the wrapper chain of fateshelled/sycl_points
(``algorithms/registration/registration_pipeline.hpp:17-156``,
``pipeline/robust.hpp:17-133``, ``pipeline/velocity_update.hpp:17-109``,
params at ``registration_pipeline_params.hpp:11-46``).  The wrapper loops
are static (params are compile-time), so the whole chain — every annealing
level and deskew pass — unrolls into ONE jitted XLA computation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.deskew.constant_velocity import deskew_constant_velocity
from sycl_points_tpu.ops.robust import RobustLossType
from sycl_points_tpu.ops.sampling import mixed_sampling, random_sampling
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.registration.registration import (
    RegistrationParams,
    RegistrationResult,
    align,
)


@dataclasses.dataclass(frozen=True)
class RandomSamplingParams:
    enable: bool = True
    num: int = 1000
    use_intensities: bool = False
    weighted_ratio: float = 0.8


@dataclasses.dataclass(frozen=True)
class RobustScheduleParams:
    auto_scale: bool = False
    init_scale: float = 10.0
    min_scale: float = 0.5
    rotation_init_scale: float = 10.0
    rotation_min_scale: float = 0.5
    auto_scaling_iter: int = 4


@dataclasses.dataclass(frozen=True)
class VelocityUpdateParams:
    enable: bool = False
    iter: int = 1


@dataclasses.dataclass(frozen=True)
class RegistrationPipelineParams:
    registration: RegistrationParams = RegistrationParams()
    random_sampling: RandomSamplingParams = RandomSamplingParams()
    robust: RobustScheduleParams = RobustScheduleParams()
    velocity_update: VelocityUpdateParams = VelocityUpdateParams()


class PipelineOutput(NamedTuple):
    result: RegistrationResult
    registration_input: PointCloud  # sampled source actually aligned
    deskewed: PointCloud  # last deskewed source (== input when VICP off)


def _robust_schedule(params: RegistrationPipelineParams) -> tuple[list, list]:
    """Geometric annealing schedule (pipeline/robust.hpp:44-120); returns
    (geometry_scales, rotation_scales) per level."""
    reg = params.registration
    rp = params.robust
    auto = (
        rp.auto_scale
        and reg.robust.type is not RobustLossType.NONE
        and 0.0 < rp.min_scale < rp.init_scale
        and 0.0 < rp.rotation_min_scale < rp.rotation_init_scale
        and rp.auto_scaling_iter > 0
    )
    if not auto:
        return [reg.robust.default_scale], [reg.rotation_constraint.robust_scale]
    levels = max(1, rp.auto_scaling_iter)
    if levels == 1:
        return [rp.init_scale], [rp.rotation_init_scale]
    f = (rp.min_scale / rp.init_scale) ** (1.0 / (levels - 1))
    fr = (rp.rotation_min_scale / rp.rotation_init_scale) ** (1.0 / (levels - 1))
    return (
        [rp.init_scale * f**i for i in range(levels)],
        [rp.rotation_init_scale * fr**i for i in range(levels)],
    )


def align_pipeline(
    source: PointCloud,
    target: PointCloud,
    target_knn,
    params: RegistrationPipelineParams = RegistrationPipelineParams(),
    initial_guess: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    prev_pose: Optional[jax.Array] = None,
    dt: Optional[jax.Array] = None,
    map_prior=None,
) -> PipelineOutput:
    """Full registration pipeline (RegistrationPipeline::align).  Jittable.

    ``prev_pose``/``dt`` feed the VICP deskew (ignored when velocity update is
    disabled or the source has no timestamps).
    """
    T0 = jnp.eye(4, dtype=jnp.float32) if initial_guess is None else initial_guess
    if key is None:
        key = jax.random.key(1234)  # reference default seed

    # --- input sampling (registration_pipeline.hpp update_registration_input)
    sp = params.random_sampling
    if sp.enable and sp.num < source.capacity:
        if sp.use_intensities and source.intensities is not None:
            src = mixed_sampling(
                source, sp.num, source.intensities, key, sp.weighted_ratio
            )
        else:
            src = random_sampling(source, sp.num, key)
    else:
        src = source

    geo_scales, rot_scales = _robust_schedule(params)
    vu = params.velocity_update
    deskew_iters = max(1, vu.iter) if (vu.enable and src.timestamp_offsets is not None) else 0

    T = T0
    result: Optional[RegistrationResult] = None
    deskewed = src
    if deskew_iters == 0:
        # All annealing levels fold into ONE compiled while loop (program
        # size dominates per-call cost).
        result = align(
            src, target, target_knn, params.registration,
            initial_guess=T, map_prior=map_prior,
            robust_schedule=tuple(zip(geo_scales, rot_scales)),
        )
    else:
        # VICP interleaves deskew passes inside each robust level
        # (registration_pipeline.hpp wrap order), so the levels stay unrolled.
        pp = T0 if prev_pose is None else prev_pose
        duration = jnp.float32(-1.0 if dt is None else dt)
        for geo_s, rot_s in zip(geo_scales, rot_scales):
            for _ in range(deskew_iters):
                deskewed = deskew_constant_velocity(src, pp, T, duration)
                result = align(
                    deskewed, target, target_knn, params.registration,
                    initial_guess=T, robust_scale=geo_s,
                    rotation_robust_scale=rot_s, map_prior=map_prior,
                )
                T = result.T
    return PipelineOutput(result=result, registration_input=src, deskewed=deskewed)


def inlier_ratio(out: PipelineOutput) -> jax.Array:
    """result.inlier / registration-input size
    (RegistrationPipeline::get_inlier_ratio)."""
    n = jnp.maximum(out.registration_input.count(), 1)
    return out.result.inlier.astype(jnp.float32) / n.astype(jnp.float32)
