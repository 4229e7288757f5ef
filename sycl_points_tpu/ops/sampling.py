"""Point sampling operators (random / weighted / mixed / farthest-point).

Replaces the sampling operators of fateshelled/sycl_points
(``algorithms/filter/preprocess_operator/*_sampling_operator.hpp``):

  * random sampling: Fisher-Yates partial shuffle in the reference; here an
    exact equivalent via Gumbel top-k over valid points;
  * weighted sampling: Efraimidis-Spirakis reservoir (key = log(u)/w) in the
    reference; Gumbel top-k with log-weights draws from the *same*
    without-replacement distribution;
  * mixed sampling: ``weighted_ratio`` fraction weighted + remainder uniform
    from the unselected points (mixed_random_sampling_operator.hpp);
  * farthest point sampling: iterative min-distance argmax
    (farthest_point_sampling_operator.hpp:27-91) as a ``lax.fori_loop``.

All samplers return a cloud with static capacity ``num`` (mask marks short
draws), keeping downstream shapes compile-time constant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_points_tpu.points.point_cloud import PointCloud

_NEG = -1e30


def _take(cloud: PointCloud, idx: jax.Array, valid: jax.Array) -> PointCloud:
    def g(a):
        return None if a is None else a[idx]

    return PointCloud(
        points=cloud.points[idx],
        mask=valid & cloud.mask[idx],
        covs=g(cloud.covs),
        normals=g(cloud.normals),
        rgb=g(cloud.rgb),
        intensities=g(cloud.intensities),
        timestamp_offsets=g(cloud.timestamp_offsets),
    )


def random_sampling(cloud: PointCloud, num: int, key: jax.Array) -> PointCloud:
    """Uniform sampling without replacement to ``num`` points.  When ``num``
    covers the whole capacity the cloud is returned unchanged (the reference
    samplers keep all points when the request exceeds the cloud size)."""
    if num >= cloud.capacity:
        return cloud
    g = jax.random.gumbel(key, (cloud.capacity,))
    score = jnp.where(cloud.mask, g, _NEG)
    _, idx = jax.lax.top_k(score, num)
    n_valid = jnp.sum(cloud.mask.astype(jnp.int32))
    valid = jnp.arange(num) < n_valid
    return _take(cloud, idx, valid)


def weighted_sampling(
    cloud: PointCloud, num: int, weights: jax.Array, key: jax.Array
) -> PointCloud:
    """Weighted sampling without replacement (Efraimidis-Spirakis
    distribution via Gumbel top-k).  Non-positive/invalid weights are
    excluded, matching the reference weight validation."""
    if num >= cloud.capacity:
        return cloud
    w_ok = cloud.mask & (weights > 0.0) & jnp.isfinite(weights)
    g = jax.random.gumbel(key, (cloud.capacity,))
    score = jnp.where(w_ok, jnp.log(jnp.maximum(weights, 1e-30)) + g, _NEG)
    _, idx = jax.lax.top_k(score, num)
    n_valid = jnp.sum(w_ok.astype(jnp.int32))
    valid = jnp.arange(num) < n_valid
    return _take(cloud, idx, valid)


def mixed_sampling(
    cloud: PointCloud,
    num: int,
    weights: jax.Array,
    key: jax.Array,
    weighted_ratio: float = 0.8,
) -> PointCloud:
    """``weighted_ratio`` of the draw weighted, remainder uniform from the
    unselected points (mixed_random_sampling_operator.hpp)."""
    if num >= cloud.capacity:
        return cloud
    n_weighted = int(round(num * weighted_ratio))
    n_uniform = num - n_weighted
    k1, k2 = jax.random.split(key)

    w_ok = cloud.mask & (weights > 0.0) & jnp.isfinite(weights)
    g1 = jax.random.gumbel(k1, (cloud.capacity,))
    score_w = jnp.where(w_ok, jnp.log(jnp.maximum(weights, 1e-30)) + g1, _NEG)
    _, idx_w = jax.lax.top_k(score_w, n_weighted) if n_weighted > 0 else (None, jnp.zeros((0,), jnp.int32))

    selected = jnp.zeros((cloud.capacity,), bool)
    if n_weighted > 0:
        n_w_valid = jnp.minimum(jnp.sum(w_ok.astype(jnp.int32)), n_weighted)
        w_taken = jnp.arange(n_weighted) < n_w_valid
        selected = selected.at[idx_w].set(w_taken)
    else:
        n_w_valid = jnp.int32(0)
        w_taken = jnp.zeros((0,), bool)

    g2 = jax.random.gumbel(k2, (cloud.capacity,))
    score_u = jnp.where(cloud.mask & ~selected, g2, _NEG)
    _, idx_u = jax.lax.top_k(score_u, max(n_uniform, 1))
    idx_u = idx_u[:n_uniform]
    n_u_avail = jnp.sum((cloud.mask & ~selected).astype(jnp.int32))
    u_taken = jnp.arange(n_uniform) < jnp.minimum(n_u_avail, n_uniform)

    idx = jnp.concatenate([idx_w, idx_u])
    valid = jnp.concatenate([w_taken, u_taken])
    return _take(cloud, idx, valid)


def farthest_point_sampling(cloud: PointCloud, num: int, key: jax.Array) -> PointCloud:
    """Iterative FPS (farthest_point_sampling_operator.hpp:27-91): device
    min-distance update + argmax per round, O(num * N)."""
    if num >= cloud.capacity:
        return cloud
    pts = cloud.points
    n = cloud.capacity
    valid = cloud.mask
    first = jnp.argmax(
        jnp.where(valid, jax.random.uniform(key, (n,)), -1.0)
    ).astype(jnp.int32)

    def body(i, state):
        min_d, sel_idx = state
        last = sel_idx[i - 1]
        d = jnp.sum((pts - pts[last]) ** 2, axis=-1)
        min_d = jnp.minimum(min_d, d)
        min_d = jnp.where(valid, min_d, -1.0)
        nxt = jnp.argmax(min_d).astype(jnp.int32)
        return min_d, sel_idx.at[i].set(nxt)

    init_d = jnp.where(valid, jnp.inf, -1.0)
    sel0 = jnp.zeros((num,), jnp.int32).at[0].set(first)
    _, sel = jax.lax.fori_loop(1, num, body, (init_d, sel0))
    n_valid = jnp.sum(valid.astype(jnp.int32))
    taken = jnp.arange(num) < jnp.minimum(n_valid, num)
    return _take(cloud, sel, taken)
