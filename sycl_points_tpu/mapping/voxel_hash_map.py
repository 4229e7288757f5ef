"""Persistent HBM voxel hash map (submapping backend).

Replaces ``algorithms/mapping/voxel_hash_map.hpp`` of fateshelled/sycl_points.
The reference maintains a GPU open-addressing table updated with
work-group-local bitonic sort + CAS/atomic global merges
(voxel_hash_map.hpp:574-792).  Here the insert is order-independent, with
no CAS loop:

  1. per-frame pre-aggregation by device sort + segment-reduce (the same
     math the reference does in work-group local memory), producing at most
     one contribution per voxel key;
  2. a *scatter-claim* probe loop replacing CAS: each unresolved unique key
     writes its ticket into a claim array at its probe slot; re-reading
     decides the winner.  <= MAX_PROBES unrolled rounds resolve every key
     (double hashing, power-of-two capacity).

Voxel payload matches the reference accumulators (voxel_hash_map.hpp:255-288):
position sum + count, **log-Euclidean covariance sums** (covariances rotated
into the map frame, matrix-log'ed before summing, matrix-exp'ed on
extraction), RGBA sums, intensity sum, last-update stamp for staleness
pruning (voxel_hash_map.hpp:794-845).

Growth: the reference rehashes to the next prime capacity at 0.7 load
(voxel_hash_map.hpp:847-934).  XLA needs static shapes, so capacity is fixed
*per compiled program*; :func:`grow` re-inserts the table into a 2x table
(recompile per capacity tier, host-triggered), and
:func:`add_point_cloud_auto` wraps insertion with the reference's growth
policy — grow when load exceeds ``max_load`` or when any contribution is
dropped on probe exhaustion (drops are counted in ``state.dropped``; the
failed insert is retried on the grown table so nothing is lost).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.mapping.hash_table import (
    compact_indices_ranked,
    lookup_slots,
    resolve_slots,
)
from sycl_points_tpu.ops.voxel import _SENTINEL, sort_by_cell, voxel_coords, voxel_coords_counted
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils import eigh3


@dataclasses.dataclass(frozen=True)
class VoxelHashMapConfig:
    voxel_size: float = 1.0
    capacity: int = 1 << 18  # slots (power of two)
    max_probes: int = 32
    min_num_point: int = 1
    max_staleness: int = 100
    remove_old_data_cycle: int = 10


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelHashMapState:
    coords: jax.Array  # [C, 3] int32 voxel coords; _SENTINEL when empty
    used: jax.Array  # [C] bool
    sum_pos: jax.Array  # [C, 3]
    count: jax.Array  # [C] float32
    sum_logcov: jax.Array  # [C, 6] upper-tri of summed log-covariances
    sum_rgba: jax.Array  # [C, 4]
    sum_intensity: jax.Array  # [C]
    last_update: jax.Array  # [C] int32 frame stamp
    frame: jax.Array  # scalar int32
    dropped: jax.Array  # scalar int32: contributions lost to probe exhaustion
    # scalar int32: contributions lost to FIXED budgets that growing the
    # table cannot raise (out-of-extent sort keys, 21-bit coordinate range).
    # Kept separate from ``dropped`` so the growth policy never retries
    # unfixable losses (they recur at any capacity).
    budget_lost: jax.Array


_TRI = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _tri_pack(M: jax.Array) -> jax.Array:
    return jnp.stack([M[..., i, j] for i, j in _TRI], axis=-1)


def _tri_unpack(v: jax.Array) -> jax.Array:
    xx, xy, xz, yy, yz, zz = (v[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([xx, xy, xz], -1),
            jnp.stack([xy, yy, yz], -1),
            jnp.stack([xz, yz, zz], -1),
        ],
        axis=-2,
    )


def create(config: VoxelHashMapConfig) -> VoxelHashMapState:
    C = config.capacity
    return VoxelHashMapState(
        coords=jnp.full((C, 3), _SENTINEL, jnp.int32),
        used=jnp.zeros((C,), bool),
        sum_pos=jnp.zeros((C, 3), jnp.float32),
        count=jnp.zeros((C,), jnp.float32),
        sum_logcov=jnp.zeros((C, 6), jnp.float32),
        sum_rgba=jnp.zeros((C, 4), jnp.float32),
        sum_intensity=jnp.zeros((C,), jnp.float32),
        last_update=jnp.zeros((C,), jnp.int32),
        frame=jnp.int32(0),
        dropped=jnp.int32(0),
        budget_lost=jnp.int32(0),
    )


def add_point_cloud(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose: jax.Array,
) -> VoxelHashMapState:
    """Insert a sensor-frame cloud at ``sensor_pose`` (VoxelHashMap::
    add_point_cloud, voxel_hash_map.hpp:117-140, 614-792).  Jittable."""
    N = cloud.capacity
    R = sensor_pose[:3, :3]
    pts_map = cloud.points @ R.T + sensor_pose[:3, 3]
    coords, ok, n_range_lost = voxel_coords_counted(pts_map, cloud.mask, config.voxel_size)

    # Per-point payload in map frame.
    if cloud.covs is not None:
        cov_map = jnp.einsum("ij,njk,lk->nil", R, cloud.covs, R, precision="highest")
        logcov = _tri_pack(eigh3.spd_log(cov_map))
    else:
        logcov = jnp.zeros((N, 6), jnp.float32)
    rgba = cloud.rgb if cloud.rgb is not None else jnp.zeros((N, 4), jnp.float32)
    inten = cloud.intensities if cloud.intensities is not None else jnp.zeros((N,), jnp.float32)

    # Frame-local pre-aggregation: packed-key sort, segment-reduce payloads.
    order, coords_s, ok_s, seg_id, new_seg, n_extent_lost = sort_by_cell(coords, ok)
    w = ok_s.astype(jnp.float32)

    def seg(x):
        return jax.ops.segment_sum(x, seg_id, num_segments=N)

    agg_pos = seg(pts_map[order] * w[:, None])
    agg_cnt = seg(w)
    agg_logcov = seg(logcov[order] * w[:, None])
    agg_rgba = seg(rgba[order] * w[:, None])
    agg_int = seg(inten[order] * w)

    # Representative key per segment (first sorted element of the segment).
    first_of_seg = jnp.full((N,), N - 1, jnp.int32).at[seg_id].min(jnp.arange(N, dtype=jnp.int32))
    seg_keys = coords_s[first_of_seg]
    seg_valid = agg_cnt > 0.0

    coords_tbl, used, slot, resolved = resolve_slots(
        state.coords, state.used, seg_keys, seg_valid, config.capacity, config.max_probes
    )
    tgt = jnp.where(resolved, slot, config.capacity)

    return VoxelHashMapState(
        coords=coords_tbl,
        used=used,
        sum_pos=state.sum_pos.at[tgt].add(agg_pos, mode="drop"),
        count=state.count.at[tgt].add(agg_cnt, mode="drop"),
        sum_logcov=state.sum_logcov.at[tgt].add(agg_logcov, mode="drop"),
        sum_rgba=state.sum_rgba.at[tgt].add(agg_rgba, mode="drop"),
        sum_intensity=state.sum_intensity.at[tgt].add(agg_int, mode="drop"),
        last_update=state.last_update.at[tgt].set(state.frame, mode="drop"),
        frame=state.frame + 1,
        dropped=state.dropped + jnp.sum((seg_valid & ~resolved).astype(jnp.int32)),
        budget_lost=state.budget_lost + n_range_lost + n_extent_lost,
    )


def load_factor(state: VoxelHashMapState, config: VoxelHashMapConfig) -> jax.Array:
    """Occupied fraction of the table (the reference rehashes above 0.7,
    voxel_hash_map.hpp:121-124)."""
    return jnp.sum(state.used.astype(jnp.float32)) / config.capacity


def grow(
    state: VoxelHashMapState, config: VoxelHashMapConfig, factor: int = 2
) -> tuple[VoxelHashMapState, VoxelHashMapConfig]:
    """Re-insert every used slot into a ``factor``-times-larger table — the
    static-shape analog of the reference rehash kernel
    (voxel_hash_map.hpp:847-934).  Jittable per (old, new) capacity pair;
    triggered from the host (add_point_cloud_auto / Submap)."""
    new_config = dataclasses.replace(config, capacity=config.capacity * factor)
    new = create(new_config)
    coords_tbl, used, slot, resolved = resolve_slots(
        new.coords, new.used, state.coords, state.used,
        new_config.capacity, new_config.max_probes,
    )
    tgt = jnp.where(resolved, slot, new_config.capacity)
    moved = VoxelHashMapState(
        coords=coords_tbl,
        used=used,
        sum_pos=new.sum_pos.at[tgt].set(state.sum_pos, mode="drop"),
        count=new.count.at[tgt].set(state.count, mode="drop"),
        sum_logcov=new.sum_logcov.at[tgt].set(state.sum_logcov, mode="drop"),
        sum_rgba=new.sum_rgba.at[tgt].set(state.sum_rgba, mode="drop"),
        sum_intensity=new.sum_intensity.at[tgt].set(state.sum_intensity, mode="drop"),
        last_update=new.last_update.at[tgt].set(state.last_update, mode="drop"),
        frame=state.frame,
        dropped=state.dropped + jnp.sum((state.used & ~resolved).astype(jnp.int32)),
        budget_lost=state.budget_lost,
    )
    return moved, new_config


def add_point_cloud_auto(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose,
    max_load: float = 0.7,
    max_grow_steps: int = 8,
) -> tuple[VoxelHashMapState, VoxelHashMapConfig]:
    """Host-side insertion with the reference growth policy: grow while the
    load factor exceeds ``max_load``, insert, and if any contribution was
    dropped on probe exhaustion retry the SAME insert on a grown table (the
    pre-insert state is kept, so retried inserts lose nothing)."""
    for _ in range(max_grow_steps):
        if float(load_factor(state, config)) <= max_load:
            break
        state, config = grow(state, config)
    for _ in range(max_grow_steps):
        new_state = add_point_cloud(state, config, cloud, sensor_pose)
        if int(new_state.dropped) == int(state.dropped):
            return new_state, config
        state, config = grow(state, config)
    return add_point_cloud(state, config, cloud, sensor_pose), config


def remove_old_data(state: VoxelHashMapState, config: VoxelHashMapConfig) -> VoxelHashMapState:
    """Staleness pruning (voxel_hash_map.hpp:794-845): clear slots not
    touched within ``max_staleness`` frames."""
    age = state.frame - 1 - state.last_update
    stale = state.used & (age > config.max_staleness)
    keep = ~stale
    kf = keep.astype(jnp.float32)
    return dataclasses.replace(
        state,
        coords=jnp.where(keep[:, None], state.coords, _SENTINEL),
        used=state.used & keep,
        sum_pos=state.sum_pos * kf[:, None],
        count=state.count * kf,
        sum_logcov=state.sum_logcov * kf[:, None],
        sum_rgba=state.sum_rgba * kf[:, None],
        sum_intensity=state.sum_intensity * kf,
        last_update=jnp.where(keep, state.last_update, 0),
    )


def voxel_count(state: VoxelHashMapState) -> jax.Array:
    return jnp.sum(state.used.astype(jnp.int32))


def extract(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    center: jax.Array,
    distance: float = 100.0,
    out_capacity: int = 1 << 15,
    with_covs: bool = True,
    with_rgb: bool = False,
    with_intensity: bool = False,
    with_overflow: bool = False,
):
    """Aggregate voxels within the L-inf bounding box around ``center`` into
    a cloud (VoxelHashMap::downsampling, voxel_hash_map.hpp:936-1065):
    centroid, matrix-exp of the averaged log-covariance, attribute means,
    ``min_num_point`` filtering.  Output capacity is static.

    When more voxels are in range than ``out_capacity``, the NEAREST
    ``out_capacity`` voxels to ``center`` are kept (not an arbitrary
    hash-slot-order subset) and, with ``with_overflow``, the spill count is
    returned as ``(cloud, n_overflow)`` (no silent caps)."""
    cnt_safe = jnp.maximum(state.count, 1.0)
    centroid = state.sum_pos / cnt_safe[:, None]
    lo = center - distance
    hi = center + distance
    inside = jnp.all((centroid >= lo) & (centroid <= hi), axis=-1)
    keep = state.used & (state.count >= config.min_num_point) & inside

    # O(C) cumsum compaction over used slots (not O(C log C) argsort) in the
    # common fits-in-capacity case; overflow switches to nearest-to-center
    # retention via lax.cond (sort paid only on overflow frames).
    dist_sq = jnp.sum((centroid - center) ** 2, axis=-1)
    order, mask, n_overflow = compact_indices_ranked(keep, dist_sq, out_capacity)

    pts = centroid[order]
    covs = None
    if with_covs:
        covs = eigh3.spd_exp(_tri_unpack(state.sum_logcov[order] / cnt_safe[order, None]))
    rgb = state.sum_rgba[order] / cnt_safe[order, None] if with_rgb else None
    inten = state.sum_intensity[order] / cnt_safe[order] if with_intensity else None
    out = PointCloud(points=pts, mask=mask, covs=covs, rgb=rgb, intensities=inten)
    if with_overflow:
        return out, n_overflow
    return out


def compute_overlap_ratio(
    state: VoxelHashMapState,
    config: VoxelHashMapConfig,
    cloud: PointCloud,
    sensor_pose: jax.Array,
) -> jax.Array:
    """Fraction of cloud points whose voxel exists in the map
    (voxel_hash_map.hpp:194-246)."""
    R = sensor_pose[:3, :3]
    pts_map = cloud.points @ R.T + sensor_pose[:3, 3]
    coords, ok = voxel_coords(pts_map, cloud.mask, config.voxel_size)
    _, found = lookup_slots(
        state.coords, state.used, coords, ok, config.capacity, config.max_probes
    )
    n = jnp.maximum(jnp.sum(cloud.mask.astype(jnp.float32)), 1.0)
    return jnp.sum(found.astype(jnp.float32)) / n
