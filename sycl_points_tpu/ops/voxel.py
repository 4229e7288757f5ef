"""Voxel keys and sort/segment-reduce voxel-grid downsampling.

Replaces ``algorithms/common/voxel_constants.hpp`` and
``algorithms/filter/voxel_downsampling.hpp`` of fateshelled/sycl_points.
The reference computes 64-bit packed voxel keys on device, then sorts and
group-averages on the *host* (voxel_downsampling.hpp:146-288).  This
version keeps everything on device: integer voxel coordinates,
a device lexicographic sort, segment-boundary detection, and
``jax.ops.segment_sum`` aggregation — no host round trip, no 64-bit keys
(three int32 coords avoid the x64 requirement), no atomics.

Aggregation semantics match the reference: centroid, RGB mean, timestamp
mean, intensity *median* (compute_median: mean of the two central elements
for even counts), ``min_voxel_count`` filtering.  Output keeps a static
capacity with voxels compacted to the front.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.points.point_cloud import PointCloud

# 21 bits per axis, offset 2^20 (voxel_constants.hpp:11-17).
COORD_BITS = 21
COORD_OFFSET = 1 << (COORD_BITS - 1)
COORD_MASK = (1 << COORD_BITS) - 1
# Invalid-voxel coordinate (sorts last).  A plain Python int: a `jnp.int32`
# here would be a module-level device array (created at import, on whatever
# backend comes up first) that every jit capturing it embeds as a constant.
_SENTINEL = 2**31 - 1


def voxel_coords(points: jax.Array, valid: jax.Array, voxel_size: float | jax.Array):
    """Integer voxel coordinates ``[N, 3]`` with sentinel for invalid points.

    Mirrors ``filter::kernel::compute_voxel_bit`` (voxel_constants.hpp:37-62):
    floor(p / voxel_size) + offset, invalid when non-finite or out of the
    21-bit range.
    """
    inv = 1.0 / voxel_size
    scaled = points * inv
    finite = jnp.all(jnp.isfinite(scaled), axis=-1) & valid
    c = jnp.floor(scaled).astype(jnp.int32) + COORD_OFFSET
    in_range = jnp.all((c >= 0) & (c <= COORD_MASK), axis=-1)
    ok = finite & in_range
    c = jnp.where(ok[:, None], c, _SENTINEL)
    return c, ok


def voxel_coords_counted(points: jax.Array, valid: jax.Array, voxel_size: float | jax.Array):
    """:func:`voxel_coords` plus a count of finite valid points outside the
    21-bit coordinate range (surfaced by the map backends as budget loss —
    no silent caps)."""
    inv = 1.0 / voxel_size
    scaled = points * inv
    finite = jnp.all(jnp.isfinite(scaled), axis=-1) & valid
    c = jnp.floor(scaled).astype(jnp.int32) + COORD_OFFSET
    in_range = jnp.all((c >= 0) & (c <= COORD_MASK), axis=-1)
    ok = finite & in_range
    n_range_lost = jnp.sum((finite & ~in_range).astype(jnp.int32))
    c = jnp.where(ok[:, None], c, _SENTINEL)
    return c, ok, n_range_lost


def _segment_ids_from_sorted_coords(coords_sorted: jax.Array):
    """Segment ids for lexicographically sorted coordinate rows."""
    prev = jnp.roll(coords_sorted, 1, axis=0)
    new_seg = jnp.any(coords_sorted != prev, axis=-1)
    new_seg = new_seg.at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    return seg_id, new_seg


# Per-axis cell budget for the packed single-int32 sort key (3 x 10 bits).
# Cells are offset by the per-frame minimum, so this bounds the *extent* of
# one batch (1024 cells/axis = 256 m at 0.25 m voxels), not absolute
# coordinates.  Points beyond the budget are treated as invalid.
MAX_CELLS_PER_AXIS = 1024


def cell_sort_ids(coords: jax.Array, ok: jax.Array):
    """Sort rows by cell with ONE device sort; no coordinate gather.

    The reference packs 3 x 21-bit coords into a uint64 key
    (voxel_constants.hpp); without 64-bit types a lexsort needs 3 sort
    passes.  Instead, coordinates are re-based to the per-frame minimum and
    packed into a single int32 (3 x 10 bits) — one sort pass, ~3x cheaper.
    Invalid/out-of-budget rows get the maximal key and sort to the tail.

    Returns (order, ok_sorted, seg_id, new_seg, n_extent_lost);
    ``ok_sorted`` comes from the sorted key itself (invalid == sentinel),
    saving a gather.  ``n_extent_lost`` counts otherwise-valid rows that
    fell outside the per-frame extent budget (no silent caps: callers must
    surface it).
    """
    big = jnp.int32(2**30)
    masked = jnp.where(ok[:, None], coords, big)
    cmin = jnp.min(masked, axis=0)
    rel = coords - cmin
    in_bound = ok & jnp.all((rel >= 0) & (rel < MAX_CELLS_PER_AXIS), axis=-1)
    n_extent_lost = jnp.sum((ok & ~in_bound).astype(jnp.int32))
    key = (
        (rel[:, 0] * MAX_CELLS_PER_AXIS + rel[:, 1]) * MAX_CELLS_PER_AXIS + rel[:, 2]
    )
    key = jnp.where(in_bound, key, jnp.int32(2**31 - 1))
    order = jnp.argsort(key)
    key_s = key[order]
    ok_s = key_s != jnp.int32(2**31 - 1)
    new_seg = (key_s != jnp.roll(key_s, 1)).at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    return order, ok_s, seg_id, new_seg, n_extent_lost


def sort_by_cell(coords: jax.Array, ok: jax.Array):
    """:func:`cell_sort_ids` plus the gathered sorted coordinates.

    Returns (order, coords_sorted, ok_sorted, seg_id, new_seg, n_extent_lost).
    """
    order, ok_s, seg_id, new_seg, n_extent_lost = cell_sort_ids(coords, ok)
    return order, coords[order], ok_s, seg_id, new_seg, n_extent_lost


def voxel_downsample(
    cloud: PointCloud,
    voxel_size: float | jax.Array,
    min_voxel_count: int = 1,
    out_capacity: Optional[int] = None,
    return_lost: bool = False,
):
    """Voxel-grid downsampling (VoxelGrid::downsampling,
    voxel_downsampling.hpp:50-79). Jittable; output capacity is static
    (defaults to the input capacity).

    With ``return_lost`` returns ``(cloud, n_extent_lost)`` where the count
    covers valid points outside the per-frame extent budget (no silent
    caps)."""
    coords, ok = voxel_coords(cloud.points, cloud.mask, voxel_size)
    return downsample_by_coords(
        cloud, coords, ok, min_voxel_count, out_capacity, return_lost
    )


def downsample_by_coords(
    cloud: PointCloud,
    coords: jax.Array,
    ok: jax.Array,
    min_voxel_count: int = 1,
    out_capacity: Optional[int] = None,
    return_lost: bool = False,
):
    """Shared sort/segment-reduce aggregation over integer bin coordinates
    (used by both the Cartesian voxel grid and the polar grid)."""
    N = cloud.capacity
    out_cap = out_capacity or N

    # Single-pass packed-key device sort with ALL per-point attributes riding
    # as sort payloads: lax.sort moves the payload rows during the sort
    # instead of an argsort followed by row gathers.  Invalid points share
    # the maximal key and sort to the tail as one zero-weight segment.
    big = jnp.int32(2**30)
    masked = jnp.where(ok[:, None], coords, big)
    cmin = jnp.min(masked, axis=0)
    rel = coords - cmin
    in_bound = ok & jnp.all((rel >= 0) & (rel < MAX_CELLS_PER_AXIS), axis=-1)
    n_extent_lost = jnp.sum((ok & ~in_bound).astype(jnp.int32))
    key = (
        (rel[:, 0] * MAX_CELLS_PER_AXIS + rel[:, 1]) * MAX_CELLS_PER_AXIS + rel[:, 2]
    )
    key = jnp.where(in_bound, key, jnp.int32(2**31 - 1))

    payload = [cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2]]
    n_rgb = n_ts = n_cov = n_nrm = n_int = 0
    if cloud.rgb is not None:
        payload += [cloud.rgb[:, 0], cloud.rgb[:, 1], cloud.rgb[:, 2]]
        n_rgb = 3
    if cloud.timestamp_offsets is not None:
        payload.append(cloud.timestamp_offsets)
        n_ts = 1
    if cloud.covs is not None:
        # per-voxel covariance = mean of member covariances (6 unique
        # elements of the symmetric 3x3 ride the sort) — the raw-features
        # preprocess path estimates covariances on the RAW scan
        # (ops.range_image_knn) and carries them through the downsample;
        # between-member spread (<= voxel_size^2) is negligible against the
        # k-neighborhood scale the covariances describe
        cv = cloud.covs
        payload += [cv[:, 0, 0], cv[:, 0, 1], cv[:, 0, 2],
                    cv[:, 1, 1], cv[:, 1, 2], cv[:, 2, 2]]
        n_cov = 6
    if cloud.normals is not None:
        nr = cloud.normals
        payload += [nr[:, 0], nr[:, 1], nr[:, 2]]
        n_nrm = 3
    if cloud.intensities is not None:
        payload.append(cloud.intensities)
        n_int = 1
    sorted_ops = jax.lax.sort((key, *payload), num_keys=1)
    key_s, cols = sorted_ops[0], list(sorted_ops[1:])

    ok_s = key_s != jnp.int32(2**31 - 1)
    new_seg = (key_s != jnp.roll(key_s, 1)).at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    w = ok_s.astype(cloud.points.dtype)

    # One fused [N, C] segment reduction over every mean-aggregated channel
    # (+ the count column) — a single pass over the big array.
    n_mean = 3 + n_rgb + n_ts + n_cov + n_nrm
    mean_cols = cols[:n_mean]
    moments = jax.ops.segment_sum(
        jnp.stack([c * w for c in mean_cols] + [w], axis=1),
        seg_id,
        num_segments=out_cap,
        indices_are_sorted=True,
    )
    counts = moments[:, -1]
    counts_safe = jnp.maximum(counts, 1.0)
    means = moments[:, :-1] / counts_safe[:, None]
    centroid = means[:, :3]
    voxel_ok = counts >= float(min_voxel_count)

    col = 3
    rgb = means[:, col : col + n_rgb] if n_rgb else None
    col += n_rgb
    ts = means[:, col] if n_ts else None
    col += n_ts
    covs = None
    if n_cov:
        u = means[:, col : col + 6]
        covs = jnp.stack(
            [
                jnp.stack([u[:, 0], u[:, 1], u[:, 2]], axis=1),
                jnp.stack([u[:, 1], u[:, 3], u[:, 4]], axis=1),
                jnp.stack([u[:, 2], u[:, 4], u[:, 5]], axis=1),
            ],
            axis=1,
        )
        col += 6
    normals = None
    if n_nrm:
        nm = means[:, col : col + 3]
        normals = nm / jnp.maximum(jnp.linalg.norm(nm, axis=1, keepdims=True), 1e-9)
        col += 3
    intens = None
    if n_int:
        intens = _segment_median(cols[-1], seg_id, w, counts, out_cap)

    out = PointCloud(
        points=centroid,
        mask=voxel_ok,
        rgb=rgb,
        covs=covs,
        normals=normals,
        intensities=intens,
        timestamp_offsets=ts,
    )
    if return_lost:
        return out, n_extent_lost
    return out


def _segment_median(values: jax.Array, seg_id: jax.Array, w: jax.Array, counts, num_segments: int):
    """Per-segment median matching ``kernel::compute_median``
    (feature/covariance.hpp:142-172): mean of the two central elements for
    even counts.  Invalid entries are pushed to the segment tail by sorting
    on (+inf for invalid) before the median index gather."""
    n = values.shape[0]
    sort_vals = jnp.where(w > 0, values, jnp.inf)
    order2 = jnp.lexsort((sort_vals, seg_id))
    vals2 = values[order2]
    seg2 = seg_id[order2]
    # start index of each segment: for nondecreasing seg2, searchsorted.
    starts = jnp.searchsorted(seg2, jnp.arange(num_segments), side="left")
    cnt = counts.astype(jnp.int32)
    lo = jnp.clip(starts + jnp.maximum(cnt - 1, 0) // 2, 0, n - 1)
    hi = jnp.clip(starts + cnt // 2, 0, n - 1)
    return 0.5 * (vals2[lo] + vals2[hi])
