"""Occupancy grid map: log-odds voxel hash with free-space ray carving.

Replaces ``algorithms/mapping/occupancy_grid_map.hpp`` of
fateshelled/sycl_points.  Same hash/table design as
:mod:`sycl_points_tpu.mapping.voxel_hash_map` plus per-voxel log-odds
occupancy (defaults occupancy_grid_map.hpp:1660-1679: hit +0.85, miss -0.4,
clamp [-4, 4], threshold p=0.5, stale threshold 100):

  * hits: per-frame sort/segment-reduce of point payloads (position sums,
    log-Euclidean covariance sums, rgba, intensity, hit counts);
  * free space: the 3-D DDA ray walk (traverse_ray_exclusive_impl,
    occupancy_grid_map.hpp:821-900) vectorized as a ``lax.scan`` over a
    static step bound — all rays advance in lockstep, finished rays are
    masked;
  * pending log-odds applied once per frame with clamping
    (apply_pending_log_odds, occupancy_grid_map.hpp:1457-1483);
  * stale-voxel pruning (occupancy_grid_map.hpp:1485), occupied-point
    extraction (:1530), experimental visible-point extraction with
    per-point occlusion ray-march (:189-411), overlap ratio (:417-472).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from sycl_points_tpu.mapping.hash_table import (
    compact_indices,
    compact_indices_ranked,
    lookup_slots,
    resolve_slots,
    resolve_slots_tiered,
)
from sycl_points_tpu.mapping.voxel_hash_map import _tri_pack, _tri_unpack
from sycl_points_tpu.ops.voxel import (
    _SENTINEL,
    COORD_MASK,
    COORD_OFFSET,
    sort_by_cell,
    voxel_coords,
    voxel_coords_counted,
)
from sycl_points_tpu.points.point_cloud import PointCloud
from sycl_points_tpu.utils import eigh3


def probability_to_log_odds(p: float) -> float:
    return math.log(p / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class OccupancyGridConfig:
    voxel_size: float = 1.0
    capacity: int = 1 << 18
    max_probes: int = 32
    log_odds_hit: float = 0.85
    log_odds_miss: float = -0.4
    min_log_odds: float = -4.0
    max_log_odds: float = 4.0
    occupancy_threshold_log_odds: float = 0.0  # p = 0.5
    stale_frame_threshold: int = 100
    free_space_updates_enabled: bool = True
    # Carve free space every k-th insert (hits still integrate every frame):
    # the reference exposes the same hit-every-frame / carve-on-cycle split
    # through its update knobs (occupancy_grid_map.hpp:1072-1235).  The
    # carve merge dominates the OG insert cost, so cycle=2 roughly halves
    # the steady-state insert time at slightly slower free-space decay.
    free_space_update_cycle: int = 1
    voxel_pruning_enabled: bool = True
    # Static DDA bound (voxels crossed per ray).  0 = derive from geometry:
    # a ray of length L crosses at most ceil(sqrt(3) * L / voxel_size) + 3
    # voxel boundaries, with L = max_ray_distance.  Rays still unfinished at
    # the bound are counted in ``state.truncated_rays``.
    max_ray_steps: int = 0
    max_ray_distance: float = 50.0
    # Per-frame bound on UNIQUE free-space voxels considered by the carve
    # merge (decouples carve cost from grown table capacity); overflow is
    # counted into state.dropped.
    miss_budget: int = 1 << 17

    @property
    def ray_step_budget(self) -> int:
        if self.max_ray_steps > 0:
            return self.max_ray_steps
        return int(math.ceil(math.sqrt(3.0) * self.max_ray_distance / self.voxel_size)) + 3

    @property
    def ray_axis_budget(self) -> int:
        """Per-axis crossing budget of the analytic carve DDA: a ray of
        length <= max_ray_distance crosses at most ceil(L/voxel)+1 planes of
        any one axis.  Unlike the merged-order budget (ray_step_budget) this
        bound is exact, so carve truncation cannot occur."""
        n = int(math.ceil(self.max_ray_distance / self.voxel_size)) + 2
        if self.max_ray_steps > 0:
            # A manual step limit caps total crossings per ray, hence also
            # per-axis crossings.
            n = min(n, self.max_ray_steps + 1)
        if 2 * n + 2 > 1290:  # (2n+2)^3 must fit an int32 packed key
            raise ValueError(
                f"max_ray_distance/voxel_size = {self.max_ray_distance / self.voxel_size:.0f} "
                "exceeds the int32 packed-key budget (642 cells); raise voxel_size, "
                "lower max_ray_distance, or set max_ray_steps to bound the carve"
            )
        return n

    @property
    def miss_merge_budget(self) -> int:
        return min(self.miss_budget, self.capacity)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OccupancyGridState:
    coords: jax.Array  # [C, 3]
    used: jax.Array  # [C]
    log_odds: jax.Array  # [C]
    sum_pos: jax.Array  # [C, 3] (hit positions)
    hit_count: jax.Array  # [C] float32
    sum_logcov: jax.Array  # [C, 6]
    sum_rgba: jax.Array  # [C, 4]
    sum_intensity: jax.Array  # [C]
    last_update: jax.Array  # [C] int32
    frame: jax.Array  # scalar int32
    dropped: jax.Array  # scalar int32: contributions lost to probe exhaustion
    truncated_rays: jax.Array  # scalar int32: rays cut short by the DDA bound
    # scalar int32: contributions lost to FIXED budgets that growing the
    # table cannot raise (miss-merge budget, extent/coordinate range).  Kept
    # separate from ``dropped`` so the growth policy never retries them.
    budget_lost: jax.Array
    # scalar int32: rays longer than max_ray_distance whose free-space carve
    # was clamped to that length (hits are still registered at full range).
    clamped_rays: jax.Array


def create(config: OccupancyGridConfig) -> OccupancyGridState:
    C = config.capacity
    return OccupancyGridState(
        coords=jnp.full((C, 3), _SENTINEL, jnp.int32),
        used=jnp.zeros((C,), bool),
        log_odds=jnp.zeros((C,), jnp.float32),
        sum_pos=jnp.zeros((C, 3), jnp.float32),
        hit_count=jnp.zeros((C,), jnp.float32),
        sum_logcov=jnp.zeros((C, 6), jnp.float32),
        sum_rgba=jnp.zeros((C, 4), jnp.float32),
        sum_intensity=jnp.zeros((C,), jnp.float32),
        last_update=jnp.zeros((C,), jnp.int32),
        frame=jnp.int32(0),
        dropped=jnp.int32(0),
        truncated_rays=jnp.int32(0),
        budget_lost=jnp.int32(0),
        clamped_rays=jnp.int32(0),
    )


def _dda_ray_coords(origin: jax.Array, targets: jax.Array, valid: jax.Array,
                    voxel_size: float, max_steps: int):
    """Vectorized exclusive 3-D DDA: voxel coords strictly between origin and
    each target (both endpoints excluded), as ``[N, S, 3]`` plus a validity
    mask.  Mirrors traverse_ray_exclusive_impl (occupancy_grid_map.hpp:821-900).

    ANALYTIC formulation (no sequential walk): with the ray parameterized so
    t=0 at the origin and t=1 at the target, the boundary crossings along
    each axis form an arithmetic sequence t_a(j) = t0_a + j*dt_a.  Sorting
    the merged 3S candidate crossings per ray and cumsum-ing the one-hot
    axis steps reproduces the exact DDA visit order as pure parallel array
    ops — replacing a ``max_steps``-step ``lax.scan`` whose per-step
    dispatch overhead dominated (measured 10x faster carve at S=177).
    """
    S = max_steps
    inv = 1.0 / voxel_size
    so = origin * inv  # [3]
    st = targets * inv  # [N, 3]
    i0 = jnp.floor(so).astype(jnp.int32)
    it = jnp.floor(st).astype(jnp.int32)

    d = st - so[None, :]
    abs_d = jnp.abs(d)
    step = jnp.sign(d).astype(jnp.int32)  # [N, 3]
    eps = jnp.finfo(jnp.float32).eps
    big = jnp.float32(3.0e38)  # finite: avoids 0*inf NaNs downstream
    inv_mag = jnp.where(abs_d > eps, 1.0 / jnp.maximum(abs_d, eps), big)
    frac = so - jnp.floor(so)
    t0 = jnp.where(
        step != 0,
        jnp.where(step > 0, 1.0 - frac[None, :], frac[None, :]) * inv_mag,
        big,
    )  # [N, 3]
    dt = jnp.where(step != 0, inv_mag, big)

    # Per-axis crossing sequences [N, 3, S], clamped to `big` beyond the
    # target (t >= 1) so they sort to the tail.
    j = jnp.arange(S, dtype=jnp.float32)
    t_all = t0[:, :, None] + dt[:, :, None] * j[None, None, :]
    t_all = jnp.where(t_all < 1.0, t_all, big)
    N = targets.shape[0]
    t_flat = t_all.reshape(N, 3 * S)
    axis_flat = jnp.broadcast_to(
        jnp.repeat(jnp.arange(3, dtype=jnp.int32), S)[None, :], (N, 3 * S)
    )
    # Sort crossings by time; axis ids ride the sort as a payload.
    t_sorted, axis_sorted = jax.lax.sort(
        (t_flat, axis_flat), dimension=1, num_keys=1
    )
    t_s = t_sorted[:, :S]
    axis_s = axis_sorted[:, :S]  # [N, S]
    crossed = t_s < 1.0

    onehot = jax.nn.one_hot(axis_s, 3, dtype=jnp.int32)  # [N, S, 3]
    onehot = onehot * crossed[:, :, None]
    pos = i0[None, None, :] + jnp.cumsum(onehot * step[:, None, :], axis=1)

    reached = jnp.all(pos == it[:, None, :], axis=-1)  # entered target voxel
    emit = valid[:, None] & crossed & ~reached

    # Truncation: more crossings than the budget (the tail of the walk is
    # lost).  The exact crossing count of a straight segment is the Manhattan
    # distance between endpoint voxels (budget-independent, unlike counting
    # the already-S-limited t_all entries).
    n_cross = jnp.sum(jnp.abs(it - i0[None, :]), axis=1)
    truncated = valid & (n_cross > S)

    c = pos + COORD_OFFSET
    in_range = jnp.all((c >= 0) & (c <= COORD_MASK), axis=-1)
    emit = emit & in_range
    c = jnp.where(emit[..., None], c, _SENTINEL)
    return c, emit, i0 + COORD_OFFSET, it + COORD_OFFSET, truncated


def _ray_carve_keys(origin: jax.Array, targets: jax.Array, valid: jax.Array,
                    voxel_size: float, axis_budget: int, max_len: float,
                    step_limit: int = 0):
    """Packed int32 cell keys of the voxels strictly between ``origin`` and
    each (length-clamped) target — the carve set of
    traverse_ray_exclusive_impl (occupancy_grid_map.hpp:821-900), computed
    WITHOUT the merged-crossing sort.

    Closed-form DDA: crossing ``j`` of axis ``a`` happens at
    ``t = t0_a + j*dt_a``; the voxel entered there is
    ``i0 + step * n`` where ``n_b`` counts axis-``b`` crossings at or before
    ``t`` (ties broken by axis order, matching the stable merged sort).  Each
    count is a floor/ceil of ``(t - t0_b)/dt_b`` — pure elementwise math, no
    [N,3S] sort, no cumsum (the sort dominated the carve cost: measured
    55 ms for insert+carve at config 7 before this change).

    Per-axis budget ``axis_budget`` >= ceil(max_len/voxel)+1 covers every
    crossing of a clamped ray, so truncation cannot occur.  Keys are packed
    relative to the origin voxel (all carved voxels lie within ``max_len``
    of the origin): ``B = 2*axis_budget + 2`` cells per axis.

    Returns ``(keys [N, 3*Sa] int32 (sentinel when not emitted),
    origin_emit [N] bool, origin_coord [3], base_coord [3], B,
    n_clamped, n_range_lost)``.
    """
    Sa = axis_budget
    B = 2 * Sa + 2
    inv = 1.0 / voxel_size
    eps = jnp.finfo(jnp.float32).eps
    big = jnp.float32(3.0e38)

    d = targets - origin[None, :]
    L = jnp.sqrt(jnp.sum(d * d, axis=-1))
    clamped = valid & (L > max_len)
    scale = jnp.where(L > max_len, max_len / jnp.maximum(L, eps), 1.0)
    tgt = origin[None, :] + d * scale[:, None]

    so = origin * inv  # [3]
    st = tgt * inv  # [N, 3]
    i0 = jnp.floor(so).astype(jnp.int32)  # [3]
    it = jnp.floor(st).astype(jnp.int32)  # [N, 3]

    dvox = st - so[None, :]
    abs_d = jnp.abs(dvox)
    step = jnp.sign(dvox).astype(jnp.int32)  # [N, 3]
    inv_mag = jnp.where(abs_d > eps, 1.0 / jnp.maximum(abs_d, eps), big)
    frac = so - jnp.floor(so)
    t0 = jnp.where(
        step != 0,
        jnp.where(step > 0, 1.0 - frac[None, :], frac[None, :]) * inv_mag,
        big,
    )  # [N, 3]
    dt = jnp.where(step != 0, inv_mag, big)

    nmax = jnp.abs(it - i0[None, :])  # [N, 3] exact per-axis crossing counts

    j = jnp.arange(Sa, dtype=jnp.float32)
    t = t0[:, :, None] + dt[:, :, None] * j[None, None, :]  # [N, 3, Sa]
    exists = jnp.arange(Sa, dtype=jnp.int32)[None, None, :] < nmax[:, :, None]

    # Crossings of axis b at or before t (tie -> include iff b <= a, the
    # stable-sort order); b == a is exactly j+1.
    x = (t[:, :, :, None] - t0[:, None, None, :]) / dt[:, None, None, :]  # [N,3,Sa,3]
    cnt_le = jnp.floor(x).astype(jnp.int32) + 1
    cnt_lt = jnp.ceil(x).astype(jnp.int32)
    a_idx = jnp.arange(3, dtype=jnp.int32)[None, :, None, None]
    b_idx = jnp.arange(3, dtype=jnp.int32)[None, None, None, :]
    n = jnp.where(b_idx < a_idx, cnt_le, cnt_lt)
    n = jnp.where(
        b_idx == a_idx,
        jnp.broadcast_to(
            (jnp.arange(Sa, dtype=jnp.int32) + 1)[None, None, :, None], n.shape
        ),
        n,
    )
    n = jnp.clip(n, 0, nmax[:, None, None, :])
    pos = i0[None, None, None, :] + step[:, None, None, :] * n  # [N, 3, Sa, 3]

    reached = jnp.all(pos == it[:, None, None, :], axis=-1)
    emit = valid[:, None, None] & exists & ~reached

    # Optional manual step limit (config.max_ray_steps > 0): suppress
    # crossings past the limit in merged-DDA order — the rank of a crossing
    # is the number of crossings at or before it, available in closed form
    # as sum_b n_b.  Rays with suppressed crossings are counted as truncated
    # (the auto per-axis budget makes truncation impossible, so this only
    # fires for explicitly configured budgets).
    n_truncated = jnp.int32(0)
    if step_limit > 0:
        rank = jnp.sum(n, axis=-1) - 1  # [N, 3, Sa], 0-based merged order
        over = exists & valid[:, None, None] & (rank >= step_limit)
        n_truncated = jnp.sum(jnp.any(over, axis=(1, 2)).astype(jnp.int32))
        emit = emit & (rank < step_limit)

    base = i0 + COORD_OFFSET - (Sa + 1)  # [3]; carve cells lie in [base, base+B)
    # 21-bit validity of the whole carve window (scalar; clamped rays keep
    # the window within max_len of the origin).
    window_ok = jnp.all((base >= 0) & (base + B <= COORD_MASK))
    rel = (pos + COORD_OFFSET) - base[None, None, None, :]
    in_b = jnp.all((rel >= 0) & (rel < B), axis=-1) & window_ok
    n_range_lost = jnp.sum((emit & ~in_b).astype(jnp.int32))
    emit = emit & in_b

    key = (rel[..., 0] * B + rel[..., 1]) * B + rel[..., 2]
    key = jnp.where(emit, key, jnp.int32(2**31 - 1))

    origin_coord = i0 + COORD_OFFSET
    origin_differs = jnp.any(origin_coord[None, :] != (it + COORD_OFFSET), axis=-1)
    origin_in_range = jnp.all((origin_coord >= 0) & (origin_coord <= COORD_MASK))
    origin_emit = valid & origin_differs & origin_in_range

    N = targets.shape[0]
    return (
        key.reshape(N, 3 * Sa),
        origin_emit,
        origin_coord,
        base,
        B,
        jnp.sum(clamped.astype(jnp.int32)),
        n_range_lost,
        n_truncated,
    )


def _merge_miss_keys(keys_flat, capacity, B, base_coord):
    """Unique-voxel counts for the flattened packed carve keys.

    Three interchangeable implementations (equality pinned by test); the
    default is the sort+run-length one, chosen by on-chip measurement at the
    config-7 shape (1.88M key slots, ~15k real uniques):

    - ``_merge_miss_keys_rle``  (DEFAULT): sort + searchsorted run-length
      extraction — gathers only, no scatter.
    - ``_merge_miss_keys_sort``: sort + segment_sum/segment_min — the
      segment reductions lower to large scatters.
    - ``_merge_miss_keys_dense``: scatter-grid over the B^3 carve window —
      scatter-bound; kept as the alternative.

    Returns (keys [capacity, 3] in offset coords, cnt [capacity], n_lost).
    """
    return _merge_miss_keys_rle(keys_flat, capacity, B, base_coord)


def _merge_miss_keys_rle(keys_flat, capacity, B, base_coord):
    """Sort + run-length unique merge with NO scatters.

    After the key-only sort, each unique voxel is a contiguous run and the
    sentinel keys (2^31-1) form the tail.  ``seg_rank`` (cumsum of run
    starts) is nondecreasing, so the start position of unique #r is
    ``searchsorted(seg_rank, r)`` — a pure-gather binary search replaces
    the segment_sum/segment_min scatters of the sort-based merge, and run
    lengths are start-position differences clipped to the valid prefix.
    """
    sentinel = jnp.int32(2**31 - 1)
    K = keys_flat.shape[0]
    key_s = jax.lax.sort(keys_flat)
    okr = key_s != sentinel
    n_valid = jnp.sum(okr.astype(jnp.int32))
    new_seg = (key_s != jnp.roll(key_s, 1)).at[0].set(True)

    # Run-start positions by a SECOND key-only sort instead of searchsorted:
    # searchsorted(seg_rank, 0..capacity) costs 18-68 ms at this shape (21
    # binary-search gather rounds over the 1.88M rank array; a cond-tiered
    # variant cliffed to 68 ms the moment real carves crossed the tier),
    # while sorting where(run_start, index, INT_MAX) costs one more ~3 ms
    # 1.88M sort and yields the same starts directly: the r-th smallest
    # flagged index IS the start of unique run #r, and absent ranks sort to
    # INT_MAX -> clamp to n_valid, exactly searchsorted's out-of-range value.
    pos = jnp.where(
        new_seg & okr, jnp.arange(K, dtype=jnp.int32), sentinel
    )
    pos_s = jax.lax.sort(pos)
    take = min(capacity + 1, K)
    starts = jnp.minimum(pos_s[:take], n_valid)
    if take < capacity + 1:
        starts = jnp.concatenate(
            [starts, jnp.broadcast_to(n_valid, (capacity + 1 - take,))]
        )
    cnt = (starts[1:] - starts[:-1]).astype(jnp.float32)
    valid = cnt > 0.0
    rep = jnp.where(valid, key_s[jnp.minimum(starts[:-1], keys_flat.shape[0] - 1)], 0)
    # occurrences belonging to uniques beyond `capacity` (fixed-budget loss)
    n_lost = n_valid - starts[capacity]

    rz = rep % B
    ry = (rep // B) % B
    rx = rep // (B * B)
    keys = jnp.stack([rx, ry, rz], axis=-1) + base_coord[None, :]
    keys = jnp.where(valid[:, None], keys, _SENTINEL)
    return keys, cnt, n_lost


def _merge_miss_keys_dense(keys_flat, capacity, B, base_coord):
    """Scatter-grid unique merge over the [B^3] carve window — the
    alternative to the sort-based merge; not measured on the GPU.
    """
    ncells = B * B * B
    dense = jnp.zeros((ncells,), jnp.float32).at[keys_flat].add(1.0, mode="drop")
    occ = dense > 0.0
    rank = jnp.cumsum(occ.astype(jnp.int32)) - 1
    n_lost = jnp.sum(jnp.where(occ & (rank >= capacity), dense, 0.0)).astype(jnp.int32)
    cell = jnp.arange(ncells, dtype=jnp.int32)
    tgt = jnp.where(occ & (rank < capacity), rank, capacity)  # capacity = OOB -> dropped
    rep = jnp.full((capacity,), -1, jnp.int32).at[tgt].set(cell, mode="drop")
    filled = rep >= 0
    cnt = jnp.where(filled, dense[jnp.clip(rep, 0)], 0.0)
    rep = jnp.where(filled, rep, 0)
    rz = rep % B
    ry = (rep // B) % B
    rx = rep // (B * B)
    keys = jnp.stack([rx, ry, rz], axis=-1) + base_coord[None, :]
    keys = jnp.where(filled[:, None], keys, _SENTINEL)
    return keys, cnt, n_lost


def _merge_miss_keys_sort(keys_flat, capacity, B, base_coord):
    """Sort-based unique merge (fallback for carve windows too large for the
    dense grid).

    One key-only ``lax.sort`` orders the int32 keys; counts segment-reduce
    into ``capacity`` slots.  Unique voxels beyond ``capacity`` are clamped
    to the overflow segment (keeping the sorted-indices contract monotone)
    and COUNTED into ``n_lost`` — a fixed-budget loss, not growth-fixable.

    Returns (keys [capacity, 3] in offset coords, cnt [capacity], n_lost).
    """
    sentinel = jnp.int32(2**31 - 1)
    key_s = jax.lax.sort(keys_flat)
    okr = key_s != sentinel
    new_seg = (key_s != jnp.roll(key_s, 1)).at[0].set(True)
    seg_raw = jnp.cumsum((new_seg & okr).astype(jnp.int32)) - 1
    n_lost = jnp.sum((okr & (seg_raw >= capacity)).astype(jnp.int32))
    seg_id = jnp.where(okr, jnp.minimum(seg_raw, capacity), capacity)

    cnt = jax.ops.segment_sum(
        okr.astype(jnp.float32), seg_id, num_segments=capacity + 1,
        indices_are_sorted=True,
    )[:capacity]
    rep = jax.ops.segment_min(
        key_s, seg_id, num_segments=capacity + 1, indices_are_sorted=True
    )[:capacity]
    rep = jnp.where(cnt > 0, rep, 0)
    rz = rep % B
    ry = (rep // B) % B
    rx = rep // (B * B)
    keys = jnp.stack([rx, ry, rz], axis=-1) + base_coord[None, :]
    keys = jnp.where((cnt > 0)[:, None], keys, _SENTINEL)
    return keys, cnt, n_lost


def _segment_merge(coords, w, payloads, capacity):
    """Sort + segment-reduce (coords, payload) rows to unique keys.
    Returns (seg_keys [N,3], seg_valid [N], aggregated payloads,
    n_extent_lost)."""
    N = coords.shape[0]
    order, coords_s, ok_s, seg_id, new_seg, n_extent_lost = sort_by_cell(coords, w > 0)
    w_s = w[order] * ok_s.astype(w.dtype)

    def seg(x):
        xs = x[order]
        if xs.ndim == 1:
            return jax.ops.segment_sum(xs * w_s, seg_id, num_segments=N)
        return jax.ops.segment_sum(xs * w_s[:, None], seg_id, num_segments=N)

    aggs = [seg(p) for p in payloads]
    cnt = jax.ops.segment_sum(w_s, seg_id, num_segments=N)
    first = jnp.full((N,), N - 1, jnp.int32).at[seg_id].min(jnp.arange(N, dtype=jnp.int32))
    seg_keys = coords_s[first]
    return seg_keys, cnt, aggs, n_extent_lost


def add_point_cloud(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose: jax.Array,
) -> OccupancyGridState:
    """Hits + free-space carving + pending log-odds application + pruning
    (OccupancyGridMap::add_point_cloud, occupancy_grid_map.hpp:130-164)."""
    N = cloud.capacity
    R = sensor_pose[:3, :3]
    origin = sensor_pose[:3, 3]
    pts_map = cloud.points @ R.T + origin
    coords, ok, n_range_lost = voxel_coords_counted(pts_map, cloud.mask, config.voxel_size)
    # reference guards dist^2 > eps
    dist_sq = jnp.sum((pts_map - origin) ** 2, axis=-1)
    ok = ok & (dist_sq > jnp.finfo(jnp.float32).eps)

    if cloud.covs is not None:
        cov_map = jnp.einsum("ij,njk,lk->nil", R, cloud.covs, R, precision="highest")
        logcov = _tri_pack(eigh3.spd_log(cov_map))
    else:
        logcov = jnp.zeros((N, 6), jnp.float32)
    rgba = cloud.rgb if cloud.rgb is not None else jnp.zeros((N, 4), jnp.float32)
    inten = cloud.intensities if cloud.intensities is not None else jnp.zeros((N,), jnp.float32)

    # ---- hits -------------------------------------------------------------
    seg_keys, hit_cnt, (agg_pos, agg_logcov, agg_rgba, agg_int), n_extent_lost = _segment_merge(
        coords, ok.astype(jnp.float32), [pts_map, logcov, rgba, inten], config.capacity
    )
    seg_valid = hit_cnt > 0.0
    coords_tbl, used, slot, resolved = resolve_slots(
        state.coords, state.used, seg_keys, seg_valid, config.capacity, config.max_probes
    )
    tgt = jnp.where(resolved, slot, config.capacity)
    pending = jnp.zeros((config.capacity,), jnp.float32)
    pending = pending.at[tgt].add(hit_cnt * config.log_odds_hit, mode="drop")

    sum_pos = state.sum_pos.at[tgt].add(agg_pos, mode="drop")
    hit_count = state.hit_count.at[tgt].add(hit_cnt, mode="drop")
    sum_logcov = state.sum_logcov.at[tgt].add(agg_logcov, mode="drop")
    sum_rgba = state.sum_rgba.at[tgt].add(agg_rgba, mode="drop")
    sum_intensity = state.sum_intensity.at[tgt].add(agg_int, mode="drop")
    last_update = state.last_update.at[tgt].set(state.frame, mode="drop")

    n_dropped = jnp.sum((seg_valid & ~resolved).astype(jnp.int32))
    n_budget_lost = n_range_lost + n_extent_lost
    n_truncated = jnp.int32(0)
    n_clamped = jnp.int32(0)

    # ---- free space (misses) ---------------------------------------------
    if config.free_space_updates_enabled and config.log_odds_miss != 0.0:
        def _carve(carry):
            coords_tbl, used, pending, last_update = carry
            (miss_keys, origin_emit, origin_coord, base, B, n_clamped,
             carve_lost, n_truncated) = _ray_carve_keys(
                origin, pts_map, ok, config.voxel_size,
                config.ray_axis_budget, config.max_ray_distance,
                step_limit=config.max_ray_steps,
            )
            # Per-ray origin miss unless the origin voxel received a hit this
            # frame (occupancy_grid_map.hpp:1427-1434).  All N origin misses
            # hit ONE voxel, so it joins the merged keys as a single appended
            # row instead of N sort rows.
            origin_hit = jnp.any(
                ok & jnp.all(coords == origin_coord[None, :], axis=-1)
            )
            origin_cnt = jnp.where(
                origin_hit, 0.0, jnp.sum(origin_emit.astype(jnp.float32))
            )

            # Lean key-only merge straight into `miss_merge_budget` unique
            # slots; unique voxels beyond the budget are counted into
            # `budget_lost` (a fixed per-frame budget — growing the table
            # cannot raise it).
            m_keys, m_cnt, m_lost = _merge_miss_keys(
                miss_keys.reshape(-1), config.miss_merge_budget, B, base
            )
            # Origin row PREPENDED: merged keys are rank-ordered so valid
            # rows form a front prefix, which the tiered resolve exploits to
            # skip probe work on the (usually empty) budget tail.  The origin
            # voxel never appears among carve emissions (strictly-between
            # semantics), so key uniqueness holds either way.
            m_keys = jnp.concatenate([origin_coord[None, :], m_keys], axis=0)
            m_cnt = jnp.concatenate([origin_cnt[None], m_cnt], axis=0)
            m_valid = m_cnt > 0.0
            coords_tbl, used, m_slot, m_resolved = resolve_slots_tiered(
                coords_tbl, used, m_keys, m_valid, config.capacity,
                config.max_probes,
            )
            m_tgt = jnp.where(m_resolved, m_slot, config.capacity)
            pending = pending.at[m_tgt].add(
                m_cnt * config.log_odds_miss, mode="drop"
            )
            last_update = last_update.at[m_tgt].set(state.frame, mode="drop")
            dn = jnp.sum((m_valid & ~m_resolved).astype(jnp.int32))
            return (coords_tbl, used, pending, last_update,
                    dn, carve_lost + m_lost, n_truncated, n_clamped)

        def _skip(carry):
            coords_tbl, used, pending, last_update = carry
            z = jnp.int32(0)
            return (coords_tbl, used, pending, last_update, z, z, z, z)

        carry = (coords_tbl, used, pending, last_update)
        if config.free_space_update_cycle > 1:
            # carve on the cycle (reference knob semantics); lax.cond skips
            # the whole carve subgraph on off-cycle frames at run time
            (coords_tbl, used, pending, last_update, dn, db, n_truncated,
             n_clamped) = jax.lax.cond(
                state.frame % config.free_space_update_cycle == 0,
                _carve, _skip, carry,
            )
        else:
            (coords_tbl, used, pending, last_update, dn, db, n_truncated,
             n_clamped) = _carve(carry)
        n_dropped = n_dropped + dn
        n_budget_lost = n_budget_lost + db

    # ---- apply pending with clamp ----------------------------------------
    log_odds = jnp.where(
        used & (pending != 0.0),
        jnp.clip(state.log_odds + pending, config.min_log_odds, config.max_log_odds),
        state.log_odds,
    )

    new_state = OccupancyGridState(
        coords=coords_tbl, used=used, log_odds=log_odds, sum_pos=sum_pos,
        hit_count=hit_count, sum_logcov=sum_logcov, sum_rgba=sum_rgba,
        sum_intensity=sum_intensity, last_update=last_update, frame=state.frame + 1,
        dropped=state.dropped + n_dropped,
        truncated_rays=state.truncated_rays + n_truncated,
        budget_lost=state.budget_lost + n_budget_lost,
        clamped_rays=state.clamped_rays + n_clamped,
    )
    if config.voxel_pruning_enabled:
        new_state = prune_stale_voxels(new_state, config)
    return new_state


def prune_stale_voxels(state: OccupancyGridState, config: OccupancyGridConfig) -> OccupancyGridState:
    """Clear voxels not updated within stale_frame_threshold frames
    (occupancy_grid_map.hpp:1485)."""
    age = state.frame - state.last_update
    stale = state.used & (age > config.stale_frame_threshold)
    keep = ~stale
    kf = keep.astype(jnp.float32)
    return dataclasses.replace(
        state,
        coords=jnp.where(keep[:, None], state.coords, _SENTINEL),
        used=state.used & keep,
        log_odds=state.log_odds * kf,
        sum_pos=state.sum_pos * kf[:, None],
        hit_count=state.hit_count * kf,
        sum_logcov=state.sum_logcov * kf[:, None],
        sum_rgba=state.sum_rgba * kf[:, None],
        sum_intensity=state.sum_intensity * kf,
        last_update=jnp.where(keep, state.last_update, 0),
    )


def voxel_count(state: OccupancyGridState) -> jax.Array:
    return jnp.sum(state.used.astype(jnp.int32))


def load_factor(state: OccupancyGridState, config: OccupancyGridConfig) -> jax.Array:
    return jnp.sum(state.used.astype(jnp.float32)) / config.capacity


def grow(
    state: OccupancyGridState, config: OccupancyGridConfig, factor: int = 2
) -> tuple[OccupancyGridState, OccupancyGridConfig]:
    """Re-insert every used slot into a ``factor``-times-larger table (the
    static-shape analog of the reference rehash, voxel_hash_map.hpp:847-934;
    the occupancy grid shares that hash infrastructure)."""
    new_config = dataclasses.replace(config, capacity=config.capacity * factor)
    new = create(new_config)
    coords_tbl, used, slot, resolved = resolve_slots(
        new.coords, new.used, state.coords, state.used,
        new_config.capacity, new_config.max_probes,
    )
    tgt = jnp.where(resolved, slot, new_config.capacity)
    moved = OccupancyGridState(
        coords=coords_tbl,
        used=used,
        log_odds=new.log_odds.at[tgt].set(state.log_odds, mode="drop"),
        sum_pos=new.sum_pos.at[tgt].set(state.sum_pos, mode="drop"),
        hit_count=new.hit_count.at[tgt].set(state.hit_count, mode="drop"),
        sum_logcov=new.sum_logcov.at[tgt].set(state.sum_logcov, mode="drop"),
        sum_rgba=new.sum_rgba.at[tgt].set(state.sum_rgba, mode="drop"),
        sum_intensity=new.sum_intensity.at[tgt].set(state.sum_intensity, mode="drop"),
        last_update=new.last_update.at[tgt].set(state.last_update, mode="drop"),
        frame=state.frame,
        dropped=state.dropped + jnp.sum((state.used & ~resolved).astype(jnp.int32)),
        truncated_rays=state.truncated_rays,
        budget_lost=state.budget_lost,
        clamped_rays=state.clamped_rays,
    )
    return moved, new_config


def add_point_cloud_auto(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose,
    max_load: float = 0.7,
    max_grow_steps: int = 8,
) -> tuple[OccupancyGridState, OccupancyGridConfig]:
    """Host-side insertion with growth: grow while load exceeds ``max_load``,
    insert, and retry the same insert on a grown table if any contribution
    was dropped (pre-insert state is kept — retried inserts lose nothing)."""
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


def voxel_probability(state: OccupancyGridState, config: OccupancyGridConfig,
                      position: jax.Array) -> jax.Array:
    """Occupancy probability at a world position (occupancy_grid_map.hpp:85-92);
    0.5 for unknown voxels."""
    coords, ok = voxel_coords(position[None, :], jnp.ones((1,), bool), config.voxel_size)
    slot, found = lookup_slots(
        state.coords, state.used, coords, ok, config.capacity, config.max_probes
    )
    lo = jnp.where(found[0], state.log_odds[jnp.maximum(slot[0], 0)], 0.0)
    return jax.nn.sigmoid(lo)


def _occupied_mask(state: OccupancyGridState, config: OccupancyGridConfig):
    return (
        state.used
        & (state.hit_count > 0.0)
        & (state.log_odds >= config.occupancy_threshold_log_odds)
    )


def extract_occupied_points(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    sensor_position: jax.Array,
    max_distance: float = 100.0,
    out_capacity: int = 1 << 15,
    with_covs: bool = False,
    with_rgb: bool = False,
    with_intensity: bool = False,
    with_overflow: bool = False,
):
    """Occupied-voxel centroids within L-inf range of the sensor
    (occupancy_grid_map.hpp:1530, 169-181).

    On overflow the NEAREST ``out_capacity`` voxels to the sensor are kept;
    ``with_overflow`` returns ``(cloud, n_overflow)`` (no silent caps)."""
    cnt_safe = jnp.maximum(state.hit_count, 1.0)
    centroid = state.sum_pos / cnt_safe[:, None]
    inside = jnp.all(jnp.abs(centroid - sensor_position) <= max_distance, axis=-1)
    keep = _occupied_mask(state, config) & inside

    # O(C) cumsum compaction over used slots (not O(C log C) argsort) while
    # the kept set fits; overflow switches to nearest-to-sensor retention.
    dist_sq = jnp.sum((centroid - sensor_position) ** 2, axis=-1)
    order, mask, n_overflow = compact_indices_ranked(keep, dist_sq, out_capacity)
    covs = None
    if with_covs:
        covs = eigh3.spd_exp(_tri_unpack(state.sum_logcov[order] / cnt_safe[order, None]))
    out = PointCloud(
        points=centroid[order],
        mask=mask,
        covs=covs,
        rgb=state.sum_rgba[order] / cnt_safe[order, None] if with_rgb else None,
        intensities=state.sum_intensity[order] / cnt_safe[order] if with_intensity else None,
    )
    if with_overflow:
        return out, n_overflow
    return out


def extract_visible_points(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    sensor_pose: jax.Array,
    max_distance: float,
    horizontal_fov: float,
    vertical_fov: float,
    out_capacity: int = 1 << 14,
) -> PointCloud:
    """[Experimental] FOV cone test + per-point occlusion ray-march
    (occupancy_grid_map.hpp:189-411).  A voxel is visible when its centroid
    lies inside the field of view within range AND no occupied voxel blocks
    the ray from the sensor."""
    horizontal_fov = min(max(horizontal_fov, 1e-3), math.pi - 1e-3)
    vertical_fov = min(max(vertical_fov, 1e-3), 2.0 * math.pi - 1e-3)

    sensor_pos = sensor_pose[:3, 3]
    Rt = sensor_pose[:3, :3].T
    cnt_safe = jnp.maximum(state.hit_count, 1.0)
    centroid = state.sum_pos / cnt_safe[:, None]
    occupied = _occupied_mask(state, config)

    diff = centroid - sensor_pos
    dist_sq = jnp.sum(diff * diff, axis=-1)
    in_range = dist_sq <= max_distance * max_distance

    local = diff @ Rt.T
    fwd = local[:, 0]
    cos_h_lim = math.cos(horizontal_fov * 0.5)
    cos_v_lim = math.cos(vertical_fov * 0.5)
    h_norm = jnp.sqrt(jnp.maximum(fwd**2 + local[:, 1] ** 2, 1e-30))
    v_norm = jnp.sqrt(jnp.maximum(fwd**2 + local[:, 2] ** 2, 1e-30))
    cos_h = jnp.clip(fwd / h_norm, -1.0, 1.0)
    cos_v = jnp.clip(fwd / v_norm, -1.0, 1.0)
    in_fov = (cos_h >= cos_h_lim) & (cos_v >= cos_v_lim) & (fwd > 0.0)

    candidate = occupied & in_range & in_fov

    # Select up to out_capacity candidates, then occlusion-test each.
    order, sel_mask = compact_indices(candidate, out_capacity)
    sel_centroid = centroid[order]

    ray_coords, ray_emit, _, _, _ = _dda_ray_coords(
        sensor_pos, sel_centroid, sel_mask, config.voxel_size, config.ray_step_budget
    )
    S = config.ray_step_budget
    flat_coords = ray_coords.reshape(-1, 3)
    flat_valid = ray_emit.reshape(-1)
    slot, found = lookup_slots(
        state.coords, state.used, flat_coords, flat_valid, config.capacity, config.max_probes
    )
    blocked_vox = found & _occupied_mask(state, config)[jnp.maximum(slot, 0)]
    occluded = jnp.any((blocked_vox & flat_valid).reshape(out_capacity, S), axis=-1)
    visible = sel_mask & ~occluded
    return PointCloud(points=sel_centroid, mask=visible)


def compute_overlap_ratio(
    state: OccupancyGridState,
    config: OccupancyGridConfig,
    cloud: PointCloud,
    sensor_pose: jax.Array,
) -> jax.Array:
    """Fraction of cloud points landing in occupied voxels
    (occupancy_grid_map.hpp:417-472)."""
    R = sensor_pose[:3, :3]
    pts_map = cloud.points @ R.T + sensor_pose[:3, 3]
    coords, ok = voxel_coords(pts_map, cloud.mask, config.voxel_size)
    slot, found = lookup_slots(
        state.coords, state.used, coords, ok, config.capacity, config.max_probes
    )
    occ = _occupied_mask(state, config)[jnp.maximum(slot, 0)] & found
    n = jnp.maximum(jnp.sum(cloud.mask.astype(jnp.float32)), 1.0)
    return jnp.sum(occ.astype(jnp.float32)) / n
