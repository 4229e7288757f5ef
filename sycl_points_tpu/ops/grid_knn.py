"""Grid-bucket KNN: sorted voxel buckets + 27-cell neighborhood search.

Replacement for the reference's pointer-based KD-tree and octree
(``algorithms/knn/kdtree.hpp``, ``algorithms/knn/octree.hpp`` in
fateshelled/sycl_points).  Trees need per-query stacks and data-dependent
traversal — a poor fit for static-shape, data-parallel code.  Instead:

  * build: bucket points into voxel cells (cell coords -> hash table via the
    mapping scatter-claim machinery), lexsort points by cell so each cell is
    a contiguous slice, record per-cell (start, count);
  * search: for each query, look up the 27 neighboring cells (statically
    unrolled), gather a fixed candidate budget per cell, compute distances
    and merge top-k.  Like the reference search, a ``pose`` transforms the
    queries inside the kernel.

Exactness contract: any neighbor within ``cell_size`` of the query is inside
the 27-cell neighborhood, so results are EXACT for neighbors closer than
``cell_size`` (choose cell_size >= max_correspondence_distance for exact ICP
correspondences).  Farther neighbors may be missed (distance inf) — the same
bounded-search trade the reference octree makes with its traversal caps.

The pipeline's auto-selection (ops.knn.build_target_knn) never picks it:
brute force is the default until the crossover is measured on the GPU
(``scripts/measure_grid_crossover.py``).  It remains an explicit opt-in for
memory-constrained cases (its candidate set is O(Q*27P) instead of O(Q*M)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.mapping.hash_table import lookup_slots, resolve_slots
from sycl_points_tpu.ops.knn import KNNResult
from sycl_points_tpu.ops.transform import transform_points
from sycl_points_tpu.ops.voxel import _SENTINEL, sort_by_cell, voxel_coords
from sycl_points_tpu.points.point_cloud import PointCloud

_BIG = float("inf")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridKNN:
    points: jax.Array  # [M, 3] sorted by cell
    mask: jax.Array  # [M]
    orig_idx: jax.Array  # [M] int32 sorted -> original index
    cell_coords: jax.Array  # [C, 3] hash table keys
    cell_used: jax.Array  # [C]
    cell_start: jax.Array  # [C] int32 start into the sorted arrays
    cell_count: jax.Array  # [C] int32
    cell_size: jax.Array  # scalar f32
    # telemetry: points beyond the per-cell candidate budget (invisible to
    # searches) and cells lost to hash-probe exhaustion — never silent.
    overflow: jax.Array  # scalar int32
    cells_dropped: jax.Array  # scalar int32
    max_probes: int = dataclasses.field(metadata=dict(static=True), default=16)
    max_per_cell: int = dataclasses.field(metadata=dict(static=True), default=32)

    @staticmethod
    def build(
        cloud: PointCloud,
        cell_size: float,
        table_capacity: Optional[int] = None,
        max_probes: int = 16,
        max_per_cell: int = 32,
    ) -> "GridKNN":
        """Bucket the cloud (jittable; capacity static)."""
        N = cloud.capacity
        cap = table_capacity or max(256, 1 << (N - 1).bit_length())
        coords, ok = voxel_coords(cloud.points, cloud.mask, cell_size)

        order, coords_s, ok_s, seg_id, new_seg, _n_extent_lost = sort_by_cell(coords, ok)

        pos = jnp.arange(N, dtype=jnp.int32)
        seg_start = jnp.full((N,), N, jnp.int32).at[seg_id].min(pos)
        seg_count = jax.ops.segment_sum(ok_s.astype(jnp.int32), seg_id, num_segments=N)
        seg_keys = coords_s[jnp.clip(seg_start, 0, N - 1)]
        seg_valid = seg_count > 0

        tbl_coords = jnp.full((cap, 3), _SENTINEL, jnp.int32)
        tbl_used = jnp.zeros((cap,), bool)
        tbl_coords, tbl_used, slot, resolved = resolve_slots(
            tbl_coords, tbl_used, seg_keys, seg_valid, cap, max_probes
        )
        tgt = jnp.where(resolved, slot, cap)
        cell_start = jnp.zeros((cap,), jnp.int32).at[tgt].set(seg_start, mode="drop")
        cell_count = jnp.zeros((cap,), jnp.int32).at[tgt].set(seg_count, mode="drop")

        return GridKNN(
            points=cloud.points[order],
            mask=cloud.mask[order] & ok_s,
            orig_idx=order.astype(jnp.int32),
            cell_coords=tbl_coords,
            cell_used=tbl_used,
            cell_start=cell_start,
            cell_count=cell_count,
            cell_size=jnp.float32(cell_size),
            overflow=jnp.sum(jnp.maximum(seg_count - max_per_cell, 0)),
            cells_dropped=jnp.sum((seg_valid & ~resolved).astype(jnp.int32)),
            max_probes=max_probes,
            max_per_cell=max_per_cell,
        )

    @staticmethod
    def build_auto(
        cloud: PointCloud,
        cell_size: float,
        max_per_cell: int = 32,
        max_per_cell_cap: int = 256,
    ) -> "GridKNN":
        """Host-side build that REBUILDS (static recompile) with a doubled
        per-cell budget or table capacity until the telemetry counters are
        zero, so no candidate is silently invisible to searches."""
        cap = None
        for _ in range(8):
            g = _build_jit(
                cloud,
                cell_size=cell_size,
                table_capacity=cap,
                max_probes=16,
                max_per_cell=max_per_cell,
            )
            dropped = int(g.cells_dropped)
            overflow = int(g.overflow)
            if dropped == 0 and (overflow == 0 or max_per_cell >= max_per_cell_cap):
                return g
            if dropped > 0:
                cap = 2 * (cap or g.cell_coords.shape[0])
            if overflow > 0 and max_per_cell < max_per_cell_cap:
                max_per_cell = min(2 * max_per_cell, max_per_cell_cap)
        return g

    def search(
        self,
        query_points: jax.Array,
        k: int,
        pose: Optional[jax.Array] = None,
        chunk: int = 0,  # unused; interface parity with BruteForceKNN
    ) -> KNNResult:
        """27-cell bounded KNN (indices refer to the ORIGINAL cloud order)."""
        if pose is not None:
            query_points = transform_points(query_points, pose)
        Q = query_points.shape[0]
        C = self.cell_coords.shape[0]
        P = self.max_per_cell

        qcoords, q_ok = voxel_coords(
            query_points, jnp.ones((Q,), bool), self.cell_size
        )
        # 27 neighbor offsets, statically unrolled into one lookup batch.
        offs = jnp.asarray(
            [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
            jnp.int32,
        )  # [27, 3]
        cand_coords = (qcoords[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        cand_valid = jnp.repeat(q_ok, 27)
        slot, found = lookup_slots(
            self.cell_coords, self.cell_used, cand_coords, cand_valid, C, self.max_probes
        )
        slot_safe = jnp.maximum(slot, 0)
        start = jnp.where(found, self.cell_start[slot_safe], 0).reshape(Q, 27)
        count = jnp.where(found, self.cell_count[slot_safe], 0).reshape(Q, 27)

        lane = jnp.arange(P, dtype=jnp.int32)
        idx = start[:, :, None] + lane[None, None, :]  # [Q, 27, P]
        valid = lane[None, None, :] < jnp.minimum(count[:, :, None], P)
        idx_flat = jnp.clip(idx.reshape(Q, 27 * P), 0, self.points.shape[0] - 1)
        valid = valid.reshape(Q, 27 * P) & self.mask[idx_flat]

        nbr = self.points[idx_flat]  # [Q, 27P, 3]
        d2 = jnp.sum((nbr - query_points[:, None, :]) ** 2, axis=-1)
        d2 = jnp.where(valid, d2, _BIG)
        orig = self.orig_idx[idx_flat]

        if k == 1:
            j = jnp.argmin(d2, axis=1)
            best_d = jnp.take_along_axis(d2, j[:, None], axis=1)
            best_i = jnp.take_along_axis(orig, j[:, None], axis=1)
            return KNNResult(best_i, best_d)

        neg_d, sel = jax.lax.top_k(-d2, k)
        return KNNResult(jnp.take_along_axis(orig, sel, axis=1), -neg_d)

    def radius_search(self, query_points, radius, max_k, pose=None) -> KNNResult:
        res = self.search(query_points, max_k, pose)
        within = res.distances <= radius * radius
        return KNNResult(
            jnp.where(within, res.indices, -1),
            jnp.where(within, res.distances, _BIG),
        )

    def remove_points(self, keep: jax.Array) -> "GridKNN":
        """Invalidate points without rebuilding, the analog of the reference's
        in-place ``remove_nodes_by_flags`` (knn/kdtree.hpp:721-765,
        knn/octree.hpp:276-380).  ``keep`` is in ORIGINAL point order."""
        return dataclasses.replace(self, mask=self.mask & keep[self.orig_idx])


_build_jit = jax.jit(
    GridKNN.build,
    static_argnames=("cell_size", "table_capacity", "max_probes", "max_per_cell"),
)
