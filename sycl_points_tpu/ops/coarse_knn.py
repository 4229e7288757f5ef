"""Coarse-to-fine candidate KNN for very large target clouds.

The brute-force scan (ops/knn.py) is linear in the target count M — a
real capability boundary for very large maps.  This is the
sub-linear tier replacing what the reference does with a KD-tree
(``algorithms/knn/kdtree.hpp:424-562``): no per-query stacks or
data-dependent traversal — a two-level candidate search built from the
operations the hardware is good at:

  * **build** (device, one sort): bucket targets into coarse cells
    (sorted-contiguous layout, as ops/grid_knn.py), then reduce each cell
    to a summary — centroid, covering radius, slice start/count;
  * **search**: rank ALL cell summaries per query by the distance **lower
    bound** ``max(0, |q - centroid| - radius)`` — one [Q, C] broadcast
    distance computation with C = cells, not points — take the top-P
    cells, gather their first L points each, and refine exactly on the
    [P*L] candidates.

**Exactness certificate.** The result for a query is PROVABLY exact when
the found k-th distance is <= the smallest lower bound among cells NOT
searched (everything unexplored is provably farther).  ``search`` returns
that per-query certificate; ``certified_fraction`` is the honest
self-measuring analog of a recall floor — no silent approximation.

Telemetry (no silent caps): points beyond the per-cell candidate budget L
and cells beyond the C capacity are counted at build (``overflow``,
``cells_lost``); such points are invisible to searches and the counters
say exactly how many.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.knn import KNNResult
from sycl_points_tpu.ops.transform import transform_points
from sycl_points_tpu.ops.voxel import sort_by_cell, voxel_coords
from sycl_points_tpu.points.point_cloud import PointCloud

_BIG = jnp.float32(jnp.inf)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoarseKNN:
    points: jax.Array      # [M, 3] sorted by cell
    mask: jax.Array        # [M] valid (sorted)
    centroids: jax.Array   # [C, 3]
    radii: jax.Array       # [C] covering radius per cell
    starts: jax.Array      # [C] slice start into the sorted arrays
    counts: jax.Array      # [C]
    valid: jax.Array       # [C] cell occupied
    overflow: jax.Array    # scalar i32: points beyond the per-cell budget
    cells_lost: jax.Array  # scalar i32: cells beyond the C capacity
    points_lost: jax.Array  # scalar i32: valid points outside the sort-key
    # extent/coordinate budget (ops/voxel.py) — invisible to search
    max_per_cell: int = dataclasses.field(metadata=dict(static=True), default=64)

    @staticmethod
    def build(
        cloud: PointCloud,
        coarse_cell: float,
        cells_capacity: Optional[int] = None,
        max_per_cell: int = 64,
    ) -> "CoarseKNN":
        """Jittable device build: ONE lexsort + segment reductions."""
        N = cloud.capacity
        # default C trades ranking-matmul width against coverage; dense
        # LiDAR worlds occupy far fewer cells than N/8, and cells_lost
        # reports any shortfall (certificates then report uncertified)
        C = cells_capacity or max(256, 1 << (max(N // 8, 1) - 1).bit_length())
        coords, ok = voxel_coords(cloud.points, cloud.mask, coarse_cell)
        order, _coords_s, ok_s, seg_id, _new_seg, n_lost = sort_by_cell(coords, ok)
        pts_s = cloud.points[order]

        pos = jnp.arange(N, dtype=jnp.int32)
        # segment ids are contiguous in sorted order; cap to C (+1 slot for
        # the overflow segment so reductions stay in bounds)
        lost_cells = jnp.max(jnp.where(ok_s, seg_id, -1)) + 1 - C
        seg_c = jnp.minimum(seg_id, C)
        w = ok_s.astype(jnp.float32)
        counts_f = jax.ops.segment_sum(w, seg_c, num_segments=C + 1)
        sums = jax.ops.segment_sum(pts_s * w[:, None], seg_c, num_segments=C + 1)
        centroids = sums / jnp.maximum(counts_f[:, None], 1.0)
        d_cent = jnp.linalg.norm(pts_s - centroids[seg_c], axis=1) * w
        radii = jax.ops.segment_max(d_cent, seg_c, num_segments=C + 1)
        starts = jnp.full((C + 1,), N, jnp.int32).at[seg_c].min(
            jnp.where(ok_s, pos, N)
        )
        counts = counts_f.astype(jnp.int32)
        over = jnp.sum(jnp.maximum(counts[:C] - max_per_cell, 0)) + counts[C]

        return CoarseKNN(
            points=pts_s,
            mask=ok_s,
            centroids=centroids[:C],
            radii=jnp.where(counts[:C] > 0, radii[:C], 0.0),
            starts=jnp.minimum(starts[:C], N - 1),
            counts=counts[:C],
            valid=counts[:C] > 0,
            overflow=over,
            cells_lost=jnp.maximum(lost_cells, 0),
            points_lost=jnp.asarray(n_lost, jnp.int32),
            max_per_cell=max_per_cell,
        )

    def search(
        self,
        query_points: jax.Array,
        k: int,
        pose: Optional[jax.Array] = None,
        top_cells: int = 8,
        chunk: int = 2048,
        margin: float = 1e-2,
    ) -> tuple[KNNResult, jax.Array]:
        """Candidate search; returns ``(KNNResult, certified)`` where
        ``certified[q]`` is True when the result is provably exact (k-th
        distance <= tightest lower bound of every unexplored cell).
        Distances are squared, matching the other KNN backends; indices
        refer to positions in the SORTED target layout (self.points/mask —
        the layout served to registration).

        The [q, C] cell ranking runs as one matmul; ``margin`` is
        subtracted from every lower bound to absorb the matmul's f32
        cancellation noise, making the certificate strictly conservative
        (a borderline query reports uncertified, never falsely exact)."""
        q = query_points if pose is None else transform_points(query_points, pose)
        Q = q.shape[0]
        P, L = top_cells, self.max_per_cell
        N = self.points.shape[0]

        def one_chunk(qc):
            # [q, C] lower bounds from the cell summaries (one matmul; no
            # [q, C, 3] broadcast temporary)
            q2 = jnp.sum(qc * qc, axis=1, keepdims=True)
            c2 = jnp.sum(self.centroids * self.centroids, axis=1)[None, :]
            d2c = jnp.maximum(q2 + c2 - 2.0 * (qc @ self.centroids.T), 0.0)
            d_cent = jnp.sqrt(d2c)
            lb = jnp.maximum(d_cent - self.radii[None, :] - margin, 0.0)
            lb = jnp.where(self.valid[None, :], lb, _BIG)
            # one top-k gives both the P selected cells and the tightest
            # unexplored bound (the P+1-th best)
            if P < lb.shape[1]:
                neg_lb, cells_all = jax.lax.top_k(-lb, P + 1)
                cells = cells_all[:, :P]
                lb_unexplored = -neg_lb[:, P]
            else:
                _neg_lb, cells = jax.lax.top_k(-lb, P)
                lb_unexplored = jnp.full((qc.shape[0],), _BIG)

            # gather the candidate block: [q, P, L]
            idx = self.starts[cells][:, :, None] + jnp.arange(L, dtype=jnp.int32)
            in_cell = jnp.arange(L, dtype=jnp.int32)[None, None, :] < \
                self.counts[cells][:, :, None]
            idx = jnp.clip(idx, 0, N - 1)
            cand = self.points[idx]                         # [q, P, L, 3]
            ok = in_cell & self.mask[idx] & self.valid[cells][:, :, None]
            d2 = jnp.sum((cand - qc[:, None, None, :]) ** 2, axis=-1)
            d2 = jnp.where(ok, d2, _BIG)
            d2f = d2.reshape(qc.shape[0], P * L)
            idxf = idx.reshape(qc.shape[0], P * L)
            if k == 1:
                best = jnp.argmin(d2f, axis=1)
                dk = jnp.take_along_axis(d2f, best[:, None], axis=1)
                ik = jnp.take_along_axis(idxf, best[:, None], axis=1)
            else:
                negd, sel = jax.lax.top_k(-d2f, k)
                dk = -negd
                ik = jnp.take_along_axis(idxf, sel, axis=1)
            # certificate: k-th found distance vs unexplored lower bound —
            # AND every selected cell fully searched (count <= L) AND no
            # cell was lost at build, else unseen points void the bound
            kth = jnp.sqrt(jnp.where(jnp.isfinite(dk[:, -1]), dk[:, -1], _BIG))
            sel_complete = jnp.all(
                self.counts[cells] <= jnp.int32(L), axis=1
            )
            certified = (
                (kth <= lb_unexplored)
                & sel_complete
                & (self.cells_lost == 0)
                & (self.points_lost == 0)
            )
            return ik.astype(jnp.int32), dk, certified

        outs = []
        for s in range(0, Q, chunk):
            outs.append(one_chunk(q[s:s + chunk]))
        ik = jnp.concatenate([o[0] for o in outs], axis=0)
        dk = jnp.concatenate([o[1] for o in outs], axis=0)
        cert = jnp.concatenate([o[2] for o in outs], axis=0)
        return KNNResult(indices=ik, distances=dk), cert
