"""K-nearest-neighbor search.

Replaces the reference KNN stack (``algorithms/knn/`` in
fateshelled/sycl_points).  Pointer-chasing KD-trees/octrees
(``knn/kdtree.hpp``, ``knn/octree.hpp``) map poorly onto an accelerator;
the design here is:

  * brute force as chunked distance blocks with a running top-k merge
    (this module) — replaces ``knn/bruteforce.hpp:24-96`` and is the
    default for the cloud sizes this library targets (10k-100k points after
    downsampling);
  * a sorted grid-bucket structure for very large maps
    (:mod:`sycl_points_tpu.ops.grid_knn`).

Interface parity: like ``KNNBase::knn_search_async`` (knn/knn.hpp:14-61),
searches accept a ``pose`` that transforms the queries inside the kernel so
ICP can re-search correspondences each iteration without rewriting the cloud.
``KNNResult`` is the flat (indices, squared-distances) pair of
``knn/result.hpp:12-34``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from sycl_points_tpu.points.point_cloud import PointCloud, round_up
from sycl_points_tpu.ops.transform import transform_points


class KNNResult(NamedTuple):
    indices: jax.Array  # [Q, k] int32 into the target arrays
    distances: jax.Array  # [Q, k] float32 squared L2 (inf where missing)


_BIG = float("inf")  # plain float: no backend init at import time


def _pairwise_sqdist(q: jax.Array, t: jax.Array) -> jax.Array:
    """Squared L2 distances ``[Q, C]`` as the broadcast sum_k (q_k - t_k)^2.

    Exact in float32 (no |q|^2 + |t|^2 - 2 q.t cancellation, which loses
    ~1e-4 m^2 at 50 m ranges and flips near neighbours).  With a contraction
    dim of only 3, XLA fuses the ``[Q, C, 3]`` intermediate into the
    consumer.
    """
    diff = q[:, None, :] - t[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def brute_force_knn(
    target_points: jax.Array,
    target_mask: jax.Array,
    query_points: jax.Array,
    k: int,
    pose: Optional[jax.Array] = None,
    chunk: int = 8192,
) -> KNNResult:
    """Exact KNN by tiled distance matmul + running top-k merge.

    ``pose`` (4x4), when given, is applied to the queries before the search
    (the ``transT`` convention of the reference, knn/kdtree.hpp:461-470).
    """
    if pose is not None:
        query_points = transform_points(query_points, pose)

    M = target_points.shape[0]
    Q = query_points.shape[0]
    if k > 1:
        # Narrow chunks keep each top_k cheap; the scan merge beats one wide
        # top_k over the full target (measured).
        chunk = min(chunk, 4096)
    chunk = min(chunk, round_up(M, 128))
    n_chunks = -(-M // chunk)

    if n_chunks == 1 and k == 1:
        # Flat path: one fused broadcast-distance + argmin, no scan machinery
        # (the common case after downsampling; the ICP correspondence hot
        # path).
        d2 = _pairwise_sqdist(query_points, target_points)
        d2 = jnp.where(target_mask[None, :], d2, _BIG)
        i = jnp.argmin(d2, axis=1).astype(jnp.int32)
        d = jnp.take_along_axis(d2, i[:, None], axis=1)
        return KNNResult(i[:, None], d)
    Mp = n_chunks * chunk
    if Mp != M:
        pad = Mp - M
        target_points = jnp.concatenate(
            [target_points, jnp.zeros((pad, 3), target_points.dtype)], axis=0
        )
        target_mask = jnp.concatenate([target_mask, jnp.zeros((pad,), bool)], axis=0)

    t_chunks = target_points.reshape(n_chunks, chunk, 3)
    m_chunks = target_mask.reshape(n_chunks, chunk)

    if k == 1:
        def body(carry, inp):
            best_d, best_i = carry
            tc, mc, base = inp
            d2 = _pairwise_sqdist(query_points, tc)
            d2 = jnp.where(mc[None, :], d2, _BIG)
            cd = jnp.min(d2, axis=1)
            ci = jnp.argmin(d2, axis=1).astype(jnp.int32) + base
            take = cd < best_d
            return (jnp.where(take, cd, best_d), jnp.where(take, ci, best_i)), None

        init = (jnp.full((Q,), _BIG), jnp.zeros((Q,), jnp.int32))
        bases = (jnp.arange(n_chunks, dtype=jnp.int32) * chunk)
        (best_d, best_i), _ = jax.lax.scan(body, init, (t_chunks, m_chunks, bases))
        return KNNResult(best_i[:, None], best_d[:, None])

    def body(carry, inp):
        best_d, best_i = carry  # [Q, k]
        tc, mc, base = inp
        d2 = jnp.where(mc[None, :], _pairwise_sqdist(query_points, tc), _BIG)
        cand_d = jnp.concatenate([best_d, d2], axis=1)  # [Q, k + chunk]
        chunk_ids = jnp.arange(chunk, dtype=jnp.int32)[None, :] + base
        cand_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(chunk_ids, d2.shape)], axis=1
        )
        neg_d, sel = jax.lax.top_k(-cand_d, k)
        return (-neg_d, jnp.take_along_axis(cand_i, sel, axis=1)), None

    init = (
        jnp.full((Q, k), _BIG),
        jnp.zeros((Q, k), jnp.int32),
    )
    bases = (jnp.arange(n_chunks, dtype=jnp.int32) * chunk)
    (best_d, best_i), _ = jax.lax.scan(body, init, (t_chunks, m_chunks, bases))
    return KNNResult(best_i, best_d)


def approx_knn(
    target_points: jax.Array,
    target_mask: jax.Array,
    query_points: jax.Array,
    k: int,
    pose: Optional[jax.Array] = None,
    chunk: int = 16384,
) -> KNNResult:
    """KNN via ``lax.approx_max_k`` over wide target chunks.

    Used for neighborhood collection (covariance/normal estimation); the ICP
    correspondence search stays on :func:`brute_force_knn`.  Backends
    without an approximate top-k lowering (CPU and GPU) lower
    ``approx_max_k`` to an exact top-k, so there the result equals
    :func:`brute_force_knn`.

    Targets beyond ``chunk`` are processed by a scan whose per-chunk top-k
    results merge through an exact top-k over 2k candidates.
    """
    if pose is not None:
        query_points = transform_points(query_points, pose)
    M = target_points.shape[0]
    Q = query_points.shape[0]
    chunk = min(chunk, round_up(M, 128))
    n_chunks = -(-M // chunk)

    # Masked target rows are zeroed before the distance: filter_by_mask
    # leaves stale (possibly non-finite) data there, and NaN would beat the
    # mask (NaN - inf = NaN).
    def _neg_d2(q, t, t_mask):
        t = jnp.where(t_mask[:, None], t, 0.0)
        return jnp.where(t_mask[None, :], -_pairwise_sqdist(q, t), -jnp.inf)

    if n_chunks == 1:
        score = _neg_d2(query_points, target_points, target_mask)
        neg_d, idx = jax.lax.approx_max_k(score, k)
        return KNNResult(idx.astype(jnp.int32), -neg_d)

    Mp = n_chunks * chunk
    if Mp != M:
        pad = Mp - M
        target_points = jnp.concatenate(
            [target_points, jnp.zeros((pad, 3), target_points.dtype)], axis=0
        )
        target_mask = jnp.concatenate([target_mask, jnp.zeros((pad,), bool)], axis=0)
    t_chunks = target_points.reshape(n_chunks, chunk, 3)
    m_chunks = target_mask.reshape(n_chunks, chunk)

    def body(carry, inp):
        best_d, best_i = carry
        tc, mc, base = inp
        score = _neg_d2(query_points, tc, mc)
        neg_d, idx = jax.lax.approx_max_k(score, k)
        cand_d = jnp.concatenate([best_d, -neg_d], axis=1)
        cand_i = jnp.concatenate([best_i, idx.astype(jnp.int32) + base], axis=1)
        neg2, sel = jax.lax.top_k(-cand_d, k)  # 2k-wide exact merge
        return (-neg2, jnp.take_along_axis(cand_i, sel, axis=1)), None

    init = (jnp.full((Q, k), _BIG), jnp.zeros((Q, k), jnp.int32))
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best_d, best_i), _ = jax.lax.scan(body, init, (t_chunks, m_chunks, bases))
    return KNNResult(best_i, best_d)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BruteForceKNN:
    """Functional analog of the reference KNN interface over a target cloud."""

    points: jax.Array  # [M, 3]
    mask: jax.Array  # [M]

    @staticmethod
    def build(cloud: PointCloud) -> "BruteForceKNN":
        return BruteForceKNN(points=cloud.points, mask=cloud.mask)

    def search(
        self,
        query_points: jax.Array,
        k: int,
        pose: Optional[jax.Array] = None,
        chunk: int = 8192,
    ) -> KNNResult:
        return brute_force_knn(self.points, self.mask, query_points, k, pose, chunk)

    def radius_search(
        self,
        query_points: jax.Array,
        radius: float,
        max_k: int,
        pose: Optional[jax.Array] = None,
    ) -> KNNResult:
        """Radius search with a ``max_k`` cap (knn/kdtree.hpp:574-719):
        neighbors beyond ``radius`` get index -1 / distance inf."""
        res = self.search(query_points, max_k, pose)
        within = res.distances <= radius * radius
        return KNNResult(
            jnp.where(within, res.indices, -1),
            jnp.where(within, res.distances, _BIG),
        )


# Target-count crossover for correspondence (k=1) search.  Not measured on
# the GPU yet (``scripts/measure_grid_crossover.py``), so auto-selection
# always picks brute force; GridKNN stays available as an explicit opt-in
# (pass a finite ``threshold``).
GRID_KNN_TARGET_THRESHOLD = 1 << 62


def build_target_knn(
    cloud: PointCloud,
    *,
    max_correspondence_distance: float,
    threshold: Optional[int] = None,
):
    """Auto-select the correspondence-search structure for a target cloud,
    the analog of the reference choosing KD-tree vs brute force
    (knn/kdtree.hpp:424-562 vs knn/bruteforce.hpp); see
    GRID_KNN_TARGET_THRESHOLD above.

    When a finite ``threshold`` forces the grid path for targets above it,
    the returned :class:`~sycl_points_tpu.ops.grid_knn.GridKNN` uses
    ``cell_size = max_correspondence_distance``: ICP discards
    correspondences beyond that distance, so grid results are EXACT for the
    registration (any in-gate neighbor lies within the 27-cell window).
    """
    thr = GRID_KNN_TARGET_THRESHOLD if threshold is None else threshold
    if cloud.capacity > thr:
        from sycl_points_tpu.ops.grid_knn import GridKNN

        return GridKNN.build_auto(cloud, cell_size=max_correspondence_distance)
    return BruteForceKNN.build(cloud)
