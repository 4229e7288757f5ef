"""Fused two-cloud preprocessing: ONE sort/segment-reduce pass for a scan
pair, plus vmapped feature estimation.

Registration always preprocesses two clouds (source + target — the
reference harness does this sequentially per cloud,
cpp/examples/example_registration.cpp:54-161).  Both clouds share one packed
cell sort (a cloud-id bit rides above the 30-bit cell key) and one fused
``[2N, 4]`` segment reduction; k-NN + covariance + normal estimation then
runs vmapped over the stacked pair.  Semantically identical to two
:func:`~sycl_points_tpu.ops.voxel.voxel_downsample` calls followed by
per-cloud feature estimation.

Kept as a tested alternative; the default pipelines use the sequential
path.  Which is faster on the GPU is not measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu.ops.knn import approx_knn
from sycl_points_tpu.ops.voxel import MAX_CELLS_PER_AXIS, voxel_coords
from sycl_points_tpu.points.point_cloud import PointCloud

_SENT = 2**31 - 1


def voxel_downsample_pair(
    a: PointCloud, b: PointCloud, voxel_size: float, out_capacity: int
):
    """Voxel-grid downsample two point-only clouds with ONE device sort.

    Returns ``(a_down, b_down)``, each with capacity ``out_capacity``.
    Equivalent to two ``voxel_downsample(..., out_capacity)`` calls (centroid
    aggregation; clouds must carry only points — attribute channels use the
    per-cloud path).
    """
    ca, oka = voxel_coords(a.points, a.mask, voxel_size)
    cb, okb = voxel_coords(b.points, b.mask, voxel_size)
    coords = jnp.concatenate([ca, cb], axis=0)
    ok = jnp.concatenate([oka, okb], axis=0)
    cloud_id = jnp.concatenate(
        [jnp.zeros(a.capacity, jnp.int32), jnp.ones(b.capacity, jnp.int32)]
    )
    pts = jnp.concatenate([a.points, b.points], axis=0)

    # Per-cloud min re-base (the packed key budget is per frame).
    big = jnp.int32(2**30)
    masked = jnp.where(ok[:, None], coords, big)
    is_a = cloud_id == 0
    min_a = jnp.min(jnp.where(is_a[:, None], masked, big), axis=0)
    min_b = jnp.min(jnp.where(is_a[:, None], big, masked), axis=0)
    rel = coords - jnp.where(is_a[:, None], min_a[None, :], min_b[None, :])
    in_bound = ok & jnp.all((rel >= 0) & (rel < MAX_CELLS_PER_AXIS), axis=-1)
    key = (rel[:, 0] * MAX_CELLS_PER_AXIS + rel[:, 1]) * MAX_CELLS_PER_AXIS + rel[:, 2]
    key = key + cloud_id * jnp.int32(2**30)  # cloud id above the cell bits
    key = jnp.where(in_bound, key, jnp.int32(_SENT))

    key_s, x, y, z = jax.lax.sort(
        (key, pts[:, 0], pts[:, 1], pts[:, 2]), num_keys=1
    )
    ok_s = key_s != jnp.int32(_SENT)
    new_seg = (key_s != jnp.roll(key_s, 1)).at[0].set(True)
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    w = ok_s.astype(jnp.float32)

    # Route cloud-b voxels to the second half of the output table.
    row_is_a = ok_s & (key_s < jnp.int32(2**30))
    n_a = jnp.max(jnp.where(row_is_a, seg_id, -1)) + 1
    out_id = jnp.where(row_is_a, seg_id, seg_id - n_a + out_capacity)
    out_id = jnp.where(ok_s, out_id, 2 * out_capacity)  # dropped

    moments = jax.ops.segment_sum(
        jnp.stack([x * w, y * w, z * w, w], axis=1),
        out_id,
        num_segments=2 * out_capacity + 1,
        indices_are_sorted=True,
    )[: 2 * out_capacity]
    counts = moments[:, 3]
    centroid = moments[:, :3] / jnp.maximum(counts, 1.0)[:, None]
    mask = counts >= 1.0

    mk = lambda s: PointCloud(points=centroid[s], mask=mask[s])
    return mk(slice(0, out_capacity)), mk(slice(out_capacity, 2 * out_capacity))


def features_pair(a: PointCloud, b: PointCloud, k: int = 10):
    """Covariances + normals for two same-capacity clouds, vmapped over the
    stacked pair (approximate k-NN neighborhoods; see
    :func:`~sycl_points_tpu.ops.knn.approx_knn`)."""
    pts = jnp.stack([a.points, b.points])
    msk = jnp.stack([a.mask, b.mask])

    def one(p, m):
        knn = approx_knn(p, m, p, k)
        covs = estimate_covariances(p, knn)
        return covs, extract_normals(p, covs)

    covs, normals = jax.vmap(one)(pts, msk)
    return (
        a.replace(covs=covs[0], normals=normals[0]),
        b.replace(covs=covs[1], normals=normals[1]),
    )


def preprocess_pair(
    a: PointCloud,
    b: PointCloud,
    voxel_size: float,
    out_capacity: int,
    k: int = 10,
):
    """Full fused pair preprocess: shared voxel downsample + vmapped
    features.  Clouds must be point-only (the registration fast path)."""
    ad, bd = voxel_downsample_pair(a, b, voxel_size, out_capacity)
    return features_pair(ad, bd, k)
