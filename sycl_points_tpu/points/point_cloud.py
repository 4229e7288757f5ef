"""PointCloud: a pytree struct-of-arrays container with static (padded) shapes.

Re-design of the reference containers ``PointCloudCPU`` /
``PointCloudShared`` (``points/point_cloud.hpp:12-476`` in
fateshelled/sycl_points).  Instead of resizable USM vectors, a cloud is a
frozen dataclass of fixed-capacity HBM arrays plus a validity ``mask`` —
XLA requires static shapes, so "removing" points flips mask bits and
compaction happens only at host boundaries (:func:`compact`) or via
gather-based :func:`compact_device`.

Attribute layout (reference types at ``points/types.hpp:11-51``):
  * ``points``            ``[N, 3] float32``  (reference: Vector4f with w=1)
  * ``mask``              ``[N]    bool``     (True = valid point)
  * ``covs``              ``[N, 3, 3]``       (reference: Matrix4f, 3x3 used)
  * ``normals``           ``[N, 3]``          (reference: Vector4f, w=0)
  * ``rgb``               ``[N, 4]``          in [0, 1]
  * ``intensities``       ``[N]``
  * ``timestamp_offsets`` ``[N]``  milliseconds from scan start
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_capacity_for(n: int, lane: int = 256) -> int:
    """Bucketed padded capacity: next power-of-two-ish tier aligned to ``lane``.

    Tier padding keeps the number of distinct compiled shapes small
    (re-compilation avoidance; analog of the reference MAX_K tier dispatch,
    ``knn/kdtree.hpp:203-224``).
    """
    if n <= lane:
        return lane
    p = 1 << (int(n - 1)).bit_length()  # next power of two
    # quarter tiers between powers of two (1.25/1.5/1.75x the lower power):
    # raw-capacity passes (sort, segment reduce) are linear in the padded
    # size, so cutting padding waste is a direct preprocess win; four tiers
    # per octave still keeps the compiled-shape count small.
    for frac in (5, 6, 7):
        tier = (p // 2) + (p // 8) * (frac - 4)
        if n <= tier:
            return round_up(tier, lane)
    return round_up(p, lane)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    points: jax.Array
    mask: jax.Array
    covs: Optional[jax.Array] = None
    normals: Optional[jax.Array] = None
    rgb: Optional[jax.Array] = None
    intensities: Optional[jax.Array] = None
    timestamp_offsets: Optional[jax.Array] = None

    # --- shape/presence queries (host-side, static) ---------------------------
    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def has_cov(self) -> bool:
        return self.covs is not None

    def has_normal(self) -> bool:
        return self.normals is not None

    def has_rgb(self) -> bool:
        return self.rgb is not None

    def has_intensity(self) -> bool:
        return self.intensities is not None

    def has_timestamps(self) -> bool:
        return self.timestamp_offsets is not None

    # --- traced queries -------------------------------------------------------
    def count(self) -> jax.Array:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def replace(self, **kwargs) -> "PointCloud":
        return dataclasses.replace(self, **kwargs)

    # --- constructors ---------------------------------------------------------
    @staticmethod
    def from_numpy(
        points: np.ndarray,
        covs: Optional[np.ndarray] = None,
        normals: Optional[np.ndarray] = None,
        rgb: Optional[np.ndarray] = None,
        intensities: Optional[np.ndarray] = None,
        timestamp_offsets: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
    ) -> "PointCloud":
        """Build a padded device cloud from host arrays (the H2D boundary;
        analog of the ``PointCloudShared(queue, cpu)`` constructor,
        ``points/point_cloud.hpp:110-198``)."""
        n = int(points.shape[0])
        cap = capacity if capacity is not None else pad_capacity_for(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < number of points {n}")

        def pad(arr, shape_tail, dtype=np.float32):
            out = np.zeros((cap,) + shape_tail, dtype=dtype)
            if arr is not None:
                out[:n] = arr.reshape((n,) + shape_tail).astype(dtype)
            return jnp.asarray(out)

        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return PointCloud(
            points=pad(points[:, :3], (3,)),
            mask=jnp.asarray(mask),
            covs=None if covs is None else pad(covs[..., :3, :3], (3, 3)),
            normals=None if normals is None else pad(normals[:, :3], (3,)),
            rgb=None if rgb is None else pad(rgb[:, :4], (4,)),
            intensities=None if intensities is None else pad(intensities, ()),
            timestamp_offsets=None
            if timestamp_offsets is None
            else pad(timestamp_offsets, ()),
        )

    # --- host-side compaction (D2H boundary) ----------------------------------
    def to_numpy(self, compacted: bool = True) -> dict:
        """Copy to host as numpy dict; drops padding when ``compacted``."""
        mask = np.asarray(self.mask)
        sel = mask if compacted else np.ones_like(mask)
        out = {"points": np.asarray(self.points)[sel]}
        for name in ("covs", "normals", "rgb", "intensities", "timestamp_offsets"):
            arr = getattr(self, name)
            if arr is not None:
                out[name] = np.asarray(arr)[sel]
        return out


def compact_device(cloud: PointCloud, out_capacity: Optional[int] = None) -> PointCloud:
    """Stream-compact valid points to the front (gather; jittable).

    Device replacement for the host-side ``FilterByFlags`` compaction
    (``common/filter_by_flags.hpp:11-99``): a stable argsort on the inverted
    mask moves valid points first while preserving order; the result keeps a
    static capacity with a fresh mask.
    """
    cap = cloud.capacity
    out_cap = out_capacity or cap
    m = cloud.mask.astype(jnp.int32)
    csum = jnp.cumsum(m)
    n_valid = jnp.minimum(csum[-1], out_cap)
    new_mask = jnp.arange(out_cap) < n_valid
    # Scatter valid rows to their exclusive-prefix-sum position: O(n), no sort
    # (the reference's host compaction loop, done with one cumsum + scatter).
    tgt = jnp.where(cloud.mask, csum - m, out_cap)

    def take(arr):
        if arr is None:
            return None
        out = jnp.zeros((out_cap,) + arr.shape[1:], arr.dtype)
        return out.at[tgt].set(arr, mode="drop")

    return PointCloud(
        points=take(cloud.points),
        mask=new_mask,
        covs=take(cloud.covs),
        normals=take(cloud.normals),
        rgb=take(cloud.rgb),
        intensities=take(cloud.intensities),
        timestamp_offsets=take(cloud.timestamp_offsets),
    )


def filter_by_mask(cloud: PointCloud, keep: jax.Array) -> PointCloud:
    """Mask-out points where ``keep`` is False (jittable, no data movement)."""
    return cloud.replace(mask=cloud.mask & keep)


def merge_with_timestamps(
    a: PointCloud,
    b: PointCloud,
    a_start_ms: jax.Array | float = 0.0,
    b_start_ms: jax.Array | float = 0.0,
):
    """:func:`merge` with the reference's timestamp-base reconciliation
    (``PointCloudShared::merge_timestamp_offsets`` /
    ``shift_timestamp_base``, points/point_cloud.hpp:393-475): the merged
    cloud's start time is ``min(a_start, b_start)`` and each side's offsets
    are shifted by its base delta; if either side lacks timestamps the merged
    cloud has none (the reference invalidates them for consistency).

    Returns ``(merged_cloud, start_time_ms)``.
    """
    a_has = a.timestamp_offsets is not None
    b_has = b.timestamp_offsets is not None
    if not (a_has and b_has):
        m = merge(a, b)
        if m.timestamp_offsets is not None:
            m = m.replace(timestamp_offsets=None)
        start = a_start_ms if a_has else (b_start_ms if b_has else 0.0)
        return m, start

    a_start = jnp.asarray(a_start_ms, jnp.float32)
    b_start = jnp.asarray(b_start_ms, jnp.float32)
    new_start = jnp.minimum(a_start, b_start)
    a2 = a.replace(timestamp_offsets=a.timestamp_offsets + (a_start - new_start))
    b2 = b.replace(timestamp_offsets=b.timestamp_offsets + (b_start - new_start))
    return merge(a2, b2), new_start


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (static capacities add; analog of
    ``PointCloudShared::extend``, ``points/point_cloud.hpp:319-372``).

    Timestamp offsets concatenate as-is; when the two clouds have different
    start times use :func:`merge_with_timestamps` for the reference's
    base-shift semantics."""
    def cat(x, y, like_a, like_b):
        if x is None and y is None:
            return None
        if x is None:
            x = jnp.zeros((a.capacity,) + y.shape[1:], y.dtype)
        if y is None:
            y = jnp.zeros((b.capacity,) + x.shape[1:], x.dtype)
        return jnp.concatenate([x, y], axis=0)

    return PointCloud(
        points=jnp.concatenate([a.points, b.points], axis=0),
        mask=jnp.concatenate([a.mask, b.mask], axis=0),
        covs=cat(a.covs, b.covs, a, b),
        normals=cat(a.normals, b.normals, a, b),
        rgb=cat(a.rgb, b.rgb, a, b),
        intensities=cat(a.intensities, b.intensities, a, b),
        timestamp_offsets=cat(a.timestamp_offsets, b.timestamp_offsets, a, b),
    )
