"""Device prefix-sum / stream-compaction helpers.

Parity module for the reference's 3-phase work-group scan
(``algorithms/common/prefix_sum.hpp`` in fateshelled/sycl_points) and the
host-side ``FilterByFlags::calculate_indices`` old->new index map
(``common/filter_by_flags.hpp:11-99``).  On the device a scan is a
single fused ``jnp.cumsum``; these helpers package the common compaction
idioms built on it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inclusive_scan(x: jax.Array) -> jax.Array:
    return jnp.cumsum(x)


def exclusive_scan(x: jax.Array) -> jax.Array:
    c = jnp.cumsum(x)
    return c - x


def compaction_offsets(flags: jax.Array):
    """(offsets, count): for each kept element its output position; the
    compacted count (PrefixSum::compute semantics)."""
    f = flags.astype(jnp.int32)
    offsets = exclusive_scan(f)
    return offsets, jnp.sum(f)


def compaction_indices(flags: jax.Array) -> jax.Array:
    """Old->new index map with -1 for removed elements
    (FilterByFlags::calculate_indices)."""
    offsets, _ = compaction_offsets(flags)
    return jnp.where(flags, offsets, -1)


def scatter_compact(values: jax.Array, flags: jax.Array, out_size: int) -> jax.Array:
    """Scatter kept rows to the front of a fixed-size output (the device
    analog of the reference's host compaction loop)."""
    offsets, _ = compaction_offsets(flags)
    tgt = jnp.where(flags, offsets, out_size)
    out = jnp.zeros((out_size,) + values.shape[1:], values.dtype)
    return out.at[tgt].set(values, mode="drop")
