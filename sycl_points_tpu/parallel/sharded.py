"""Multi-chip (ICI) scaling via jax.sharding: shard the point axis.

The reference has no distributed layer (SURVEY.md 2.12: one sycl::queue).
This extension scales the data-parallel axis the reference tiles
over work-items — the *point* axis — across a device mesh:

  * source points, masks and per-point attributes are sharded over the
    ``points`` mesh axis;
  * the target cloud / map is replicated (it is read-only per align);
  * the fused linearize reduction (a [6, 3N] @ [3N, 6] matmul) becomes a
    per-shard partial H/b + an XLA ``psum`` inserted automatically by GSPMD;
  * per-iteration KNN is embarrassingly parallel over query shards.

No NCCL/MPI port: collectives ride ICI through the compiler.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sycl_points_tpu.points.point_cloud import PointCloud


def make_mesh(n_devices: Optional[int] = None, axis: str = "points") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_cloud(cloud: PointCloud, mesh: Mesh, axis: str = "points") -> PointCloud:
    """Place a cloud with the leading (point) dimension sharded over the mesh.
    Capacity must be divisible by the mesh size."""
    sharding = NamedSharding(mesh, P(axis))

    def put(arr):
        if arr is None:
            return None
        return jax.device_put(arr, sharding)

    return PointCloud(
        points=put(cloud.points),
        mask=put(cloud.mask),
        covs=put(cloud.covs),
        normals=put(cloud.normals),
        rgb=put(cloud.rgb),
        intensities=put(cloud.intensities),
        timestamp_offsets=put(cloud.timestamp_offsets),
    )


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sharding) if a is not None else None, tree
    )


def sharded_align(mesh: Mesh, source: PointCloud, target: PointCloud, params,
                  initial_guess=None):
    """GICP alignment with the source sharded over the mesh point axis and the
    target replicated.  GSPMD partitions the per-point linearization and
    inserts the cross-chip psum for the 6x6/6 reductions."""
    from sycl_points_tpu.ops.knn import BruteForceKNN
    from sycl_points_tpu.registration.registration import align

    src = shard_cloud(source, mesh)
    tgt = replicate(target, mesh)
    T0 = jnp.eye(4, dtype=jnp.float32) if initial_guess is None else initial_guess

    @jax.jit
    def run(s, t, T):
        return align(s, t, BruteForceKNN.build(t), params, initial_guess=T)

    return run(src, tgt, replicate(T0, mesh))


def sharded_knn(mesh: Mesh, target: PointCloud, queries: jax.Array, k: int):
    """Brute-force KNN with queries sharded over the mesh (each chip searches
    its query shard against the replicated target)."""
    from sycl_points_tpu.ops.knn import brute_force_knn

    q = jax.device_put(queries, NamedSharding(mesh, P("points")))
    tgt = replicate(target, mesh)

    @jax.jit
    def run(tp, tm, qq):
        return brute_force_knn(tp, tm, qq, k)

    return run(tgt.points, tgt.mask, q)


def stack_clouds(clouds):
    """Stack same-capacity clouds into one batched PointCloud pytree with a
    leading batch axis (for :func:`align_pairs_batched`)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis=0), *clouds)


def align_pairs_batched(mesh: Mesh, sources: PointCloud, targets: PointCloud,
                        params, initial_guesses=None, axis: str = "points"):
    """Data-parallel batch registration: align B independent scan pairs with
    the batch axis sharded over the mesh — each chip processes its own pairs
    with zero cross-chip traffic (the serving-throughput layout, vs
    :func:`sharded_align` which splits ONE pair across chips for latency).

    ``sources``/``targets`` are batched clouds from :func:`stack_clouds`
    (leading dim B divisible by the mesh size).  Returns a batched
    RegistrationResult.  The vmapped while_loop runs each batch element until
    all converge (identical per-pair results; converged pairs idle).
    """
    from sycl_points_tpu.ops.knn import BruteForceKNN
    from sycl_points_tpu.registration.registration import align

    B = sources.points.shape[0]
    sharding = NamedSharding(mesh, P(axis))

    def put(a):
        return None if a is None else jax.device_put(a, sharding)

    srcs = jax.tree_util.tree_map(put, sources)
    tgts = jax.tree_util.tree_map(put, targets)
    if initial_guesses is None:
        initial_guesses = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))
    T0 = jax.device_put(initial_guesses, sharding)

    @jax.jit
    def run(s, t, T):
        def one(s1, t1, T1):
            knn = BruteForceKNN(points=t1.points, mask=t1.mask)
            return align(s1, t1, knn, params, initial_guess=T1)

        return jax.vmap(one)(s, t, T)

    return run(srcs, tgts, T0)
