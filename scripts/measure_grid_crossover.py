"""Measure the brute-force vs GridKNN crossover for correspondence search.

Runs nn1 (k=1) search over M in {16k..512k} targets with Q=8192 queries on
the GPU (median wall time around ``block_until_ready``), plus GridKNN.build
cost.  Writes chiprun_out/GRID_CROSSOVER.json; the winner sets
``ops.knn.GRID_KNN_TARGET_THRESHOLD``.

Usage: python scripts/measure_grid_crossover.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from sycl_points_tpu.ops.grid_knn import GridKNN
from sycl_points_tpu.ops.knn import BruteForceKNN
from sycl_points_tpu.points.point_cloud import PointCloud

Q = 8192
CELL = 2.0  # = default max_correspondence_distance


def make_cloud(M, seed=0):
    """Velodyne-like density: points on a disc of radius growing with M so
    per-cell occupancy stays realistic (~scan density, not uniform cube)."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(4.0, 50.0**2, size=M)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, size=M).astype(np.float32)
    z = rng.uniform(-2.0, 8.0, size=M).astype(np.float32)
    pts = np.stack([r * np.cos(th), r * np.sin(th), z], 1)
    return PointCloud.from_numpy(pts, capacity=M)


def time_searcher(knn, queries, iters=10):
    """Median wall ms of a jitted ``knn.search(q, 1)`` until ready.  The
    structure is passed as a jit ARGUMENT: closure capture would embed its
    arrays in the program as constants."""
    f = jax.jit(lambda knn, q: knn.search(q, 1))
    jax.block_until_ready(f(knn, queries))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(knn, queries))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    from sycl_points_tpu.utils.device import card_line, require_gpu

    require_gpu()
    rows = []
    rng = np.random.default_rng(99)
    for M in (16384, 32768, 65536, 131072, 262144, 524288):
        cloud = make_cloud(M)
        sel = rng.permutation(M)[:Q]
        queries = jnp.asarray(
            np.asarray(cloud.points)[sel] + rng.normal(scale=0.05, size=(Q, 3)).astype(np.float32)
        )

        bf = BruteForceKNN.build(cloud)
        t_build0 = time.perf_counter()
        grid = GridKNN.build_auto(cloud, cell_size=CELL)
        build_ms = (time.perf_counter() - t_build0) * 1e3

        ms_bf = time_searcher(bf, queries)
        ms_grid = time_searcher(grid, queries)

        # correctness cross-check on in-gate queries
        r_b = bf.search(queries, 1)
        r_g = grid.search(queries, 1)
        gate = np.asarray(r_b.distances[:, 0]) <= CELL**2
        agree = float(
            np.mean(
                np.asarray(r_g.indices[:, 0])[gate] == np.asarray(r_b.indices[:, 0])[gate]
            )
        )
        row = dict(
            M=M, Q=Q, brute_ms=round(ms_bf, 3), grid_ms=round(ms_grid, 3),
            grid_build_ms_host=round(build_ms, 1),
            grid_max_per_cell=grid.max_per_cell,
            in_gate_agreement=agree,
        )
        rows.append(row)
        print(row, flush=True)

    out = dict(
        device=jax.devices()[0].device_kind,
        card=card_line(),
        cell_size=CELL,
        rows=rows,
    )
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "GRID_CROSSOVER.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
