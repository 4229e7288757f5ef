"""Warm vs cold GridKNN build cost on the GPU.

A cold build is dominated by the one-time XLA compiles of the jitted build
at each (capacity, per-cell-budget) signature that build_auto's zero-loss
retry ladder walks.  This probe separates the two: the first build pays the
compiles; repeat builds of same-shaped clouds (the steady state of any real
pipeline, and of repeat runs under JAX_COMPILATION_CACHE_DIR) reuse them.

Writes chiprun_out/GRID_WARM_BUILD.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from sycl_points_tpu.ops.grid_knn import GridKNN
from sycl_points_tpu.points.point_cloud import PointCloud

CELL = 2.0  # max_correspondence_distance-sized cells (exact-in-gate)


def main():
    from sycl_points_tpu.utils.device import card_line, require_gpu

    require_gpu()
    print(f"device: {jax.devices()[0].device_kind}; card: {card_line()}",
          file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for m in (1 << 17, 1 << 19):
        pts = rng.uniform(-60, 60, size=(m, 3)).astype(np.float32)
        cloud = PointCloud.from_numpy(pts)

        t0 = time.perf_counter()
        g = GridKNN.build_auto(cloud, cell_size=CELL)
        jax.block_until_ready(g.cell_start)
        cold_ms = (time.perf_counter() - t0) * 1e3

        warm = []
        for s in range(5):
            pts2 = rng.uniform(-60, 60, size=(m, 3)).astype(np.float32)
            cloud2 = PointCloud.from_numpy(pts2)
            t0 = time.perf_counter()
            g2 = GridKNN.build_auto(cloud2, cell_size=CELL)
            jax.block_until_ready(g2.cell_start)
            warm.append((time.perf_counter() - t0) * 1e3)
        rows.append({
            "M": m,
            "build_ms_cold_first": round(cold_ms, 1),
            "build_ms_warm_median": round(float(np.median(warm)), 2),
            "per_cell_budget": int(g.max_per_cell),
            "overflow": int(g.overflow),
            "cells_dropped": int(g.cells_dropped),
        })
        print(rows[-1], file=sys.stderr, flush=True)

    out = {"cell_size": CELL, "rows": rows}
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "GRID_WARM_BUILD.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
