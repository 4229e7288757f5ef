"""Brute-force vs CoarseKNN nn1 beyond M = 524k targets.

Compares brute force with the coarse-to-fine candidate tier
(ops/coarse_knn.py): one [Q, C] cell-summary ranking + a bounded candidate
refine, with the per-query exactness certificate reported alongside the
timing.  Both paths are timed identically on the GPU — warm jitted calls,
block_until_ready, median of 5.  Writes chiprun_out/COARSE_CROSSOVER.json.
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from sycl_points_tpu.ops.coarse_knn import CoarseKNN
from sycl_points_tpu.ops.knn import brute_force_knn
from sycl_points_tpu.points.point_cloud import PointCloud

Q = 8192
SPAN = 120.0
COARSE_CELL = 4.0     # ~22k occupied cells on the planar test world
CELLS_CAP = 1 << 15   # ranking matmul width: [chunk, 32768]
PER_CELL = 256        # >= max density at M = 4M over ~22k cells


def _timed(fn, *args, n=5):
    jax.block_until_ready(fn(*args))  # warm/compile
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="524288,1048576,2097152,4194304",
                    help="comma-separated target counts M")
    ap.add_argument("--queries", type=int, default=Q)
    args = ap.parse_args()
    from sycl_points_tpu.utils.device import require_gpu

    require_gpu()
    q_n = args.queries

    print(f"device: {jax.devices()[0]}", file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    qpts = jnp.asarray(rng.uniform(-SPAN, SPAN, size=(q_n, 3)).astype(np.float32))

    rows = []
    for m in (int(s) for s in args.sizes.split(",")):
        pts = rng.uniform(-SPAN, SPAN, size=(m, 3)).astype(np.float32)
        pts[:, 2] *= 0.1
        cloud = PointCloud.from_numpy(pts)

        bf = jax.jit(partial(brute_force_knn, k=1))
        bf_ms = _timed(bf, cloud.points, cloud.mask, qpts)

        build = jax.jit(partial(CoarseKNN.build, coarse_cell=COARSE_CELL,
                                cells_capacity=CELLS_CAP,
                                max_per_cell=PER_CELL))
        ck = jax.block_until_ready(build(cloud))
        build_ms = _timed(build, cloud)

        search = jax.jit(partial(CoarseKNN.search, k=1, top_cells=8))
        res, cert = search(ck, qpts)
        coarse_ms = _timed(search, ck, qpts)
        certified = float(np.asarray(cert).mean())

        rows.append({
            "M": m,
            "brute_nn1_ms": round(bf_ms, 2),
            "coarse_nn1_ms": round(coarse_ms, 2),
            "coarse_build_ms": round(build_ms, 2),
            "certified_fraction": round(certified, 4),
            "overflow": int(ck.overflow),
            "cells_lost": int(ck.cells_lost),
            "speedup": round(bf_ms / coarse_ms, 2),
        })
        print(rows[-1], file=sys.stderr, flush=True)

    out = {"Q": q_n, "coarse_cell": COARSE_CELL, "top_cells": 8,
           "max_per_cell": PER_CELL, "cells_capacity": CELLS_CAP,
           "rows": rows}
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "COARSE_CROSSOVER.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
