"""Multi-sequence fleet odometry runner: N LiDAR sequences through ONE
:class:`FleetOdometry` instance — the serving deployment of the vmapped
fleet layer (one program pair + one async readback per frame for ALL
sequences; see ``parallel/fleet.py`` and design rule 13).

Each positional argument is a sequence directory of KITTI Velodyne ``.bin``
or ``.ply`` scans.  Sequences of different lengths are padded with empty
frames: a finished stream's pose simply holds (the small-frame path) while
the others continue.  Per-stream trajectories are exported in TUM format.

Usage:
  python -m sycl_points_tpu.apps.fleet_odometry SEQ_DIR [SEQ_DIR ...] \
      [--max-frames N] [--out-prefix fleet] [--config params.yaml]

Reference analog: N separate rosbag-eval processes
(``ros2/sycl_points_ros2/src/*_rosbag_eval_node.cpp``), one per sequence —
here one chip serves them all.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

import jax.numpy as jnp

from sycl_points_tpu.apps.kitti_odometry import default_kitti_params, write_tum
from sycl_points_tpu.parallel.fleet import FleetOdometry
from sycl_points_tpu.pipeline.params import LidarOdometryParams, load_params
from sycl_points_tpu.points import io
from sycl_points_tpu.points.conversion import read_kitti_bin
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for


def _load_scan(path: str) -> np.ndarray:
    if path.endswith(".bin"):
        return read_kitti_bin(path)["points"]
    return io.read_file(path)["points"]


def run_fleet(
    files_per_stream,
    params: LidarOdometryParams,
    out_prefix: str,
    rate: float = 10.0,
    log=sys.stderr,
) -> list:
    """Run the fleet over per-stream scan file lists; write
    ``{out_prefix}_{s}.tum`` per stream and return the output paths."""
    B = len(files_per_stream)
    n_frames = max(len(f) for f in files_per_stream)
    first_lens = [len(_load_scan(f[0])) for f in files_per_stream]
    raw_cap = pad_capacity_for(int(max(first_lens) * 1.3))

    fleet = FleetOdometry(params, n_streams=B)
    truncated = np.zeros(B, np.int64)  # no silent caps: count tail losses
    t_start = time.perf_counter()
    for i in range(n_frames):
        pts_b, mask_b = [], []
        for s, files in enumerate(files_per_stream):
            if i < len(files):
                full = _load_scan(files[i])
                truncated[s] += max(0, len(full) - raw_cap)
                pts = full[:raw_cap]
                pad = raw_cap - len(pts)
                pts_b.append(np.pad(pts, ((0, pad), (0, 0))))
                mask_b.append(np.concatenate(
                    [np.ones(len(pts), bool), np.zeros(pad, bool)]
                ))
            else:  # finished stream: empty frame -> pose holds
                pts_b.append(np.zeros((raw_cap, 3), np.float32))
                mask_b.append(np.zeros(raw_cap, bool))
        stacked = PointCloud(
            points=jnp.asarray(np.stack(pts_b), jnp.float32),
            mask=jnp.asarray(np.stack(mask_b)),
        )
        fleet.process_batch(stacked, timestamps=i / rate)
        if i % 10 == 0:
            elapsed = time.perf_counter() - t_start
            print(
                f"frame {i}/{n_frames}  ({elapsed / max(i, 1) * 1e3:.0f} "
                f"ms/fleet-frame, {B} streams)",
                file=log,
            )
    fleet.flush()
    total = time.perf_counter() - t_start
    print(
        f"{n_frames} fleet frames x {B} streams in {total:.1f}s "
        f"({total / n_frames * 1e3:.1f} ms/fleet-frame, "
        f"{total / n_frames / B * 1e3:.2f} ms/stream-frame)",
        file=log,
    )

    if truncated.any():
        print(
            "WARNING: scans exceeded the capacity tier sized from frame 0 "
            f"(raw_cap={raw_cap}); truncated points per stream: "
            f"{truncated.tolist()}",
            file=log,
        )

    outs = []
    for s, files in enumerate(files_per_stream):
        first_pose = fleet._initial_poses[s]
        stamps = [0.0]
        poses = [first_pose]
        for idx, ts, T, _rt in fleet.pose_log[s]:
            if idx < len(files):  # drop the hold-pose padding frames
                stamps.append(ts)
                poses.append(T)
        out = f"{out_prefix}_{s}.tum"
        write_tum(out, stamps, poses)
        outs.append(out)
        print(f"stream {s}: {len(poses)} poses -> {out}", file=log)
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dirs", nargs="+")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-prefix", default="fleet")
    ap.add_argument("--config", default=None)
    ap.add_argument("--rate", type=float, default=10.0)
    args = ap.parse_args(argv)
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    files_per_stream = []
    for d in args.seq_dirs:
        files = sorted(
            glob.glob(os.path.join(d, "*.bin")) + glob.glob(os.path.join(d, "*.ply"))
        )
        if args.max_frames:
            files = files[: args.max_frames]
        if not files:
            print(f"no scans in {d}", file=sys.stderr)
            return 1
        files_per_stream.append(files)

    params = (
        load_params(args.config, LidarOdometryParams)
        if args.config
        else default_kitti_params()
    )
    run_fleet(files_per_stream, params, args.out_prefix, rate=args.rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
