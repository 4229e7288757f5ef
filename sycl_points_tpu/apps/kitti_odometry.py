"""KITTI sequence odometry runner (the ROS-less analog of the reference's
rosbag-eval nodes, ``ros2/sycl_points_ros2/src/*_rosbag_eval_node.cpp``):
feeds Velodyne ``.bin`` scans through the LiDAR odometry pipeline, exports
the trajectory in TUM format (timestamp tx ty tz qx qy qz qw), and reports
per-stage timing.

Usage:
  python -m sycl_points_tpu.apps.kitti_odometry /path/to/sequence/velodyne \
      [--max-frames N] [--out traj.tum] [--config params.yaml]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

import jax.numpy as jnp

from sycl_points_tpu.pipeline.lidar_odometry import LidarOdometry, ResultType
from sycl_points_tpu.pipeline.params import (
    DownsamplingParams,
    IMUParams,
    LidarInertialOdometryParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    RandomDownsamplingParams,
    VoxelDownsamplingParams,
    ScanParams,
    load_params,
)
from sycl_points_tpu.points.conversion import read_kitti_bin
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu.utils import lie_np


def default_kitti_params() -> LidarOdometryParams:
    return LidarOdometryParams(
        scan=ScanParams(
            downsampling=DownsamplingParams(
                voxel=VoxelDownsamplingParams(enable=True, size=1.0),
                polar=PolarDownsamplingParams(enable=False),
                random=RandomDownsamplingParams(enable=True, num=5000),
            ),
        ),
    )


def write_tum(path: str, stamps, poses):
    with open(path, "w") as f:
        for t, T in zip(stamps, poses):
            q = lie_np.matrix_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def main(argv=None, frame_times: list | None = None):
    """Run the CLI; ``frame_times``, if given, receives the wall seconds of
    each frame's ``process`` call."""
    ap = argparse.ArgumentParser()
    ap.add_argument("velodyne_dir")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out", default="trajectory.tum")
    ap.add_argument("--config", default=None)
    ap.add_argument("--rate", type=float, default=10.0, help="scan rate [Hz]")
    ap.add_argument("--lio", action="store_true",
                    help="run the LiDAR-inertial pipeline (requires an IMU "
                         "stream; without one LIO degrades to a loose prior)")
    ap.add_argument("--pipelined", action="store_true",
                    help="deep-pipelined pipeline (device-resident state, "
                         "async deferred stats; poses resolve a few frames "
                         "behind and are flushed at the end)")
    args = ap.parse_args(argv)
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    files = sorted(glob.glob(os.path.join(args.velodyne_dir, "*.bin")))
    if args.max_frames:
        files = files[: args.max_frames]
    if not files:
        print(f"no .bin scans in {args.velodyne_dir}", file=sys.stderr)
        return 1

    if args.lio:
        from sycl_points_tpu.pipeline.lidar_inertial_odometry import LidarInertialOdometry

        params = (
            load_params(args.config, LidarInertialOdometryParams)
            if args.config
            else LidarInertialOdometryParams(
                scan=default_kitti_params().scan, imu=IMUParams(enable=True)
            )
        )
        if args.pipelined:
            from sycl_points_tpu.pipeline.pipelined_lio import (
                PipelinedLidarInertialOdometry,
            )

            lo = PipelinedLidarInertialOdometry(params)
        else:
            lo = LidarInertialOdometry(params)
    else:
        params = (
            load_params(args.config, LidarOdometryParams) if args.config else default_kitti_params()
        )
        if args.pipelined:
            from sycl_points_tpu.pipeline.pipelined_odometry import (
                PipelinedLidarOdometry,
            )

            lo = PipelinedLidarOdometry(params)
        else:
            lo = LidarOdometry(params)

    # fixed raw capacity tier for zero recompiles across frames
    first = read_kitti_bin(files[0])
    raw_cap = pad_capacity_for(int(len(first["points"]) * 1.3))

    stamps, poses = [], []
    t_start = time.perf_counter()
    for i, path in enumerate(files):
        scan = read_kitti_bin(path)
        cloud = PointCloud.from_numpy(
            scan["points"][:raw_cap], intensities=scan["intensities"][:raw_cap],
            capacity=raw_cap,
        )
        ts = i / args.rate
        t0 = time.perf_counter()
        result = lo.process(cloud, ts)
        if frame_times is not None:
            frame_times.append(time.perf_counter() - t0)
        if result not in (ResultType.success, ResultType.first_frame):
            print(f"frame {i}: {result.value} ({lo.error_message})", file=sys.stderr)
        if not args.pipelined:
            stamps.append(ts)
            poses.append(lo.get_odometry())
        if i % 10 == 0:
            elapsed = time.perf_counter() - t_start
            t_last = (
                np.round(poses[-1][:3, 3], 2) if poses
                else np.round(np.asarray(lo.get_odometry())[:3, 3], 2)
            )
            print(
                f"frame {i}/{len(files)}  t={t_last}  "
                f"({elapsed / max(i, 1) * 1e3:.0f} ms/frame)",
                file=sys.stderr,
            )

    if args.pipelined:
        lo.flush()
        first_pose = np.asarray(params.pose.initial_matrix(), np.float32)
        stamps = [0.0] + [t for _, t, _, _ in lo.pose_log]
        poses = [first_pose] + [T for _, _, T, _ in lo.pose_log]
    write_tum(args.out, stamps, poses)
    total = time.perf_counter() - t_start
    print(f"{len(files)} frames in {total:.1f}s ({total / len(files) * 1e3:.1f} ms/frame)")
    print(f"trajectory written to {args.out}")
    for name, us in sorted(getattr(lo, "processing_times", {}).items()):
        print(f"  {name}: {us * 1e3:.1f} ms (last frame)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
