"""Fleet odometry serving bench: B independent odometry streams per chip.

Each fleet frame dispatches ONE vmapped preprocess+registration program and
ONE vmapped submap-update program for all B streams, with a single async
stats readback — so host orchestration, dispatch overhead and the device
sync amortize B ways.  Throughput is the serving metric: stream-frames per
second per card vs the single-stream pipelined replay
(``bench_odometry_replay.py --pipelined``).  Needs a GPU; prints the card's
name and power limit.

Each stream follows its own trajectory (rotated/offset figure-8 starts) in
the shared synthetic Velodyne world, so per-stream state independence is
exercised, not just batching.

Usage: python benchmarks/bench_fleet.py [--streams 8] [--frames 40] [--json out]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

import jax
import jax.numpy as jnp

from synthetic_velodyne import World, figure8_trajectory, scan_at

from sycl_points_tpu.parallel.fleet import FleetOdometry
from sycl_points_tpu.pipeline.lidar_odometry import ResultType
from sycl_points_tpu.pipeline.params import (
    DownsamplingParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    RandomDownsamplingParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for


def main():
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--rings", type=int, default=32)
    ap.add_argument("--az", type=int, default=1024)
    ap.add_argument("--map-capacity", type=int, default=1 << 16)
    ap.add_argument("--map-voxel", type=float, default=1.0)
    ap.add_argument("--speed", type=float, default=0.35)
    ap.add_argument("--lio", action="store_true",
                    help="FleetLIO: the 15-DOF inertial pipeline per stream, "
                         "with analytic figure-8 IMU (body-frame measurements "
                         "are invariant to each stream's z-rotated start, so "
                         "all streams share the generator)")
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    require_gpu()
    enable_persistent_cache()

    B = args.streams
    print(f"device: {jax.devices()[0].device_kind}; card: {card_line()}",
          file=sys.stderr, flush=True)

    world = World()
    base = figure8_trajectory(args.frames, speed=args.speed)
    # per-stream starts: rotate/offset the shared figure-8 (stream_rots is
    # the per-stream transform alone — NOT trajs[s][0], which also contains
    # the base figure-8's initial pi/4 yaw)
    trajs = []
    stream_rots = []
    for s in range(B):
        yaw = 2.0 * np.pi * s / B
        c, si = np.cos(yaw), np.sin(yaw)
        R = np.eye(4, dtype=np.float32)
        R[:3, :3] = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]], np.float32)
        R[0, 3] = 3.0 * (s % 4)
        trajs.append([(R @ T).astype(np.float32) for T in base])
        stream_rots.append(R[:3, :3].copy())

    raw_cap = pad_capacity_for(args.az * args.rings)
    scans = []  # [frame][stream] -> np pts
    for i in range(args.frames):
        per_stream = []
        for s in range(B):
            pts = scan_at(world, trajs[s][i], n_az=args.az, n_rings=args.rings,
                          seed=1000 * s + i,
                          cache_tag=f"fleet_{args.az}x{args.rings}_s{s}_{i}")
            per_stream.append(pts)
        scans.append(per_stream)
    print(f"{args.frames}x{B} scans generated", file=sys.stderr, flush=True)

    scan_params = ScanParams(
        downsampling=DownsamplingParams(
            voxel=VoxelDownsamplingParams(enable=True, size=1.0),
            polar=PolarDownsamplingParams(enable=False),
            random=RandomDownsamplingParams(enable=True, num=5000),
        ),
    )
    submap_params = SubmapParams(
        map_type="VOXEL_HASH_MAP", voxel_size=args.map_voxel,
        map_capacity=args.map_capacity, point_random_sampling_num=512,
    )
    init_poses = np.stack([t[0] for t in trajs])
    if args.lio:
        from sycl_points_tpu.imu.preintegration import IMUMeasurement
        from sycl_points_tpu.parallel.fleet import FleetLIO
        from sycl_points_tpu.pipeline.params import (
            IMUParams,
            IMUPreintegrationParams,
            LidarInertialOdometryParams,
        )
        from synthetic_velodyne import figure8_imu

        params = LidarInertialOdometryParams(
            scan=scan_params, submap=submap_params,
            imu=IMUParams(enable=True, preintegration=IMUPreintegrationParams(
                gyro_noise_density=1e-3, accel_noise_density=1e-2,
                gyro_bias_rw_density=1e-5, accel_bias_rw_density=1e-4,
            )),
        )
        fleet = FleetLIO(params, n_streams=B, initial_poses=init_poses)

        def feed_imu(t_from, t_to):
            n = max(int(round((t_to - t_from) * args.imu_hz)), 1)
            for k in range(n + 1):
                t = t_from + (t_to - t_from) * k / n
                g, a = figure8_imu(t, speed=args.speed)
                for s in range(B):
                    fleet.add_imu_measurement(s, IMUMeasurement(
                        timestamp=t, gyro=g.astype(np.float32),
                        accel=a.astype(np.float32),
                    ))
    else:
        params = LidarOdometryParams(scan=scan_params, submap=submap_params)
        fleet = FleetOdometry(params, n_streams=B, initial_poses=init_poses)
        feed_imu = None

    def stack_frame(i):
        clouds = [PointCloud.from_numpy(p, capacity=raw_cap) for p in scans[i]]
        return PointCloud(
            points=jnp.stack([c.points for c in clouds]),
            mask=jnp.stack([c.mask for c in clouds]),
        )

    frame_times = []
    for i in range(args.frames):
        stacked = stack_frame(i)  # untimed h2d
        if feed_imu is not None:
            feed_imu(max(0.1 * i - 0.1, -0.05), 0.1 * i)
        t0 = time.perf_counter()
        fleet.process_batch(stacked, timestamps=0.1 * i)
        dt = time.perf_counter() - t0
        if i == 0 and feed_imu is not None:
            # seed the known initial velocity per stream (the figure-8
            # starts in motion; see bench_lio_replay.py)
            s_dot = args.speed / (0.1 * 18.0)
            v0 = np.array([18.0 * s_dot, 18.0 * s_dot, 0.0], np.float32)
            # v0 is already the WORLD-frame velocity of the base figure-8
            # (bench_lio_replay seeds it unrotated); only the per-stream
            # transform applies
            v0s = np.stack([R @ v0 for R in stream_rots])
            fleet.x = fleet.x._replace(velocity=jnp.asarray(v0s))
            fleet.velocity_np = v0s
        if i >= args.warmup:
            frame_times.append(dt)
        if i in (0, 1, args.warmup):
            print(f"frame {i}: {dt*1e3:.0f} ms", file=sys.stderr, flush=True)
    fleet.flush()

    # per-stream ATE + per-result-type accounting (every non-success frame
    # is itemized: an artifact that can't explain frames_expected-frames_ok
    # is not telemetry)
    from collections import Counter

    ates = []
    ok = 0
    result_histogram = Counter()
    not_ok_frames = []
    for s in range(B):
        est = np.stack(
            [trajs[s][0][:3, 3]]
            + [T[:3, 3] for _, _, T, _ in fleet.pose_log[s]]
        )
        gt = np.stack([T[:3, 3] for T in trajs[s]])[: len(est)]
        err = np.sqrt(np.sum((est - gt) ** 2, axis=1))
        ates.append(float(np.sqrt(np.mean(err ** 2))))
        for fi, rt in fleet.deferred_results[s]:
            # .name: the LO and LIO pipelines use distinct ResultType enums
            result_histogram[rt.name] += 1
            if rt.name == "success":
                ok += 1
            else:
                not_ok_frames.append(
                    {"stream": s, "frame": fi, "result": rt.name}
                )

    ms_frame = float(np.mean(frame_times)) * 1e3
    out = {
        "config": "fleet-lio" if args.lio else "fleet-odometry",
        "streams": B,
        "frames": args.frames,
        "raw_points_per_scan": int(raw_cap),
        "ms_per_fleet_frame": round(ms_frame, 2),
        "ms_per_stream_frame": round(ms_frame / B, 3),
        "stream_frames_per_sec": round(1e3 / ms_frame * B, 1),
        "frames_ok": ok,
        "frames_expected": B * (args.frames - 1),
        "result_histogram": dict(sorted(result_histogram.items())),
        "not_ok_frames": not_ok_frames[:100],
        # >0 would mean frames that produced NO deferred result at all
        "frames_unaccounted": B * (args.frames - 1)
        - sum(result_histogram.values()),
        "ate_translation_m_mean": round(float(np.mean(ates)), 3),
        "ate_translation_m_max": round(float(np.max(ates)), 3),
        "map_capacity_final": fleet.map_capacity,
        "map_dropped": int(np.asarray(fleet.map_state.dropped).sum()),
        "budget_lost": int(fleet.budget_lost.sum()),
        "growth_events": fleet.growth_events,
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
