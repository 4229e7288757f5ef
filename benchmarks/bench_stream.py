"""End-to-end LIVE transport benchmark: synthetic Velodyne frames streamed
through the socket server (apps/stream_odometry.py) into the pipelined
odometry backend, poses streamed back — the serving-rate measurement of the
whole ROS-less live node (the reference's live path is
ros2/sycl_points_ros2/src/lidar_odometry_base_node.cpp; rosbag replay there
is host-loop bound, here the transport + QoS + pipelined dispatch all ride
one machine and one chip).

Measures, over N frames at an offered rate (--hz, 0 = as fast as poses
come back):
  * sustained serving throughput (frames/s end to end through the socket),
  * per-frame end-to-end latency (scan bytes written -> pose bytes read),
  * QoS drops + truncations (must be 0 at the sustainable rate),
  * trajectory ATE vs ground truth (the transport must not change results).

Needs a GPU; prints the card's name and power limit.  ``--json PATH``
also writes the result there.
"""

import argparse
import json
import os
import sys
import threading
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from synthetic_velodyne import World, figure8_trajectory, scan_at

from sycl_points_tpu.apps import stream_protocol as sp
from sycl_points_tpu.apps.stream_odometry import (
    OdometryStreamClient,
    OdometryStreamServer,
    StreamServerConfig,
)
from sycl_points_tpu.pipeline.params import (
    DownsamplingParams,
    LidarOdometryParams,
    PolarDownsamplingParams,
    PoseParams,
    RandomDownsamplingParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu.points.point_cloud import pad_capacity_for


def main():
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--speed", type=float, default=0.35)
    ap.add_argument("--hz", type=float, default=0.0,
                    help="offered frame rate; 0 = closed loop (send next "
                         "scan as soon as the previous pose arrives)")
    ap.add_argument("--pipeline", default="lo_pipelined",
                    choices=["lo", "lo_pipelined"])
    ap.add_argument("--az", type=int, default=2048)
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    require_gpu()
    enable_persistent_cache()
    print(f"device: {jax.devices()[0].device_kind}; card: {card_line()}",
          file=sys.stderr, flush=True)

    world = World()
    poses = figure8_trajectory(args.frames, speed=args.speed)
    sp_tag = "" if args.speed == 0.35 else f"_v{args.speed:g}"
    scans = [
        scan_at(world, T, n_az=args.az, n_rings=args.rings, seed=i,
                cache_tag=f"replay_{args.az}x{args.rings}{sp_tag}_{i}")
        for i, T in enumerate(poses)
    ]
    print(f"{len(scans)} scans generated", file=sys.stderr, flush=True)

    params = LidarOdometryParams(
        scan=ScanParams(
            downsampling=DownsamplingParams(
                voxel=VoxelDownsamplingParams(enable=True, size=1.0),
                polar=PolarDownsamplingParams(enable=False),
                random=RandomDownsamplingParams(enable=True, num=5000),
            ),
        ),
        # same map config as bench_odometry_replay so the transport-vs-
        # offline ATE comparison is apples-to-apples
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0),
        pose=PoseParams(
            initial=tuple(np.asarray(poses[0], np.float32).ravel().tolist())
        ),
    )
    raw_cap = pad_capacity_for(args.az * args.rings)
    server = OdometryStreamServer(
        params,
        StreamServerConfig(
            pipeline=args.pipeline, scan_capacity=raw_cap,
            scan_queue_depth=4,
        ),
    )
    server.start()
    client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)

    # receiver thread: stamp pose arrivals by frame seq
    arrivals = {}
    decoded = {}
    done = threading.Event()

    # the pipelined backend logs no pose for the bootstrap scan
    expected = args.frames if args.pipeline == "lo" else args.frames - 1

    def receive():
        try:
            while len(arrivals) < expected:
                msg = client.recv()
                if msg is None:
                    break
                if msg.msg_type == sp.MSG_POSE:
                    d = sp.decode_pose_payload(msg.payload)
                    arrivals[d[0]] = time.perf_counter()
                    decoded[d[0]] = d
                    if len(arrivals) % 10 == 0:
                        print(f"poses: {len(arrivals)}/{expected}",
                              file=sys.stderr, flush=True)
                elif msg.msg_type == sp.MSG_STATUS:
                    # per-frame server errors must be VISIBLE, not silently
                    # eaten while the closed-loop sender waits out deadlines
                    print(f"status: {msg.payload[:300]!r}",
                          file=sys.stderr, flush=True)
        finally:
            done.set()

    rx = threading.Thread(target=receive, daemon=True)
    rx.start()

    sends = {}
    period = 1.0 / args.hz if args.hz > 0 else 0.0
    t_start = None  # the rate clock starts AFTER the warmup frames
    for i, pts in enumerate(scans):
        if args.hz > 0 and t_start is not None:
            target = t_start + (i - args.warmup) * period
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
        t0 = time.perf_counter()
        seq = client.send_cloud({"points": pts}, timestamp=0.1 * i)
        sends[seq] = t0
        if args.hz == 0 or t_start is None:
            # closed loop: wait for this frame's pose (sync) or the
            # pipelined pipeline's pose from two frames back (its pipeline
            # depth) before offering the next scan; the bootstrap scan
            # (seq 1) has no pose in the pipelined backend.  Fixed-rate
            # runs ALSO pace their warmup frames closed-loop — the first
            # frames carry the jit compiles, and offering a fixed rate
            # into a cold server only measures the keep-last queue
            # dropping scans.
            deadline = time.perf_counter() + 300.0
            want = seq if args.pipeline == "lo" else seq - 2
            while (want >= (1 if args.pipeline == "lo" else 2)
                   and want not in arrivals
                   and time.perf_counter() < deadline):
                time.sleep(0.0005)
        if i == args.warmup:
            t_measure0 = time.perf_counter()
            if args.hz > 0:
                t_start = t_measure0

    # flush via the server's own processing thread (the pipeline is owned by
    # it; calling server.flush() from here would race)
    server._flushed.clear()
    server._flush_requested.set()
    server._wake.set()
    server._flushed.wait(timeout=300.0)
    done.wait(timeout=300.0)
    # drain any late poses the pipelined backend published on flush
    t_end_deadline = time.perf_counter() + 60.0
    while len(arrivals) < expected and time.perf_counter() < t_end_deadline:
        time.sleep(0.01)
    t_end = max(arrivals.values()) if arrivals else time.perf_counter()

    n_meas = args.frames - args.warmup
    fps = n_meas / max(t_end - t_measure0, 1e-9)
    lat = [
        (arrivals[s] - sends[s]) * 1e3
        for s in sends if s in arrivals and s > args.warmup
    ]
    tele = server.telemetry()

    # trajectory check: server poses must match ground truth like the
    # offline replay does (transport must not change results).  POSE seq k
    # is the pose estimate for the k-th sent scan -> ground truth poses[k-1].
    errs = []
    for s_ in sorted(decoded):
        if 1 <= s_ <= len(poses):
            errs.append(decoded[s_][3] - poses[s_ - 1][:3, 3])
    ate = float(np.sqrt(np.mean(np.sum(np.square(errs), axis=1))))

    out = {
        "config": "stream-serving",
        "pipeline": args.pipeline,
        "frames": args.frames,
        "offered_hz": args.hz,
        "raw_points_per_scan": int(raw_cap),
        "served_frames_per_sec": round(fps, 2),
        "ms_per_frame_e2e_median": round(float(np.median(lat)), 2) if lat else None,
        "ms_per_frame_e2e_p90": round(float(np.percentile(lat, 90)), 2) if lat else None,
        "ms_per_frame_e2e_p99": round(float(np.percentile(lat, 99)), 2) if lat else None,
        "poses_received": len(arrivals),
        "scan_queue_dropped": tele["scan_queue_dropped"],
        "frames_truncated_points": tele["frames_truncated_points"],
        "ate_translation_m": round(ate, 3),
        # server-side breakdown: where each frame's wall time went
        "server_queue_wait_ms": tele.get("queue_wait_ms"),
        "server_process_ms": tele.get("process_ms"),
        "server_pose_e2e_ms": tele.get("pose_e2e_server_ms"),
        "server_frame_timings_tail": list(server.frame_timings)[-40:],
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    client.close()
    server.stop()


if __name__ == "__main__":
    main()
