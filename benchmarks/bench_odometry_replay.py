"""Multi-frame odometry replay on the chip: >=50 synthetic Velodyne frames
through the full LiDAR odometry pipeline (preprocess -> covariances ->
robust-GICP vs submap -> voxel-hash submapping), reporting per-stage
ms/frame and trajectory accuracy vs the synthetic ground truth.

Stage names mirror the reference per-stage timing table
(pipeline/lidar_odometry.hpp:351-383 "1. preprocessing" ...
"4. build submap").

Frame times are host wall clock around ``process`` (the pipeline syncs on
its per-frame stats).  The report includes the per-frame device-sync count;
the fused per-step device cost is measured separately by bench_suite
config 5.  Needs a GPU; prints the card's name and power limit.

Usage: python benchmarks/bench_odometry_replay.py [--frames 60] [--json out]
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

from synthetic_velodyne import World, figure8_trajectory, scan_at, scan_at_distorted

from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu.pipeline.lidar_odometry import LidarOdometry, ResultType
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
from sycl_points_tpu.registration.pipeline import VelocityUpdateParams


def make_params(args, poses, map_capacity):
    import dataclasses

    from sycl_points_tpu.pipeline.params import (
        RegistrationBlockParams,
        SubmapOccupancyGridParams,
    )
    from sycl_points_tpu.registration.pipeline import RandomSamplingParams
    from sycl_points_tpu.registration.registration import RegistrationParams

    factor = RegistrationParams(
        coarse_to_fine_iters=args.coarse_to_fine,
    )
    reg_sampling = (
        RandomSamplingParams(enable=False)
        if args.reg_sampling == 0
        else RandomSamplingParams(enable=True, num=args.reg_sampling)
    )
    return LidarOdometryParams(
        scan=ScanParams(
            downsampling=DownsamplingParams(
                voxel=VoxelDownsamplingParams(enable=True, size=1.0),
                polar=PolarDownsamplingParams(enable=False),
                random=RandomDownsamplingParams(enable=True, num=args.scan_points),
            ),
        ),
        submap=SubmapParams(map_type=args.map_type, voxel_size=args.map_voxel,
                            map_capacity=map_capacity,
                            point_random_sampling_num=args.kf_points,
                            occupancy_grid_map=SubmapOccupancyGridParams(
                                free_space_update_cycle=args.og_carve_cycle,
                            )),
        registration=RegistrationBlockParams(factor=factor),
        registration_sampling=reg_sampling,
        scan_capacity=max(1 << 13, pad_capacity_for(args.scan_points)),
        pose=PoseParams(initial=tuple(np.asarray(poses[0], np.float32).ravel().tolist())),
        lo_velocity_update=VelocityUpdateParams(
            enable=bool(args.distort and args.deskew == "on")
        ),
    )


def generate_scans(args, world, poses):
    """Raycast (and disk-cache) all scans before any timed replay; returns
    (scans, timestamp arrays-or-Nones)."""
    scans_np, stamps_np = [], []
    sp_tag = "" if args.speed == 0.35 else f"_v{args.speed:g}"
    if args.hard:
        sp_tag += "_hard"
    # --noise-seed K regenerates every scan with an offset ray-jitter/noise
    # stream: the run-to-run variance probe for on/off ATE comparisons
    # (pipeline RNG is seeded, so plain repeats are deterministic)
    soff = 100000 * getattr(args, "noise_seed", 0)
    if soff:
        sp_tag += f"_ns{args.noise_seed}"
    for i, T in enumerate(poses):
        if args.distort:
            # true inter-frame sweep; final frame extrapolates its twist
            if i + 1 < len(poses):
                T_end = poses[i + 1]
            else:
                T_end = poses[i] @ (np.linalg.inv(poses[i - 1]) @ poses[i])
            pts, t_ms = scan_at_distorted(
                world, T, T_end, n_az=args.az, n_rings=args.rings, seed=i + soff,
                cache_tag=f"replay_dist_{args.az}x{args.rings}{sp_tag}_{i}",
            )
            stamps_np.append(t_ms)
        else:
            pts = scan_at(world, T, n_az=args.az, n_rings=args.rings, seed=i + soff,
                          cache_tag=f"replay_{args.az}x{args.rings}{sp_tag}_{i}")
            stamps_np.append(None)
        scans_np.append(pts)
    print(f"{len(scans_np)} scans generated ({len(pts)} pts last)",
          file=sys.stderr, flush=True)
    return scans_np, stamps_np


def run_replay(args, poses, scans_np, stamps_np, map_capacity,
               precompile_growth=0):
    """One full replay at a given initial map capacity; returns the artifact
    dict (the oracle control run reuses this with ample capacity)."""
    params = make_params(args, poses, map_capacity)
    if args.pipelined:
        from sycl_points_tpu.pipeline.pipelined_odometry import PipelinedLidarOdometry

        odo = PipelinedLidarOdometry(params)
    else:
        odo = LidarOdometry(params)
    if args.distort:
        # seed the CV velocity with the true initial body velocity: the IMU
        # deskew's v0 compensation comes from it, and an unseeded start
        # would deskew the map-seeding first frames rotation-only
        from synthetic_velodyne import figure8_velocity

        v0w = figure8_velocity(0.0, speed=args.speed)
        R0 = np.asarray(poses[0])[:3, :3]
        odo.linear_velocity = (R0.T @ v0w).astype(np.float32)
    raw_cap = pad_capacity_for(args.az * args.rings)


    # Bootstrap ladder: the first insert can itself hit drop-retry growth
    # (deliberately small initial capacity) before any frame has been
    # dispatched — compile the grow/insert/extract tiers up front so frame 0
    # swaps programs instead of paying eager compiles.
    boot_precompile_s = None
    if precompile_growth:
        from sycl_points_tpu.pipeline.fused_submap import precompile_bootstrap_ladder

        t0 = time.perf_counter()
        cloud0 = PointCloud.from_numpy(
            scans_np[0], timestamp_offsets=stamps_np[0], capacity=raw_cap
        )
        pre0 = odo.pc_processor.prefilter(cloud0)
        if odo._needs_covariances():
            ctx0 = odo.pc_processor.prepare_context(pre0)
            pre0 = odo.pc_processor.compute_covariances(pre0, ctx0)
            pre0 = odo.pc_processor.refine_filter(pre0, ctx0)
        steps0 = precompile_bootstrap_ladder(odo, precompile_growth, pre0)
        boot_precompile_s = round(time.perf_counter() - t0, 1)
        print(f"bootstrap ladder: {steps0} tiers precompiled in "
              f"{boot_precompile_s} s", file=sys.stderr, flush=True)

    stage_sums = {}
    frame_times = []
    sync_counts = []
    est_poses = []
    growth_events = []
    failed_frames = []
    cap_seen = odo.submap.map_capacity
    ext_seen = odo.submap.extract_capacity
    compile_log_seen = len(odo.submap.compile_log)
    n_ok = 0
    precompile_s = None
    for i, pts_np in enumerate(scans_np):
        cloud = PointCloud.from_numpy(
            pts_np, timestamp_offsets=stamps_np[i], capacity=raw_cap
        )  # untimed h2d
        t0 = time.perf_counter()
        r = odo.process(cloud, timestamp=0.1 * i)
        dt = time.perf_counter() - t0
        if (odo.submap.map_capacity != cap_seen
                or odo.submap.extract_capacity != ext_seen):
            cap_seen = odo.submap.map_capacity
            ext_seen = odo.submap.extract_capacity
            growth_events.append({"frame": i, "capacity": cap_seen,
                                  "extract_capacity": ext_seen,
                                  "frame_ms": round(dt * 1e3, 1),
                                  # what this event actually paid for
                                  # (Submap.compile_log delta: jit misses +
                                  # grow/re-extract host blocks)
                                  "compile_log": odo.submap.compile_log[
                                      compile_log_seen:]})
            compile_log_seen = len(odo.submap.compile_log)
        if not args.pipelined:
            est_poses.append(np.asarray(odo.odom).copy())
        if r in (ResultType.success, ResultType.first_frame):
            n_ok += 1
        else:
            failed_frames.append({"frame": i, "result": r.name})
            print(f"frame {i}: {r.name} ({odo.error_message})",
                  file=sys.stderr, flush=True)
        if i >= args.warmup:
            frame_times.append(dt)
            sync_counts.append(odo.sync_count_last_frame)
            for k, v in odo.processing_times.items():
                stage_sums[k] = stage_sums.get(k, 0.0) + v
        if i in (0, 1, args.warmup) or dt > 2.0:
            print(f"frame {i}: {r.name} {dt*1e3:.0f} ms", file=sys.stderr, flush=True)
        if i == 1 and precompile_growth:
            t0 = time.perf_counter()
            steps = odo.precompile_growth(precompile_growth, wait=True)
            precompile_s = round(time.perf_counter() - t0, 1)
            print(f"growth ladder: {steps} steps precompiled in {precompile_s} s",
                  file=sys.stderr, flush=True)

    if args.pipelined:
        odo.flush()
        # authoritative deferred outcomes replace the optimistic returns
        n_ok = 1 + sum(
            1 for _, rt in odo.deferred_results if rt is ResultType.success
        )  # +1: bootstrap frame
        failed_frames = [
            {"frame": fi + 1, "result": rt.name}
            for fi, rt in odo.deferred_results if rt is not ResultType.success
        ]
        est_poses = [np.asarray(poses[0], np.float32)] + [
            T for _, _, T, _ in odo.pose_log
        ]

    n = len(frame_times)
    stages_ms = {k: round(v / n * 1e3, 2) for k, v in sorted(stage_sums.items())}

    # trajectory accuracy: translation ATE (shared initial pose)
    gt = np.stack([p[:3, 3] for p in poses])
    est = np.stack([p[:3, 3] for p in est_poses])
    per_frame_err = np.sqrt(np.sum((est - gt) ** 2, axis=1))
    ate = float(np.sqrt(np.mean(per_frame_err**2)))

    config = "odometry-replay-hard" if args.hard else "odometry-replay"
    if args.distort:
        config += "-distorted" + ("" if args.deskew == "on" else "-deskew-off")
    return {
        "config": config,
        "frames": args.frames,
        "run_params": {"speed": args.speed, "map_voxel": args.map_voxel,
                       "map_capacity_initial": map_capacity,
                       "kf_points": args.kf_points,
                       "pipelined": args.pipelined,
                       "distort": args.distort, "deskew": args.deskew,
                       "og_carve_cycle": args.og_carve_cycle,
                       "scan_points": args.scan_points,
                       "reg_sampling": args.reg_sampling,
                       "coarse_to_fine": args.coarse_to_fine,
                       "growth_precompile_s": precompile_s,
                       "bootstrap_precompile_s": boot_precompile_s},
        "frames_ok": n_ok,
        "map_type": params.submap.map_type,
        "raw_points_per_scan": int(raw_cap),
        "ms_per_frame_wall": round(float(np.mean(frame_times)) * 1e3, 2),
        "ms_per_frame_median": round(float(np.median(frame_times)) * 1e3, 2),
        "ms_per_frame_max": round(float(np.max(frame_times)) * 1e3, 2),
        "stage_ms": stages_ms,
        "device_syncs_per_frame": int(np.median(sync_counts)),
        "device_syncs_max": int(np.max(sync_counts)),
        "ate_translation_m": round(ate, 3),
        "map_capacity_final": odo.submap.map_capacity,
        "extract_capacity_final": odo.submap.extract_capacity,
        "map_voxels_final": int(np.asarray(odo.submap.map_state.used).sum()),
        "map_dropped": int(odo.submap.map_state.dropped),
        "map_budget_lost": int(odo.submap.map_state.budget_lost),
        "extract_overflow_last": odo.submap.extract_overflow,
        "growth_events": growth_events,
        "failed_frames": failed_frames,
        # drift profile: translation error vs ground truth every 10th frame
        "err_m_every_10_frames": [round(float(e), 3) for e in per_frame_err[::10]],
    }


def main():
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=8, help="frames excluded from stats")
    ap.add_argument("--json", default=None)
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--az", type=int, default=2048)
    ap.add_argument("--map-capacity", type=int, default=1 << 17)
    ap.add_argument("--map-voxel", type=float, default=1.0)
    ap.add_argument("--speed", type=float, default=0.35)
    ap.add_argument("--hard", action="store_true",
                    help="clutter world: 8x boxes + 250 poles + 300 scatterers")
    ap.add_argument("--map-type", default="VOXEL_HASH_MAP",
                    choices=["VOXEL_HASH_MAP", "OCCUPANCY_GRID_MAP"])
    ap.add_argument("--kf-points", type=int, default=512,
                    help="points sampled into the map per keyframe")
    ap.add_argument("--pipelined", action="store_true",
                    help="PipelinedLidarOdometry: device-resident state + "
                         "one-frame-deferred async stats fetch")
    ap.add_argument("--precompile-growth", type=int, default=0, metavar="CAP",
                    help="after the first fused frame, synchronously compile "
                         "every map-growth step up to CAP (the deployment "
                         "warm-start for growth-heavy streams); the cost is "
                         "reported as growth_precompile_s, outside frame stats")
    ap.add_argument("--distort", action="store_true",
                    help="motion-distorted scans: each azimuth column raycast "
                         "from its sweep-interpolated pose, per-point "
                         "timestamps attached (the real-sensor skew the "
                         "reference corrects per frame, "
                         "relative_pose_deskew.hpp:37)")
    ap.add_argument("--deskew", choices=["on", "off"], default="on",
                    help="with --distort: enable the VICP constant-velocity "
                         "deskew inside registration (velocity_update.hpp:"
                         "17-109); 'off' quantifies the uncorrected damage")
    ap.add_argument("--og-carve-cycle", type=int, default=1,
                    help="occupancy backend: carve free space every k-th "
                         "frame, hits every frame (reference update knobs, "
                         "occupancy_grid_map.hpp:1072-1235)")
    ap.add_argument("--scan-points", type=int, default=5000,
                    help="preprocess random-downsampling target (raise for "
                         "full-cloud tiers)")
    ap.add_argument("--reg-sampling", type=int, default=1000,
                    help="registration input sampling num; 0 disables "
                         "sampling (registration runs on the whole "
                         "preprocessed cloud)")
    ap.add_argument("--coarse-to-fine", type=int, default=0, metavar="ITERS",
                    help="first ITERS ICP iterations search every "
                         "coarse_stride-th target point (full-cloud speed "
                         "knob through the PIPELINE params — "
                         "registration.factor.coarse_to_fine_iters)")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="offset the per-scan noise/jitter RNG stream: "
                         "repeat runs with different --noise-seed quantify "
                         "run-to-run ATE variance (r4 verdict ask 9)")
    ap.add_argument("--oracle-capacity", type=int, default=0, metavar="CAP",
                    help="also run an ample-capacity control replay at CAP "
                         "and attach its ATE, separating 'growth machinery "
                         "costs accuracy' from 'trajectory is just harder'")
    args = ap.parse_args()
    require_gpu()
    enable_persistent_cache()

    print(f"device: {jax.devices()[0].device_kind}; card: {card_line()}",
          file=sys.stderr, flush=True)

    world = World(hard=args.hard)
    poses = figure8_trajectory(args.frames, speed=args.speed)
    scans_np, stamps_np = generate_scans(args, world, poses)

    out = run_replay(args, poses, scans_np, stamps_np, args.map_capacity,
                     precompile_growth=args.precompile_growth)
    if args.oracle_capacity:
        print("oracle control run...", file=sys.stderr, flush=True)
        oracle = run_replay(args, poses, scans_np, stamps_np,
                            args.oracle_capacity)
        out["oracle"] = {
            "map_capacity_initial": args.oracle_capacity,
            "ate_translation_m": oracle["ate_translation_m"],
            "frames_ok": oracle["frames_ok"],
            "map_dropped": oracle["map_dropped"],
            "growth_events": len(oracle["growth_events"]),
        }
        # the run-vs-oracle ATE comparison is surfaced with its noise
        # context: an oracle can come out WORSE than the growth run
        d_ate = out["ate_translation_m"] - oracle["ate_translation_m"]
        out["oracle_note"] = (
            f"growth-run ATE {out['ate_translation_m']:.3f} vs ample-capacity "
            f"oracle {oracle['ate_translation_m']:.3f} (delta {d_ate:+.3f} m). "
            "Run-to-run ATE noise on this trajectory is of comparable scale "
            "(hard-world figure-8: +-1 m observed across r4 repeats), so "
            "deltas within that band indicate growth costs no accuracy, not "
            "that either run is 'better'."
        )
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
