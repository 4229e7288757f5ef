"""Smoke run of the LiDAR odometry stack on one NVIDIA GPU, at full scan width.

Drives the main path once through the entry points a user calls, on
synthetic HDL-64E-like scans (64 rings x 2048 azimuths = 131,072 points at
10 Hz, ``benchmarks/synthetic_velodyne.py``) with analytic ground truth, and
checks every result against a reference:

  knn     exact KNN at real widths (k=1 correspondence search, k=10/20
          self-KNN) against scipy's cKDTree
  pair    bench.py's preprocess + robust-GICP step against the ground truth
          and against the same step on the CPU in plain float32
  lo      apps.kitti_odometry on 20 scans written as KITTI .bin files: ATE
  lio     15-DOF LidarInertialOdometry with a 400 Hz IMU: ATE
  stream  OdometryStreamServer (lo_pipelined) fed 10 scans at 10 Hz over
          its socket: a finite pose for every scan after the first, ATE

``--cards 4`` runs only the mesh paths instead: FleetOdometry with its
stream axis sharded over four cards against the same streams on one card,
and ``sharded_align`` against single-card ``align``.

Usage: python chip_smoke.py [--cards 4]

Each phase prints its compile seconds, steady wall time (host clock around
``block_until_ready``, warm-up excluded), the device's peak bytes in use so
far, and its accuracy beside its bound.  The last line is one JSON object.
The script exits nonzero, with no result line, when JAX finds no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import threading
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

import bench  # noqa: E402
from synthetic_velodyne import (  # noqa: E402
    World,
    figure8_imu,
    figure8_trajectory,
    figure8_velocity,
    scan_at,
)
from sycl_points_tpu.ops.knn import approx_knn, brute_force_knn  # noqa: E402
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for  # noqa: E402
from sycl_points_tpu.utils.compile_cache import enable_persistent_cache  # noqa: E402
from sycl_points_tpu.utils.device import card_line, require_gpu  # noqa: E402


class Sizes(NamedTuple):
    n_az: int = 2048
    n_rings: int = 64
    frames: int = 20  # lo / lio
    stream_frames: int = 10
    fleet_frames: int = 10
    queries: int = 1000  # sampled correspondence queries
    reps: int = 20  # timed calls per variant


FULL = Sizes()
# Bounds: ground truth of the pair, the float32 CPU reference, the ATE of
# every odometry phase, the exact-KNN comparison with cKDTree.
PAIR_GT_M, PAIR_GT_DEG = 0.05, 0.5
PAIR_REF_M, PAIR_REF_DEG = 0.01, 0.1
ATE_M = 0.5
KNN_AGREE, KNN_RTOL = 0.9999, 1e-5
MESH_M, MESH_DEG = 0.01, 0.1
WARM = 3  # odometry frames that carry the compiles, left out of steady times


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, compile_s: float, steady_ms: float, accuracy: str) -> None:
    log(f"[{phase}] compile_s={compile_s:.3f} steady_ms={steady_ms:.3f} "
        f"peak_bytes_in_use={peak_bytes()} {accuracy}")


def first_call_s(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def pose_error(T_a, T_b):
    """(translation m, rotation deg) between two 4x4 poses."""
    T_a, T_b = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    dt = float(np.linalg.norm(T_a[:3, 3] - T_b[:3, 3]))
    R = T_a[:3, :3].T @ T_b[:3, :3]
    # atan2 of the skew and symmetric parts: arccos of the trace alone
    # reads float32 rounding of a near-identity R as ~0.08 deg
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return dt, float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def ate(est_xyz, gt_xyz) -> float:
    e = np.asarray(est_xyz, np.float64) - np.asarray(gt_xyz, np.float64)
    return float(np.sqrt(np.mean(np.sum(e * e, axis=1))))


# --------------------------------------------------------------------------
# shared inputs


@dataclasses.dataclass
class Pair:
    src: PointCloud  # raw, device
    tgt: PointCloud
    cap: int  # post-voxel capacity
    T_gt: np.ndarray
    step: object  # bench.make_step(cap)
    src_pre: PointCloud  # post-voxel, with covariances
    tgt_pre: PointCloud


def make_pair(sizes: Sizes) -> Pair:
    src, tgt, cap, _, T_gt = bench.load_pair(sizes.n_az, sizes.n_rings)
    pre = jax.jit(lambda c: bench.preprocess(c, cap))
    return Pair(src, tgt, cap, T_gt, bench.make_step(cap), pre(src), pre(tgt))


def scans_along(poses, sizes: Sizes, seed0: int = 0):
    world = World()
    return [scan_at(world, T, n_az=sizes.n_az, n_rings=sizes.n_rings, seed=seed0 + i)
            for i, T in enumerate(poses)]


# --------------------------------------------------------------------------
# phase 1: knn


def _valid(cloud: PointCloud) -> np.ndarray:
    """The valid points, which both the loader and the voxel filter keep as
    a prefix of the padded arrays (so indices into either agree)."""
    mask = np.asarray(cloud.mask)
    n = int(mask.sum())
    check(bool(mask[:n].all()), "valid points are not a prefix")
    return np.asarray(cloud.points)[:n]


def check_knn(name, idx, d2, qry, tgt, k):
    """Exact KNN against cKDTree: indices agree on >= KNN_AGREE of entries,
    every disagreement is a tie at the same distance, and distances agree
    to KNN_RTOL.  ``idx`` indexes ``tgt``."""
    idx = np.asarray(idx).reshape(len(qry), k)
    d2 = np.asarray(d2, np.float64).reshape(len(qry), k)
    ref_d, ref_i = cKDTree(tgt.astype(np.float64)).query(qry.astype(np.float64), k=k)
    ref_d2 = np.reshape(ref_d, (len(qry), k)) ** 2
    ref_i = np.reshape(ref_i, (len(qry), k))
    mis = idx != ref_i
    agree = 1.0 - float(mis.mean())
    ours64 = np.sum((qry[:, None, :].astype(np.float64) - tgt[idx].astype(np.float64)) ** 2, -1)
    ties = np.abs(ours64 - ref_d2) <= KNN_RTOL * ref_d2 + 1e-12
    check(agree >= KNN_AGREE and bool(ties[mis].all()),
          f"{name}: index agreement {agree:.6f} (bound {KNN_AGREE}), "
          f"{int((mis & ~ties).sum())} non-tie mismatches")
    np.testing.assert_allclose(d2, ref_d2, rtol=KNN_RTOL, atol=1e-12, err_msg=name)
    return agree


def phase_knn(sizes: Sizes, pair: Pair) -> dict:
    src_q = _valid(pair.src_pre)
    rng = np.random.default_rng(0)
    sample = src_q[rng.choice(len(src_q), min(sizes.queries, len(src_q)), replace=False)]
    out, compile_s, times = {}, 0.0, {}

    nn1 = jax.jit(lambda t, m, q: brute_force_knn(t, m, q, 1))
    for qname, qry in (("Q=sample", sample), ("Q=source", src_q)):
        for tname, tcloud in (("M=target", pair.tgt_pre), ("M=raw", pair.tgt)):
            args = (tcloud.points, tcloud.mask, jnp.asarray(qry))
            c_s, r = first_call_s(nn1, *args)
            compile_s += c_s
            name = f"nn1 {qname}({len(qry)}) {tname}({tcloud.capacity})"
            out[name] = check_knn(name, r.indices, r.distances, qry, _valid(tcloud), 1)
            times[name] = bench.median_ms(nn1, *args, iters=sizes.reps, warmup=0)

    for k in (10, 20):
        for fname, fn in (("approx_knn", approx_knn), ("brute_force_knn", brute_force_knn)):
            f = jax.jit(lambda p, m, fn=fn, k=k: fn(p, m, p, k))
            args = (pair.src_pre.points, pair.src_pre.mask)
            c_s, r = first_call_s(f, *args)
            compile_s += c_s
            name = f"self-knn k={k} {fname} ({len(src_q)} points)"
            n = len(src_q)  # valid points are the prefix of the voxel output
            out[name] = check_knn(name, np.asarray(r.indices)[:n],
                                  np.asarray(r.distances)[:n], src_q, src_q, k)
            times[name] = bench.median_ms(f, *args, iters=sizes.reps, warmup=0)
    for name, ms in times.items():
        log(f"[knn] {name}: {ms:.3f} ms, index agreement {out[name]:.6f} "
            f"(bound {KNN_AGREE}), dist rtol {KNN_RTOL}")
    report("knn", compile_s, sum(times.values()), f"min_agreement={min(out.values()):.6f}")
    return {"agreement": out, "ms": times}


# --------------------------------------------------------------------------
# phase 2: pair


def phase_pair(sizes: Sizes, pair: Pair) -> dict:
    key = jax.random.key(1234)
    compile_s, (T, inlier, _) = first_call_s(pair.step, pair.src, pair.tgt, key)
    steady = bench.median_ms(pair.step, pair.src, pair.tgt, key, iters=sizes.reps, warmup=0)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        args = jax.device_put((pair.src, pair.tgt, key), cpu)
        T_ref = np.asarray(bench.make_step(pair.cap)(*args)[0])
    gt_m, gt_deg = pose_error(T, pair.T_gt)
    ref_m, ref_deg = pose_error(T, T_ref)
    report("pair", compile_s, steady,
           f"gt_err={gt_m:.5f} m/{gt_deg:.4f} deg (bound {PAIR_GT_M} m/{PAIR_GT_DEG} deg) "
           f"cpu_ref_err={ref_m:.5f} m/{ref_deg:.4f} deg (bound {PAIR_REF_M} m/{PAIR_REF_DEG} deg) "
           f"inlier={int(inlier)}")
    check(gt_m <= PAIR_GT_M and gt_deg <= PAIR_GT_DEG, "pair: ground truth bound")
    check(ref_m <= PAIR_REF_M and ref_deg <= PAIR_REF_DEG, "pair: CPU reference bound")
    return {"ms": steady, "gt_m": gt_m, "ref_m": ref_m}


# --------------------------------------------------------------------------
# phase 3: lo


def relative_xyz(poses):
    T0inv = np.linalg.inv(poses[0])
    return np.stack([(T0inv @ T)[:3, 3] for T in poses])


def phase_lo(sizes: Sizes) -> dict:
    from sycl_points_tpu.apps import kitti_odometry

    poses = figure8_trajectory(sizes.frames)
    scans = scans_along(poses, sizes)
    with tempfile.TemporaryDirectory() as d:
        vel = os.path.join(d, "velodyne")
        os.makedirs(vel)
        for i, pts in enumerate(scans):
            inten = np.zeros((len(pts), 1), np.float32)
            np.concatenate([pts, inten], 1).astype(np.float32).tofile(
                os.path.join(vel, f"{i:06d}.bin"))
        out = os.path.join(d, "traj.tum")
        frame_s = []
        with contextlib.redirect_stdout(io.StringIO()):
            rc = kitti_odometry.main([vel, "--out", out], frame_times=frame_s)
        check(rc == 0, f"lo: kitti_odometry returned {rc}")
        traj = np.loadtxt(out)
    err = ate(traj[:, 1:4], relative_xyz(poses))
    steady = float(np.median(frame_s[WARM:])) * 1e3
    report("lo", sum(frame_s[:WARM]), steady,
           f"ate={err:.4f} m (bound {ATE_M} m) frames={len(traj)}")
    check(len(traj) == sizes.frames and err <= ATE_M, "lo: ATE bound")
    return {"ms": steady, "ate": err}


# --------------------------------------------------------------------------
# phase 4: lio


def phase_lio(sizes: Sizes) -> dict:
    from sycl_points_tpu.imu.preintegration import IMUMeasurement, IMUPreintegrationParams
    from sycl_points_tpu.pipeline.lidar_inertial_odometry import LidarInertialOdometry
    from sycl_points_tpu.pipeline.params import IMUParams, LidarInertialOdometryParams, PoseParams, SubmapParams
    from sycl_points_tpu.apps.kitti_odometry import default_kitti_params

    imu_hz, frame_dt = 400, 0.1
    poses = figure8_trajectory(sizes.frames)
    scans = scans_along(poses, sizes)
    params = LidarInertialOdometryParams(
        scan=default_kitti_params().scan,
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0),
        pose=PoseParams(initial=tuple(np.asarray(poses[0], np.float32).ravel().tolist())),
        imu=IMUParams(enable=True, preintegration=IMUPreintegrationParams(
            gyro_noise_density=1e-3, accel_noise_density=1e-2,
            gyro_bias_rw_density=1e-5, accel_bias_rw_density=1e-4,
        )),
    )
    odo = LidarInertialOdometry(params)
    # the figure-8 starts in motion: seed the filter with the true velocity
    v0 = figure8_velocity(0.0).astype(np.float32)
    odo.x = odo.x._replace(velocity=jnp.asarray(v0))
    odo.velocity_np = v0
    odo.imu_v_world_at_reset = v0
    raw_cap = pad_capacity_for(sizes.n_az * sizes.n_rings)
    est, frame_s, fed_to = [], [], -frame_dt * 0.5
    for i, pts in enumerate(scans):
        ts = frame_dt * i
        n = max(int(round((ts - fed_to) * imu_hz)), 1)
        for j in range(n + 1):
            t = fed_to + (ts - fed_to) * j / n
            g, a = figure8_imu(t)
            odo.add_imu_measurement(IMUMeasurement(
                timestamp=t, gyro=g.astype(np.float32), accel=a.astype(np.float32)))
        fed_to = ts
        cloud = PointCloud.from_numpy(pts, capacity=raw_cap)
        t0 = time.perf_counter()
        odo.process(cloud, timestamp=ts)
        est.append(np.asarray(odo.odom).copy())
        frame_s.append(time.perf_counter() - t0)
    err = ate([T[:3, 3] for T in est], [T[:3, 3] for T in poses])
    steady = float(np.median(frame_s[WARM:])) * 1e3
    report("lio", sum(frame_s[:WARM]), steady, f"ate={err:.4f} m (bound {ATE_M} m)")
    check(err <= ATE_M, "lio: ATE bound")
    return {"ms": steady, "ate": err}


# --------------------------------------------------------------------------
# phase 5: stream


def phase_stream(sizes: Sizes) -> dict:
    from sycl_points_tpu.apps import stream_protocol as sp
    from sycl_points_tpu.apps.kitti_odometry import default_kitti_params
    from sycl_points_tpu.apps.stream_odometry import (
        OdometryStreamClient,
        OdometryStreamServer,
        StreamServerConfig,
    )
    from sycl_points_tpu.pipeline.params import PoseParams, SubmapParams

    n = sizes.stream_frames
    poses = figure8_trajectory(n)
    scans = scans_along(poses, sizes)
    params = dataclasses.replace(
        default_kitti_params(),
        submap=SubmapParams(map_type="VOXEL_HASH_MAP", voxel_size=1.0),
        pose=PoseParams(initial=tuple(np.asarray(poses[0], np.float32).ravel().tolist())),
    )
    server = OdometryStreamServer(params, StreamServerConfig(
        pipeline="lo_pipelined",
        scan_capacity=pad_capacity_for(sizes.n_az * sizes.n_rings),
        # every scan is kept: the first frames compile while the rest queue
        scan_queue_depth=n,
    ))
    server.start()
    got, errors = {}, []
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)

        def send():
            t_start = time.perf_counter()
            try:
                for i, pts in enumerate(scans):
                    time.sleep(max(0.0, t_start + 0.1 * i - time.perf_counter()))
                    client.send_cloud({"points": pts}, timestamp=0.1 * i)
                for msg in client.finish():
                    if msg.msg_type == sp.MSG_POSE:
                        seq, _, _, t, _ = sp.decode_pose_payload(msg.payload)
                        got[seq] = t
            except Exception as e:  # reported by the main thread below
                errors.append(e)

        t0 = time.perf_counter()
        th = threading.Thread(target=send, name="smoke-client")
        th.start()
        th.join(timeout=1200.0)
        wall = time.perf_counter() - t0
        check(not th.is_alive(), "stream: client did not finish")
        if errors:
            raise errors[0]
        tele = server.telemetry()
    finally:
        server.stop()
    want = set(range(2, n + 1))  # the bootstrap scan (seq 1) has no pose
    finite = {s for s, t in got.items() if np.all(np.isfinite(t))}
    check(want <= finite, f"stream: poses for {sorted(finite)}, want {sorted(want)}")
    err = ate([got[s] for s in sorted(want)], [poses[s - 1][:3, 3] for s in sorted(want)])
    proc = (tele.get("process_ms") or {}).get("median", float("nan"))
    report("stream", wall, proc,
           f"ate={err:.4f} m (bound {ATE_M} m) poses={len(finite)}/{n - 1} "
           f"queue_dropped={tele['scan_queue_dropped']} last_error={tele['last_error']!r}")
    check(err <= ATE_M and tele["scan_queue_dropped"] == 0, "stream: ATE / drop bound")
    return {"ms": proc, "ate": err}


# --------------------------------------------------------------------------
# --cards 4: mesh paths


def phase_fleet(sizes: Sizes, n_cards: int) -> dict:
    from sycl_points_tpu.apps.kitti_odometry import default_kitti_params
    from sycl_points_tpu.parallel.fleet import FleetOdometry
    from sycl_points_tpu.parallel.sharded import make_mesh

    B, n = n_cards, sizes.fleet_frames
    base = figure8_trajectory(n)
    trajs = []
    for s in range(B):
        yaw = 2.0 * np.pi * s / B
        R = np.eye(4)
        R[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        trajs.append([R @ T for T in base])
    scans = [scans_along([trajs[s][i] for s in range(B)], sizes, seed0=100 * i)
             for i in range(n)]
    raw_cap = pad_capacity_for(sizes.n_az * sizes.n_rings)
    init = np.stack([t[0] for t in trajs]).astype(np.float32)
    params = default_kitti_params()
    fleets = {
        "sharded": FleetOdometry(params, n_streams=B, initial_poses=init, seed=3,
                                 mesh=make_mesh(n_cards, axis="streams")),
        "one card": FleetOdometry(params, n_streams=B, initial_poses=init, seed=3),
    }
    times = {}
    for name, fleet in fleets.items():
        t0 = time.perf_counter()
        for i in range(n):
            if i == WARM:
                fleet.flush()
                t1 = time.perf_counter()
            clouds = [PointCloud.from_numpy(p, capacity=raw_cap) for p in scans[i]]
            stacked = PointCloud(points=jnp.stack([c.points for c in clouds]),
                                 mask=jnp.stack([c.mask for c in clouds]))
            fleet.process_batch(stacked, timestamps=0.1 * i)
        fleet.flush()
        t2 = time.perf_counter()
        # process_batch resolves its stats frames later, so the steady time
        # is the wall from the warm-up's flush to the final flush per frame
        times[name] = (t1 - t0, (t2 - t1) / (n - WARM) * 1e3)
    worst_m = worst_deg = 0.0
    ates = []
    for s in range(B):
        a = [T for _, _, T, _ in fleets["sharded"].pose_log[s]]
        b = [T for _, _, T, _ in fleets["one card"].pose_log[s]]
        check(len(a) == len(b) == n - 1, f"fleet: stream {s} logged {len(a)}/{len(b)} poses")
        for Ta, Tb in zip(a, b):
            dm, dd = pose_error(Ta, Tb)
            worst_m, worst_deg = max(worst_m, dm), max(worst_deg, dd)
        ates.append(ate([T[:3, 3] for T in a], [T[:3, 3] for T in trajs[s][1:]]))
    for name, (c_s, ms) in times.items():
        report(f"fleet {name}", c_s, ms, f"streams={B} frames={n}")
    log(f"[fleet] sharded vs one card: worst {worst_m:.6f} m/{worst_deg:.5f} deg "
        f"(bound {MESH_M} m/{MESH_DEG} deg); ATE per stream {[round(x, 4) for x in ates]} (bound {ATE_M} m)")
    check(worst_m <= MESH_M and worst_deg <= MESH_DEG, "fleet: sharded vs one card")
    check(max(ates) <= ATE_M, "fleet: ATE bound")
    return {"worst_m": worst_m, "ates": ates}


def phase_sharded_align(sizes: Sizes, pair: Pair, n_cards: int) -> dict:
    from sycl_points_tpu.ops.knn import BruteForceKNN
    from sycl_points_tpu.parallel.sharded import make_mesh, sharded_align
    from sycl_points_tpu.registration.registration import align

    # sharded_align jits a new program per call, so each side is run once
    # and only its first-call seconds are reported
    params = bench.PIPELINE_PARAMS.registration
    one = jax.jit(lambda s, t: align(s, t, BruteForceKNN.build(t), params))
    c1, r1 = first_call_s(one, pair.src_pre, pair.tgt_pre)
    mesh = make_mesh(n_cards)
    c4, r4 = first_call_s(lambda: sharded_align(mesh, pair.src_pre, pair.tgt_pre, params))
    dm, dd = pose_error(r4.T, r1.T)
    gt_m, gt_deg = pose_error(r4.T, pair.T_gt)
    log(f"[sharded_align] first call: one card {c1:.3f} s, {n_cards} cards {c4:.3f} s; "
        f"peak_bytes_in_use={peak_bytes()}; {n_cards} cards vs one card {dm:.6f} m/{dd:.5f} deg "
        f"(bound {MESH_M} m/{MESH_DEG} deg); gt_err={gt_m:.5f} m/{gt_deg:.4f} deg")
    check(dm <= MESH_M and dd <= MESH_DEG, "sharded_align vs one card")
    return {"dm": dm}


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh paths across four cards")
    args = ap.parse_args(argv)
    devs = require_gpu(args.cards)
    t_all = time.perf_counter()
    cache = enable_persistent_cache()
    log(f"jax {jax.__version__}; compile cache {cache}")
    log(f"device_kind {devs[0].device_kind}; devices {len(jax.devices())}")
    sizes = FULL
    pair = make_pair(sizes)
    log(f"pair: {len(_valid(pair.src_pre))} source voxels, capacity {pair.cap}")
    if args.cards == 1:
        phase_knn(sizes, pair)
        phase_pair(sizes, pair)
        phase_lo(sizes)
        phase_lio(sizes)
        phase_stream(sizes)
    else:
        phase_fleet(sizes, args.cards)
        phase_sharded_align(sizes, pair, args.cards)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card_line())
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
