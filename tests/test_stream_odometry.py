"""Live streaming transport tests: protocol round trip, keep-last QoS,
and end-to-end odometry over a localhost socket (the ROS-less analog of the
reference's live-node integration, ros2/sycl_points_ros2/src/*_node.cpp)."""

import time

import numpy as np
import pytest

from sycl_points_tpu.apps import stream_protocol as sp
from sycl_points_tpu.apps.stream_odometry import (
    OdometryStreamClient,
    OdometryStreamServer,
    StreamServerConfig,
    _KeepLastQueue,
)
from sycl_points_tpu.pipeline.params import (
    AngleIncidenceFilterParams,
    BoxFilterParams,
    CovarianceEstimationParams,
    DownsamplingParams,
    KeyframeParams,
    LidarOdometryParams,
    MEstimationParams,
    PolarDownsamplingParams,
    PreprocessParams,
    RandomDownsamplingParams,
    RandomSamplingParams,
    RegistrationBlockParams,
    ScanParams,
    SubmapParams,
    VoxelDownsamplingParams,
)
from sycl_points_tpu.registration.factors import RegType
from sycl_points_tpu.registration.registration import RegistrationParams

RNG = np.random.default_rng(77)


# -- protocol unit tests -------------------------------------------------------

def test_protocol_pointcloud_roundtrip():
    cloud = {
        "points": RNG.uniform(-5, 5, size=(100, 3)).astype(np.float32),
        "intensities": RNG.uniform(0, 1, size=100).astype(np.float32),
        "timestamp_offsets": np.linspace(0, 80, 100).astype(np.float32),
    }
    payload = sp.cloud_to_payload(cloud)
    out = sp.payload_to_cloud(payload)
    np.testing.assert_allclose(out["points"], cloud["points"], rtol=1e-6)
    np.testing.assert_allclose(out["intensities"], cloud["intensities"])
    # conversion normalizes time offsets to ms-from-start; ours already are
    np.testing.assert_allclose(
        out["timestamp_offsets"], cloud["timestamp_offsets"], atol=1e-3
    )


def test_protocol_message_framing_roundtrip():
    msg = sp.Message(msg_type=sp.MSG_IMU, seq=42, timestamp=123.456,
                     payload=sp.encode_imu_payload([0.1, 0.2, 0.3],
                                                   [0, 0, 9.81]),
                     flags=sp.FLAG_WANT_MAP)
    raw = sp.encode(msg)
    mt, flags, seq, ts, plen = sp.decode_header(raw[:sp.HEADER_SIZE])
    assert (mt, flags, seq) == (sp.MSG_IMU, sp.FLAG_WANT_MAP, 42)
    assert ts == pytest.approx(123.456)
    gyro, accel = sp.decode_imu_payload(raw[sp.HEADER_SIZE:])
    np.testing.assert_allclose(gyro, [0.1, 0.2, 0.3], rtol=1e-6)
    np.testing.assert_allclose(accel, [0, 0, 9.81], rtol=1e-6)


def test_protocol_pose_roundtrip():
    t = np.array([1.5, -2.0, 0.25], np.float32)
    q = np.array([0.0, 0.0, 0.3827, 0.9239], np.float32)
    payload = sp.encode_pose_payload(7, 0, 123.0, t, q)
    seq, code, inlier, t2, q2 = sp.decode_pose_payload(payload)
    assert (seq, code) == (7, 0)
    assert inlier == pytest.approx(123.0)
    np.testing.assert_allclose(t2, t)
    np.testing.assert_allclose(q2, q, atol=1e-6)


def test_protocol_status_and_bad_magic():
    st = {"frames": 3, "dropped": 0}
    assert sp.decode_status_payload(sp.encode_status_payload(st)) == st
    with pytest.raises(sp.ProtocolError):
        sp.decode_header(b"XXXX" + b"\0" * (sp.HEADER_SIZE - 4))


def test_keep_last_queue_drops_oldest_counted():
    q = _KeepLastQueue(depth=3)
    for i in range(5):
        q.push(i)
    assert q.dropped == 2
    assert q.pop() == 2  # oldest two (0, 1) were dropped
    assert len(q) == 2


# -- end-to-end over localhost ---------------------------------------------------

def _world(n=3000):
    rng = np.random.default_rng(123)
    per = n // 3
    u = rng.uniform(-8, 8, size=(per, 2)).astype(np.float32)
    floor = np.stack([u[:, 0], u[:, 1], np.full(per, -1.0, np.float32)], 1)
    wall1 = np.stack([np.full(per, 8.0, np.float32), u[:, 0], u[:, 1] * 0.25], 1)
    wall2 = np.stack([u[:, 0], np.full(per, 8.0, np.float32), u[:, 1] * 0.25], 1)
    w = np.concatenate([floor, wall1, wall2])
    return w + rng.normal(scale=0.005, size=w.shape).astype(np.float32)


def _scan_at(world, shift):
    local = world - np.asarray(shift, np.float32)
    keep = np.linalg.norm(local, axis=1) < 20.0
    return local[keep].astype(np.float32)


def _small_params(iters=8):
    return LidarOdometryParams(
        scan=ScanParams(
            downsampling=DownsamplingParams(
                voxel=VoxelDownsamplingParams(enable=True, size=0.4),
                polar=PolarDownsamplingParams(enable=False),
                random=RandomDownsamplingParams(enable=True, num=1024),
            ),
            preprocess=PreprocessParams(
                box_filter=BoxFilterParams(enable=True, min=0.5, max=30.0),
                angle_incidence_filter=AngleIncidenceFilterParams(enable=False),
            ),
        ),
        submap=SubmapParams(
            map_type="VOXEL_HASH_MAP",
            voxel_size=0.5,
            point_random_sampling_num=512,
            keyframe=KeyframeParams(
                inlier_ratio_threshold=0.1,
                distance_threshold=0.1,
                angle_threshold_degrees=5.0,
                time_threshold_seconds=0.5,
            ),
            map_capacity=1 << 13,
            extract_capacity=1 << 11,
        ),
        covariance_estimation=CovarianceEstimationParams(
            m_estimation=MEstimationParams(enable=False)
        ),
        registration=RegistrationBlockParams(
            min_num_points=50,
            factor=RegistrationParams(reg_type=RegType.GICP,
                                      max_iterations=iters),
        ),
        registration_sampling=RandomSamplingParams(enable=True, num=512),
        scan_capacity=1 << 11,
    )


@pytest.mark.slow
def test_stream_lo_end_to_end():
    world = _world()
    server = OdometryStreamServer(
        _small_params(),
        StreamServerConfig(pipeline="lo", scan_capacity=1 << 12),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        n_frames = 5
        poses = []
        for i in range(n_frames):
            shift = [0.2 * i, 0.0, 0.0]
            pts = _scan_at(world, shift)
            client.send_cloud(
                {"points": pts}, timestamp=0.1 * i,
                want_map=(i == n_frames - 1),
            )
            poses.append(client.recv_pose())
        # first frame bootstraps; the rest register
        assert poses[0][1] == 1  # first_frame
        assert all(p[1] == 0 for p in poses[1:])  # success
        # the sensor moved +x in the world => odometry x grows
        xs = [p[3][0] for p in poses]
        assert xs[-1] > 0.5, f"expected forward motion, got x={xs}"
        for p in poses:
            assert np.all(np.isfinite(p[3])) and np.all(np.isfinite(p[4]))
        # map snapshot requested with the last scan
        tail = client.finish()
        maps = [m for m in client.side_messages + tail
                if m.msg_type == sp.MSG_MAP]
        assert maps, "MAP snapshot was requested but never arrived"
        map_cloud = sp.payload_to_cloud(maps[-1].payload)
        assert len(map_cloud["points"]) > 100
        assert np.all(np.isfinite(map_cloud["points"]))
        assert server.telemetry()["scan_queue_dropped"] == 0
    finally:
        server.stop()


@pytest.mark.slow
def test_stream_lo_pipelined_flush_delivers_all_poses():
    world = _world()
    server = OdometryStreamServer(
        _small_params(),
        StreamServerConfig(pipeline="lo_pipelined", scan_capacity=1 << 12),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        n_frames = 5
        for i in range(n_frames):
            pts = _scan_at(world, [0.2 * i, 0.0, 0.0])
            client.send_cloud({"points": pts}, timestamp=0.1 * i)
            time.sleep(0.05)  # lockstep-ish; QoS depth still covers bursts
        tail = client.finish()
        pose_msgs = [m for m in tail if m.msg_type == sp.MSG_POSE]
        # the pipelined pipeline logs poses from frame 1 on (frame 0 boots)
        assert len(pose_msgs) >= n_frames - 1, (
            f"expected >= {n_frames - 1} poses after flush, "
            f"got {len(pose_msgs)}"
        )
        decoded = [sp.decode_pose_payload(m.payload) for m in pose_msgs]
        # POSE seq must be the CLIENT's scan seq (the pipelined backend logs
        # by internal frame index; the server maps it back): scan 1 boots,
        # scans 2..n get poses, in order
        assert [d[0] for d in decoded] == list(range(2, n_frames + 1))
        # and each pose must belong to ITS scan: scan k was taken at
        # x = 0.2*(k-1), so the estimate for seq k tracks that
        for d in decoded:
            expect_x = 0.2 * (d[0] - 1)
            assert abs(d[3][0] - expect_x) < 0.1, (
                f"pose seq {d[0]} x={d[3][0]:.3f}, expected ~{expect_x:.2f}"
            )
        xs = [d[3][0] for d in decoded]
        assert xs[-1] > 0.4
        status = [m for m in tail if m.msg_type == sp.MSG_STATUS]
        assert status, "final STATUS telemetry missing"
        st = sp.decode_status_payload(status[-1].payload)
        assert st["frames_processed"] == n_frames
    finally:
        server.stop()


@pytest.mark.slow
def test_stream_truncation_is_counted_not_silent():
    world = _world(1200)
    cap = 1 << 9
    server = OdometryStreamServer(
        _small_params(iters=4),
        StreamServerConfig(pipeline="lo", scan_capacity=cap),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        pts = _scan_at(world, [0, 0, 0])
        assert len(pts) > cap
        client.send_cloud({"points": pts}, timestamp=0.0)
        client.recv_pose()
        statuses = [m for m in client.side_messages
                    if m.msg_type == sp.MSG_STATUS]
        assert statuses, "truncation STATUS missing"
        st = sp.decode_status_payload(statuses[0].payload)
        assert st["truncated_points"] == len(pts) - cap
        assert server.frames_truncated_points == 1
        client.finish()
    finally:
        server.stop()


@pytest.mark.slow
def test_stream_lio_pipelined_end_to_end():
    """Full 15-DOF LIO over the socket: IMU + scan messages in, poses out.

    The transport analog of the reference's lidar_inertial_odometry_node
    (ros2/sycl_points_ros2/src/lidar_inertial_odometry_node.cpp): IMU
    messages interleave with scans on one connection, the pipelined LIO
    backend dispatches frames, and every published pose must carry the
    CLIENT's scan seq and track that scan's ground-truth position."""
    from tests.test_lidar_inertial_odometry import (
        G, lio_params, make_world, scan_at,
    )

    world = make_world()
    v = np.array([2.0, 0.0, 0.0], np.float32)
    frame_dt, n_frames = 0.1, 5

    server = OdometryStreamServer(
        lio_params(),
        StreamServerConfig(pipeline="lio_pipelined", scan_capacity=1 << 11,
                           scan_queue_depth=16),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        # IMU backlog before the first scan (initial alignment), then a
        # 200 Hz stream interleaved ahead of each scan — wire order on one
        # socket preserves feed order into the pipeline
        imu_t = -0.2
        scan_seqs = []  # message seq of each sent scan (IMU shares the
        scan_x = {}     # wire counter, so scan seqs are NOT 1..n)
        for i in range(n_frames):
            t_scan = i * frame_dt
            while imu_t <= t_scan + 1e-9:
                client.send_imu(10.0 + imu_t, gyro=[0.0, 0.0, 0.0],
                                accel=[0.0, 0.0, G])
                imu_t += 1.0 / 200
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = v * t_scan
            seq = client.send_cloud({"points": scan_at(world, T)},
                                    timestamp=10.0 + t_scan)
            scan_seqs.append(seq)
            scan_x[seq] = float(T[0, 3])
            time.sleep(0.05)
        tail = client.finish()
        pose_msgs = [m for m in getattr(client, "side_messages", []) + tail
                     if m.msg_type == sp.MSG_POSE]
        decoded = [sp.decode_pose_payload(m.payload) for m in pose_msgs]
        # scan 1 bootstraps; every later scan's pose arrives (flush drains
        # the in-flight window) tagged with ITS scan's message seq
        assert [d[0] for d in decoded] == scan_seqs[1:]
        for d in decoded:
            expect_x = scan_x[d[0]]
            assert abs(d[3][0] - expect_x) < 0.12, (
                f"pose seq {d[0]} x={d[3][0]:.3f}, expected ~{expect_x:.2f}"
            )
            assert np.all(np.isfinite(d[3])) and np.all(np.isfinite(d[4]))
        tele = server.telemetry()
        assert tele["scan_queue_dropped"] == 0
        assert tele["imu_queue_dropped"] == 0
        assert server.frames_processed == n_frames
    finally:
        server.stop()


def test_imu_routing_reaches_pipeline():
    """IMU messages are queued by the reader and fed to the pipeline in
    arrival order before the next scan (transport-level check; the full LIO
    math has its own suite)."""
    server = OdometryStreamServer(
        _small_params(iters=2),
        StreamServerConfig(pipeline="lo", scan_capacity=1 << 10),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        for i in range(10):
            client.send_imu(0.01 * i, gyro=[0, 0, 0.1], accel=[0, 0, 9.81])
        # a scan flushes the IMU queue into the pipeline buffer
        pts = _world(900)
        client.send_cloud({"points": pts}, timestamp=0.2)
        client.recv_pose()
        assert len(server.pipeline.imu_buffer) == 10
        ts = [m.timestamp for m in server.pipeline.imu_buffer]
        assert ts == sorted(ts)
        client.finish()
    finally:
        server.stop()


@pytest.mark.slow
def test_stream_paced_offered_load():
    """Paced-load serving (round-4 verdict ask 2): a fixed-rate publisher at
    a sustainable rate must get EVERY pose with zero QoS drops and bounded
    queue wait — the keep-last-QoS live-node property
    (lidar_odometry_base_node.cpp:21-414).  The r4 bench showed paced load
    wedging while closed-loop was healthy; no test would have caught it."""
    import dataclasses as dc
    import time

    world = _world()
    base = _small_params()
    # map sized to NOT grow during the run: mid-stream growth compiles are a
    # separate concern covered by StreamServerConfig.precompile_growth_capacity;
    # at CPU-test scale a growth stall (~10 s
    # compile on 2 weak cores) would drown the pacing margins being tested
    params = dc.replace(
        base, submap=dc.replace(base.submap, map_capacity=1 << 15)
    )
    server = OdometryStreamServer(
        params,
        StreamServerConfig(pipeline="lo_pipelined", scan_capacity=1 << 12),
    )
    server.start()
    try:
        client = OdometryStreamClient("127.0.0.1", server.port, timeout=900.0)
        n_frames, warmup = 12, 3
        pose_seqs = set()
        got = []

        import threading
        done = threading.Event()

        def receive():
            try:
                while len(pose_seqs) < n_frames - 1:
                    msg = client.recv()
                    if msg is None:
                        return
                    if msg.msg_type == sp.MSG_POSE:
                        d = sp.decode_pose_payload(msg.payload)
                        pose_seqs.add(d[0])
                        got.append(d)
            finally:
                done.set()

        rx = threading.Thread(target=receive, daemon=True)
        rx.start()

        # closed-loop warmup (compiles; depth-4 queue absorbs the burst),
        # then measure the closed-loop rate on one settled frame.  Pipelined
        # backend: pose for seq k arrives while seq k+2 processes; seq 1
        # (bootstrap) never gets a pose.
        for i in range(warmup):
            client.send_cloud({"points": _scan_at(world, [0.2 * i, 0, 0])},
                              timestamp=0.1 * i)
        # the idle force-resolve publishes the in-flight poses once the
        # warmup queue drains (seq 1 = bootstrap, no pose)
        deadline = time.perf_counter() + 600.0
        while 2 not in pose_seqs and time.perf_counter() < deadline:
            time.sleep(0.002)
        assert 2 in pose_seqs, "warmup frames never produced poses"
        t0 = time.perf_counter()
        client.send_cloud({"points": _scan_at(world, [0.2 * warmup, 0, 0])},
                          timestamp=0.1 * warmup)
        want = warmup + 1  # this frame's own pose, via idle resolution
        deadline = time.perf_counter() + 300.0
        while want not in pose_seqs and time.perf_counter() < deadline:
            time.sleep(0.002)
        closed_loop_s = max(time.perf_counter() - t0, 1e-3)

        # offer at HALF the closed-loop rate: comfortably sustainable
        period = 2.0 * closed_loop_s
        t_base = time.perf_counter()
        for j in range(warmup + 1, n_frames):
            target = t_base + (j - warmup) * period
            dt_sleep = target - time.perf_counter()
            if dt_sleep > 0:
                time.sleep(dt_sleep)
            client.send_cloud({"points": _scan_at(world, [0.2 * j, 0, 0])},
                              timestamp=0.1 * j)

        # flush through the server's own thread and collect the tail
        server._flushed.clear()
        server._flush_requested.set()
        server._wake.set()
        assert server._flushed.wait(timeout=300.0)
        done.wait(timeout=300.0)

        tele = server.telemetry()
        # every scan processed, zero QoS drops at the sustainable rate
        assert tele["scan_queue_dropped"] == 0, tele
        assert tele["frames_processed"] == n_frames, tele
        # pipelined backend: poses for every frame except the bootstrap
        assert pose_seqs.issuperset(set(range(2, n_frames + 1))), sorted(pose_seqs)
        # queue wait bounded: scans must not rot in the queue while the
        # pipeline idles (paced-load wedge signature); generous CPU bound =
        # 4x the closed-loop frame time
        waits = [t["queue_wait_ms"] for t in server.frame_timings
                 if t["seq"] > warmup + 1]
        assert waits and max(waits) < 4000.0 * closed_loop_s + 500.0, (
            waits, closed_loop_s)
    finally:
        server.stop()
