"""Live odometry streaming server — the ROS-less transport equivalent of the
reference's live nodes.

The reference runs LiDAR(-inertial) odometry as ROS2 nodes
(``ros2/sycl_points_ros2/src/lidar_odometry_base_node.cpp:21-414``,
``lidar_inertial_odometry_base_node.cpp``): PointCloud2 + Imu subscriptions
with keep-last QoS queues in, Odometry/TF/map publications out, a base_link
↔ lidar extrinsic, and an initial base_link pose.  This module provides the
same live-serving capability over a plain socket using the framing in
:mod:`sycl_points_tpu.apps.stream_protocol`:

* :class:`OdometryStreamServer` — accepts one client at a time, ingests
  POINTCLOUD/IMU messages on a reader thread into bounded keep-last queues
  (the QoS ``history=keep_last, depth=N`` analog — overflow drops the OLDEST
  message and is *counted*, never silent), and drives any of the four
  pipelines (sync/pipelined × LO/LIO) on a processing thread.  Every
  processed frame emits a POSE message (nav_msgs/Odometry analog: base_link
  pose in the odom frame); STATUS messages carry telemetry; MAP snapshots
  are published on request (flag bit) or every N frames.
* :class:`OdometryStreamClient` — a small blocking client used by tests,
  the replay CLI below, and as the template for user integrations.

Design notes: the transport threads never touch the device —
they only parse bytes into numpy; all device work stays on the single
processing thread so the jit caches and the pipelined in-flight window
behave exactly as in the offline runners.  With a pipelined pipeline the
server overlaps dispatch and the device→host stats transfer across in-flight
frames, so the serving rate is the device rate, not the sync latency.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from sycl_points_tpu.apps import stream_protocol as sp
from sycl_points_tpu.imu.preintegration import IMUMeasurement
from sycl_points_tpu.points.point_cloud import PointCloud, pad_capacity_for
from sycl_points_tpu.utils import lie_np


@dataclasses.dataclass
class StreamServerConfig:
    """Transport-side knobs (the node-parameter analog of
    ``lidar_odometry_base_node.cpp:23-100``: topics → message types, QoS →
    queue depths, extrinsics, initial pose, map publishing)."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = OS-assigned; read server.port after start()
    pipeline: str = "lo"  # lo | lio | lo_pipelined | lio_pipelined
    # QoS history=keep_last depths (points_qos/imu_qos analog)
    scan_queue_depth: int = 4
    imu_queue_depth: int = 4096
    # Static scan capacity tier; None = derived from the first scan.
    scan_capacity: Optional[int] = None
    scan_duration_sec: float = 0.1
    # T_base_link_to_lidar extrinsic + initial base_link pose
    # (lidar_odometry_base_node.cpp:46-80)
    T_base_link_to_lidar: Optional[np.ndarray] = None
    initial_base_link_pose: Optional[np.ndarray] = None
    # Map snapshot publishing: every N processed frames (0 = only on
    # FLAG_WANT_MAP requests).
    publish_map_every: int = 0
    # Send a STATUS telemetry message every N processed frames (0 = never).
    status_every: int = 0
    # Warm the map-growth program ladder up to this capacity right after the
    # first processed frame (background thread).  Growth events otherwise
    # compile 10+ s programs MID-STREAM, which a paced publisher experiences
    # as QoS drops (the r4 10 Hz wedge class of failure); 0 = off.
    precompile_growth_capacity: int = 0


# ResultType enums (LO + LIO, string-valued) -> wire result codes.
RESULT_CODES = {
    "success": 0,
    "first_frame": 1,
    "waiting_initial_alignment": 2,
    "error": 3,
    "old_timestamp": 4,
    "small_number_of_points": 5,
    "imu_only": 6,
}


def result_code(rtype) -> int:
    return RESULT_CODES.get(getattr(rtype, "value", str(rtype)), 255)


class _KeepLastQueue:
    """Bounded FIFO with ROS keep-last semantics: push beyond depth drops the
    oldest element and increments ``dropped`` (counted, never silent)."""

    def __init__(self, depth: int):
        self._dq: Deque = deque()
        self._depth = int(depth)
        self._lock = threading.Lock()
        self.dropped = 0

    def push(self, item) -> None:
        with self._lock:
            if len(self._dq) >= self._depth:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(item)

    def pop(self):
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def drain(self) -> List:
        with self._lock:
            items = list(self._dq)
            self._dq.clear()
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


def _make_pipeline(kind: str, params):
    kind = kind.lower()
    if kind == "lo":
        from sycl_points_tpu.pipeline.lidar_odometry import LidarOdometry

        return LidarOdometry(params)
    if kind == "lio":
        from sycl_points_tpu.pipeline.lidar_inertial_odometry import (
            LidarInertialOdometry,
        )

        return LidarInertialOdometry(params)
    if kind == "lo_pipelined":
        from sycl_points_tpu.pipeline.pipelined_odometry import (
            PipelinedLidarOdometry,
        )

        return PipelinedLidarOdometry(params)
    if kind == "lio_pipelined":
        from sycl_points_tpu.pipeline.pipelined_lio import (
            PipelinedLidarInertialOdometry,
        )

        return PipelinedLidarInertialOdometry(params)
    raise ValueError(f"unknown pipeline kind {kind!r}")


class OdometryStreamServer:
    """Socket front-end around one odometry pipeline instance."""

    def __init__(self, params=None, config: StreamServerConfig = StreamServerConfig()):
        self.config = config
        if params is None:
            if "lio" in config.pipeline:
                from sycl_points_tpu.pipeline.params import (
                    LidarInertialOdometryParams,
                )

                params = LidarInertialOdometryParams()
            else:
                from sycl_points_tpu.pipeline.params import LidarOdometryParams

                params = LidarOdometryParams()

        # extrinsic + initial pose handling (base_node.cpp:46-80): the
        # pipeline runs in the LIDAR frame; poses are published for base_link.
        self.T_bl = (
            np.asarray(config.T_base_link_to_lidar, np.float32)
            if config.T_base_link_to_lidar is not None
            else np.eye(4, dtype=np.float32)
        )
        self.T_lb = np.linalg.inv(self.T_bl).astype(np.float32)
        if config.initial_base_link_pose is not None:
            from sycl_points_tpu.pipeline.params import PoseParams

            T0 = (
                np.asarray(config.initial_base_link_pose, np.float32) @ self.T_bl
            )
            params = dataclasses.replace(
                params, pose=PoseParams(initial=tuple(T0.ravel().tolist()))
            )

        self.params = params
        self.pipeline = _make_pipeline(config.pipeline, params)
        self.is_pipelined = hasattr(self.pipeline, "pose_log")
        self._published_poses = 0

        self._scan_q = _KeepLastQueue(config.scan_queue_depth)
        self._imu_q = _KeepLastQueue(config.imu_queue_depth)
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._client: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._wake = threading.Event()
        self.port: Optional[int] = None
        self.frames_processed = 0
        self.frames_truncated_points = 0
        self.last_error = ""
        self._scan_cap = config.scan_capacity
        self._want_map_seqs: Deque[int] = deque()
        self._result_by_seq: Dict[int, int] = {}
        self._flush_requested = threading.Event()
        self._flushed = threading.Event()
        # pipelined pipelines log poses by internal frame index; map those
        # back to the client's scan seq so POSE.frame_seq always answers
        # "which scan is this the pose of"
        self._seq_by_frame: Dict[int, int] = {}
        self._last_frame_count = 0
        # per-frame serving breakdown (seq -> dict), bounded; the
        # measurement the r4 paced-load wedge lacked: where each scan's
        # wall time went (queue wait vs process vs publish lag)
        self.frame_timings: Deque[Dict] = deque(maxlen=512)
        self._emit_t: Dict[int, float] = {}
        self._arr_t: Dict[int, float] = {}
        # server-side e2e (scan arrival -> pose emit) per seq; valid for
        # BOTH backends (the pipelined pose emits frames later than its scan)
        self.pose_e2e_ms: Deque[float] = deque(maxlen=512)
        self._growth_warmed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.config.host, self.config.port))
        self._listener.listen(1)
        self.port = self._listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, name="spt-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._process_loop, name="spt-process",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        for s in (self._client, self._listener):
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=timeout)

    # -- socket side -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._client = client
            try:
                self._reader(client)
            except (sp.ProtocolError, OSError) as e:
                self.last_error = f"reader: {e}"
            finally:
                if self._client is client:
                    self._client = None
                try:
                    client.close()
                except OSError:
                    pass

    def _reader(self, client: socket.socket) -> None:
        while not self._stop.is_set():
            msg = sp.read_message(client)
            if msg is None:
                return
            if msg.msg_type == sp.MSG_BYE:
                # end-of-stream handshake: flush the in-flight window, then
                # acknowledge with BYE so the client knows all poses arrived
                self._flushed.clear()
                self._flush_requested.set()
                self._wake.set()
                self._flushed.wait(timeout=120.0)
                self._send(sp.Message(msg_type=sp.MSG_BYE, seq=0,
                                      timestamp=0.0, payload=b""))
                return
            if msg.msg_type == sp.MSG_POINTCLOUD:
                self._scan_q.push((msg, time.perf_counter()))
                self._wake.set()
            elif msg.msg_type == sp.MSG_IMU:
                self._imu_q.push(msg)
            # anything else from a client is ignored (forward compatible)

    def _send(self, msg: sp.Message) -> None:
        client = self._client
        if client is None:
            return
        try:
            with self._send_lock:
                sp.write_message(client, msg)
        except OSError as e:
            self.last_error = f"send: {e}"

    # -- processing side ---------------------------------------------------------
    def _process_loop(self) -> None:
        while not self._stop.is_set():
            item = self._scan_q.pop()
            if item is None:
                if self.is_pipelined:
                    # Idle with frames in flight: force-resolve the oldest
                    # with a blocking fetch, so a client that waits for a
                    # pose before sending the next scan is never left
                    # waiting on a frame that already finished.  No scan is
                    # queued, so the blocking fetch delays nothing.
                    resolver = getattr(self.pipeline, "resolve_oldest", None)
                    if resolver is not None:
                        resolver()
                    # then publish everything resolved so far
                    self._drain_pipelined()
                if self._flush_requested.is_set() and not self._flushed.is_set():
                    self.flush()
                    self._send_status(self.telemetry())
                    self._flushed.set()
                    self._flush_requested.clear()
                self._wake.wait(timeout=0.01)
                self._wake.clear()
                continue
            msg, t_arrival = item
            self._arr_t[msg.seq] = t_arrival
            if len(self._arr_t) > 1024:
                for k in sorted(self._arr_t)[:-512]:
                    self._arr_t.pop(k, None)
            try:
                t_deq = time.perf_counter()
                self._process_scan(msg)
                t_done = time.perf_counter()
                self.frame_timings.append({
                    "seq": msg.seq,
                    "queue_wait_ms": round((t_deq - t_arrival) * 1e3, 2),
                    "process_ms": round((t_done - t_deq) * 1e3, 2),
                    "emit_lag_ms": (
                        round((self._emit_t[msg.seq] - t_done) * 1e3, 2)
                        if msg.seq in self._emit_t else None
                    ),
                    "queue_len_after": len(self._scan_q),
                    "stage_ms": {
                        k: round(v * 1e3, 2) for k, v in dict(
                            getattr(self.pipeline, "processing_times", {}) or {}
                        ).items()
                    },
                })
            except Exception as e:  # serving must survive a bad frame
                self.last_error = f"process: {type(e).__name__}: {e}"
                self._send_status({"error": self.last_error, "seq": msg.seq})

    def _feed_imu(self) -> None:
        for imu_msg in self._imu_q.drain():
            gyro, accel = sp.decode_imu_payload(imu_msg.payload)
            self.pipeline.add_imu_measurement(
                IMUMeasurement(timestamp=imu_msg.timestamp, gyro=gyro,
                               accel=accel)
            )

    def _process_scan(self, msg: sp.Message) -> None:
        cloud_np = sp.payload_to_cloud(msg.payload)
        pts = cloud_np["points"]
        n = len(pts)
        if self._scan_cap is None:
            self._scan_cap = pad_capacity_for(max(n, 1))
        if n > self._scan_cap:
            # capacity-tier overflow: drop the tail, COUNT it, tell the client
            self.frames_truncated_points += 1
            self._send_status(
                {"seq": msg.seq, "truncated_points": n - self._scan_cap,
                 "scan_capacity": self._scan_cap}
            )
            cloud_np = {k: v[: self._scan_cap] for k, v in cloud_np.items()}
            pts = cloud_np["points"]
        cloud = PointCloud.from_numpy(
            pts,
            intensities=cloud_np.get("intensities"),
            rgb=cloud_np.get("rgb"),
            timestamp_offsets=cloud_np.get("timestamp_offsets"),
            capacity=self._scan_cap,
        )

        self._feed_imu()
        if msg.flags & sp.FLAG_WANT_MAP:
            self._want_map_seqs.append(msg.seq)
        rtype = self.pipeline.process(
            cloud, msg.timestamp,
            scan_duration_sec=self.config.scan_duration_sec,
        )
        self.frames_processed += 1
        if (
            self.config.precompile_growth_capacity
            and not self._growth_warmed
            and self.frames_processed >= 2
        ):
            # one frame has been dispatched -> the ladder knows its shapes;
            # compile every growth tier in the background so a mid-stream
            # growth swaps in ready programs instead of stalling the queue
            self._growth_warmed = True
            try:
                self.pipeline.precompile_growth(
                    self.config.precompile_growth_capacity, wait=False
                )
            except (AttributeError, RuntimeError) as e:
                self.last_error = f"precompile_growth: {e}"
        self._result_by_seq[msg.seq] = result_code(rtype)
        if self.is_pipelined:
            fc = self.pipeline.frame_count
            if fc > self._last_frame_count:  # a frame was dispatched
                self._seq_by_frame[fc - 1] = msg.seq
                self._last_frame_count = fc

        if self.is_pipelined:
            self._drain_pipelined()
        else:
            T = self.pipeline.get_odometry()
            inlier = float(getattr(self.pipeline, "_prev_inlier", 0))
            self._emit_pose(msg.seq, msg.timestamp, T, result_code(rtype),
                            inlier)
        self._maybe_publish_map()
        if (
            self.config.status_every
            and self.frames_processed % self.config.status_every == 0
        ):
            self._send_status(self.telemetry())

    def _drain_pipelined(self) -> None:
        log = self.pipeline.pose_log
        while self._published_poses < len(log):
            frame_index, ts, T_np, rtype = log[self._published_poses]
            self._published_poses += 1
            seq = self._seq_by_frame.pop(frame_index, frame_index)
            self._emit_pose(seq, ts, T_np, result_code(rtype), 0.0)

    def _emit_pose(self, seq: int, ts: float, T_lidar: np.ndarray,
                   result_code: int, inlier: float) -> None:
        now = time.perf_counter()
        self._emit_t[seq] = now
        if len(self._emit_t) > 1024:
            for k in sorted(self._emit_t)[:-512]:
                self._emit_t.pop(k, None)
        arr = self._arr_t.get(seq)
        if arr is not None:
            self.pose_e2e_ms.append(round((now - arr) * 1e3, 2))
        T_base = np.asarray(T_lidar, np.float32) @ self.T_lb
        q = lie_np.matrix_to_quat(T_base[:3, :3])
        self._send(
            sp.Message(
                msg_type=sp.MSG_POSE, seq=seq, timestamp=ts,
                payload=sp.encode_pose_payload(
                    seq, result_code, inlier, T_base[:3, 3], q
                ),
            )
        )

    def _maybe_publish_map(self) -> None:
        want = False
        if self._want_map_seqs:
            self._want_map_seqs.clear()
            want = True
        if (
            self.config.publish_map_every
            and self.frames_processed % self.config.publish_map_every == 0
        ):
            want = True
        if not want:
            return
        submap = getattr(self.pipeline, "submap", None)
        if submap is None or submap.submap_cloud is None:
            return
        sc = submap.submap_cloud
        mask = np.asarray(sc.mask)
        pts = np.asarray(sc.points)[mask]
        cloud: Dict[str, np.ndarray] = {"points": pts.astype(np.float32)}
        if sc.intensities is not None:
            cloud["intensities"] = np.asarray(sc.intensities)[mask]
        self._send(
            sp.Message(
                msg_type=sp.MSG_MAP, seq=self.frames_processed,
                timestamp=time.time(),
                payload=sp.cloud_to_payload(cloud),
            )
        )

    def _send_status(self, status: Dict) -> None:
        self._send(
            sp.Message(
                msg_type=sp.MSG_STATUS, seq=self.frames_processed,
                timestamp=time.time(),
                payload=sp.encode_status_payload(status),
            )
        )

    def telemetry(self) -> Dict:
        timings = list(self.frame_timings)

        def agg(key):
            vals = [t[key] for t in timings if t.get(key) is not None]
            if not vals:
                return None
            return {
                "median": round(float(np.median(vals)), 2),
                "p90": round(float(np.percentile(vals, 90)), 2),
                "max": round(float(np.max(vals)), 2),
            }

        return {
            "frames_processed": self.frames_processed,
            "scan_queue_dropped": self._scan_q.dropped,
            "imu_queue_dropped": self._imu_q.dropped,
            "frames_truncated_points": self.frames_truncated_points,
            "processing_times": dict(
                getattr(self.pipeline, "processing_times", {}) or {}
            ),
            # serving breakdown over the recent window (the r4 wedge had no
            # way to see WHERE offered-load latency accrued)
            "queue_wait_ms": agg("queue_wait_ms"),
            "process_ms": agg("process_ms"),
            "pose_e2e_server_ms": (
                {
                    "median": round(float(np.median(self.pose_e2e_ms)), 2),
                    "p90": round(float(np.percentile(self.pose_e2e_ms, 90)), 2),
                    "max": round(float(np.max(self.pose_e2e_ms)), 2),
                }
                if self.pose_e2e_ms else None
            ),
            "last_error": self.last_error,
        }

    def flush(self) -> None:
        """Drain the pipelined in-flight window and publish remaining poses."""
        if self.is_pipelined:
            self.pipeline.flush()
            self._drain_pipelined()


class OdometryStreamClient:
    """Blocking client: sends scans/IMU, receives poses/maps/status."""

    def __init__(self, host: str, port: int, timeout: float = 600.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0

    def close(self) -> None:
        try:
            sp.write_message(
                self.sock,
                sp.Message(msg_type=sp.MSG_BYE, seq=self._seq, timestamp=0.0,
                           payload=b""),
            )
        except OSError:
            pass
        self.sock.close()

    def finish(self) -> list:
        """Graceful end-of-stream: send BYE, collect every remaining message
        (late pipelined poses, final STATUS) until the server's BYE ack, then
        close.  Returns the collected messages."""
        sp.write_message(
            self.sock,
            sp.Message(msg_type=sp.MSG_BYE, seq=self._seq, timestamp=0.0,
                       payload=b""),
        )
        tail = []
        while True:
            msg = self.recv()
            if msg is None or msg.msg_type == sp.MSG_BYE:
                break
            tail.append(msg)
        self.sock.close()
        return tail

    def send_cloud(self, cloud: Dict[str, np.ndarray], timestamp: float,
                   want_map: bool = False) -> int:
        self._seq += 1
        sp.write_message(
            self.sock,
            sp.Message(
                msg_type=sp.MSG_POINTCLOUD, seq=self._seq, timestamp=timestamp,
                payload=sp.cloud_to_payload(cloud),
                flags=sp.FLAG_WANT_MAP if want_map else 0,
            ),
        )
        return self._seq

    def send_imu(self, timestamp: float, gyro: np.ndarray,
                 accel: np.ndarray) -> None:
        self._seq += 1
        sp.write_message(
            self.sock,
            sp.Message(
                msg_type=sp.MSG_IMU, seq=self._seq, timestamp=timestamp,
                payload=sp.encode_imu_payload(gyro, accel),
            ),
        )

    def recv(self) -> Optional[sp.Message]:
        return sp.read_message(self.sock)

    def recv_pose(self) -> Tuple[int, int, float, np.ndarray, np.ndarray]:
        """Block until the next POSE message; returns its decoded payload
        (frame_seq, result_code, inlier, t[3], q_xyzw[4]).  Non-pose
        messages received meanwhile are stored in :attr:`side_messages`."""
        if not hasattr(self, "side_messages"):
            self.side_messages: List[sp.Message] = []
        while True:
            msg = self.recv()
            if msg is None:
                raise ConnectionError("server closed the stream")
            if msg.msg_type == sp.MSG_POSE:
                return sp.decode_pose_payload(msg.payload)
            self.side_messages.append(msg)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Live odometry streaming server (ROS-less transport)"
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7510)
    ap.add_argument("--pipeline", default="lo",
                    choices=["lo", "lio", "lo_pipelined", "lio_pipelined"])
    ap.add_argument("--config", default=None, help="YAML parameter file")
    ap.add_argument("--scan-capacity", type=int, default=None)
    ap.add_argument("--publish-map-every", type=int, default=0)
    ap.add_argument("--status-every", type=int, default=0)
    args = ap.parse_args(argv)

    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    params = None
    if args.config:
        from sycl_points_tpu.pipeline.params import load_params

        if "lio" in args.pipeline:
            from sycl_points_tpu.pipeline.params import (
                LidarInertialOdometryParams as _cls,
            )
        else:
            from sycl_points_tpu.pipeline.params import LidarOdometryParams as _cls
        params = load_params(args.config, _cls)

    cfg = StreamServerConfig(
        host=args.host, port=args.port, pipeline=args.pipeline,
        scan_capacity=args.scan_capacity,
        publish_map_every=args.publish_map_every,
        status_every=args.status_every,
    )
    server = OdometryStreamServer(params, cfg)
    server.start()
    print(f"odometry stream server on {cfg.host}:{server.port} "
          f"pipeline={cfg.pipeline}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
