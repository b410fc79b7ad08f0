"""Live streaming surface: frame callback with back-pressure (port of
mc_slam_tpu/io/stream.py).

The reference's live path is a ROS node that subscribes to image / IMU
topics and back-pressures the bag iterator on LocalMapping's queue
(Examples/ROS/VIO/src/ros_vio.cpp:156-166, bLocalMapAcceptKF). What is in
flight depends on the system's mode (pipeline/system.py): in the frame loop
(`LAG_MAX` or `PAIR` above 1) it is the dispatched entries whose decisions
are still to come, as in the JAX package; in the synchronous mode it is a
frame while its `track` call runs. The contract:

  * `on_frame(t, img, imu)` is the source callback (camera, socket,
    bag iterator). It does not queue: when the system is saturated the
    frame is dropped and its IMU rows are CARRIED into the next processed
    frame, keeping preintegration continuous across drops (dropping IMU
    would corrupt the keyframe chain the way a real sensor gap does).
  * `accepting()` mirrors bLocalMapAcceptKF for sources that can pause
    (rosbag-style iterators) instead of dropping.
  * `finish()` drains: every frame in flight is decided.
  * The rows handed to one frame are capped at the system's
    `cfg.max_imu_per_kf` (the newest kept, where the JAX package's frame
    programs cut), and the rows cut are counted in `n_imu_cut` instead of
    vanishing silently.
"""
from __future__ import annotations

import threading

import numpy as np


class StreamDriver:
    """Wraps a SlamSystem for push-style frame delivery with back-pressure.

    budget: entries tolerated in flight beyond the system's own depth before
    frames are dropped: beyond LAG_MAX pending entries in the frame loop,
    beyond the one `track` call of the synchronous mode (there a budget lets
    that many callers wait for the system instead)."""

    DEPTH = 1           # frames the synchronous mode holds in flight (one track call)

    def __init__(self, slam, budget: int = 0):
        self.slam = slam
        self.budget = int(budget)
        self._imu_carry: list[np.ndarray] = []
        self._lock = threading.Lock()
        self._track_lock = threading.Lock()
        self.in_flight = 0
        self.n_dropped = 0
        self.n_processed = 0
        self.n_imu_cut = 0

    def accepting(self) -> bool:
        """True when the system can take a frame now (the bLocalMapAcceptKF
        analog for pausable sources): fewer pending entries than LAG_MAX plus
        the budget in the frame loop, fewer `track` calls running than DEPTH
        plus the budget in the synchronous mode."""
        if self.slam.async_loop:
            return len(self.slam.fl.pendings) < self.slam.LAG_MAX + self.budget
        return self.in_flight < self.DEPTH + self.budget

    def on_frame(self, t, img, imu=None) -> bool:
        """Deliver one frame from the live source. Returns True if the frame
        was tracked, False if it was dropped (its IMU is kept)."""
        with self._lock:
            if imu is not None and len(imu):
                self._imu_carry.append(np.asarray(imu, np.float32))
            if not self.accepting():
                self.n_dropped += 1
                return False
            rows = np.concatenate(self._imu_carry, 0) if self._imu_carry else None
            self._imu_carry = []
            cap = self.slam.cfg.max_imu_per_kf
            if rows is not None and len(rows) > cap:
                self.n_imu_cut += len(rows) - cap
                rows = rows[-cap:]
            self.in_flight += 1
        try:
            with self._track_lock:
                self.slam.track(self.slam.upload(img), t, imu=rows)
        finally:
            with self._lock:
                self.in_flight -= 1
        self.n_processed += 1
        return True

    def finish(self):
        """End of stream: drain the frame loop and bring the recorded state
        up to date (`SlamSystem.flush`)."""
        self.slam.flush()
