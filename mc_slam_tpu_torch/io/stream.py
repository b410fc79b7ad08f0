"""Live streaming surface: frame callback with back-pressure (port of
mc_slam_tpu/io/stream.py).

The reference's live path is a ROS node that subscribes to image / IMU
topics and back-pressures the bag iterator on LocalMapping's queue
(Examples/ROS/VIO/src/ros_vio.cpp:156-166, bLocalMapAcceptKF). The port's
`SlamSystem.track` is synchronous: a frame is in flight exactly while a
`track` call runs, so the contract is:

  * `on_frame(t, img, imu)` is the source callback (camera, socket,
    bag iterator). It does not queue: when the system is busy (a frame in
    flight beyond the budget) the frame is dropped and its IMU rows are
    CARRIED into the next processed frame, keeping preintegration continuous
    across drops (dropping IMU would corrupt the keyframe chain the way a
    real sensor gap does).
  * `accepting()` mirrors bLocalMapAcceptKF for sources that can pause
    (rosbag-style iterators) instead of dropping.
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

    budget: frames tolerated in flight beyond the one the synchronous system
    processes (0 = drop whenever a frame is in flight; a budget lets that many
    callers wait for the system instead)."""

    DEPTH = 1           # frames the synchronous system holds in flight

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
        """True when the system can take a frame now: fewer frames in flight
        than its depth plus the budget (the bLocalMapAcceptKF analog for
        pausable sources)."""
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
        """End of stream: bring the recorded state up to date."""
        self.slam.flush()
