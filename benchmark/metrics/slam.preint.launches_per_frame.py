"""Device operations a frame launched inside the span "imu.preintegrate": the
VI frame's preintegration of its IMU rows and its IMU prediction, in the
traced window."""
from benchmark.metrics import _slam_spans


def read(trace):
    return _slam_spans.read(trace, "imu.preintegrate", "launches", "frame")
