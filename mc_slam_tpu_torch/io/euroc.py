"""EuRoC ASL dataset reader + IMU/image synchronization.

Replaces the reference example's loaders (Examples/Monocular/mono_EuRoC_vins.cc:
LoadImus :274 ns->s conversion, LoadImages :285-330, start-index alignment
:123-145, and the per-frame strict `< t_frame` IMU slicing :165-172 with the
0/ >10 message warnings :182-185).

The port's own copy of mc_slam_tpu/io/euroc.py (numpy only; the port imports nothing of
the JAX package).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class EurocSequence:
    image_times: np.ndarray      # (N,) seconds
    image_paths: list            # N paths
    imu: np.ndarray              # (M, 7) [t, wx, wy, wz, ax, ay, az]


def load_imu_csv(path):
    """mav0/imu0/data.csv -> (M,7) [t_sec, gyro(3), acc(3)]."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(x) for x in line.strip().split(",")]
            rows.append([vals[0] / 1e9] + vals[1:7])
    return np.asarray(rows, np.float64)


def load_image_list(path_csv, img_dir):
    times, paths = [], []
    with open(path_csv) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(",")
            times.append(float(parts[0]) / 1e9)
            paths.append(os.path.join(img_dir, parts[1].strip()))
    return np.asarray(times, np.float64), paths


def load_sequence(root, cam="cam0") -> EurocSequence:
    """root: .../MH_01_easy/mav0"""
    t, p = load_image_list(os.path.join(root, cam, "data.csv"),
                           os.path.join(root, cam, "data"))
    imu = load_imu_csv(os.path.join(root, "imu0", "data.csv"))
    # align start: first image with IMU available before it (the example's :123-145)
    first = np.searchsorted(t, imu[0, 0])
    return EurocSequence(image_times=t[first:], image_paths=p[first:],
                         imu=imu)


def slice_imu_per_frame(seq: EurocSequence):
    """Yield (t_frame, image_path, imu_rows (T,7) [gyro, acc, dt]) — the strict
    `imu.t < t_frame` slicing of the example's main loop (:165-172)."""
    j = 0
    imu = seq.imu
    prev_t = None
    for t_frame, path in zip(seq.image_times, seq.image_paths):
        k = j
        while k < len(imu) and imu[k, 0] < t_frame:
            k += 1
        chunk = imu[j:k]
        rows = np.zeros((len(chunk), 7), np.float32)
        if len(chunk):
            ts = chunk[:, 0]
            t0 = prev_t if prev_t is not None else ts[0]
            dts = np.diff(np.concatenate([[t0], ts]))
            rows[:, 0:3] = chunk[:, 1:4]
            rows[:, 3:6] = chunk[:, 4:7]
            rows[:, 6] = np.maximum(dts, 0.0)
            prev_t = ts[-1]
        j = k
        yield t_frame, path, rows


def load_gray_image(path):
    """Decode a grayscale PNG without OpenCV (pure python/numpy zlib decode
    would be slow; use PIL if available, else imageio)."""
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"), np.float32)
    except ImportError:
        import imageio.v3 as iio
        img = iio.imread(path)
        if img.ndim == 3:
            img = img.mean(axis=2)
        return img.astype(np.float32)


def load_depth_image(path, scale=5000.0):
    """Decode a 16-bit depth PNG (TUM-RGBD convention: millimeter-scale
    uint16, factor 5000 per meter) to metric float32 WITHOUT the 8-bit
    conversion that load_gray_image applies."""
    try:
        from PIL import Image
        d = np.asarray(Image.open(path), np.float32)
    except ImportError:
        import imageio.v3 as iio
        d = iio.imread(path).astype(np.float32)
    return d / scale
