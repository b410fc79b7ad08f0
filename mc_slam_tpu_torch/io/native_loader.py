"""ctypes bindings for the native C++ EuRoC loader (native/euroc_loader.cc);
a copy of mc_slam_tpu/io/native_loader.py that loads the same shared library.

The native loader decodes PNGs and slices IMU on a background thread so the
SLAM loop's host-side cost is a memcpy. Where the library is not built,
`available()` is False and callers read with the pure-Python `io.euroc`.

Build: `make -C native` (requires g++ and zlib).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libeuroc_loader.so")
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
        lib.el_open.restype = ctypes.c_void_p
        lib.el_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.el_num_frames.argtypes = [ctypes.c_void_p]
        lib.el_width.argtypes = [ctypes.c_void_p]
        lib.el_height.argtypes = [ctypes.c_void_p]
        lib.el_frame_time.restype = ctypes.c_double
        lib.el_frame_time.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.el_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.el_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return os.path.exists(_LIB_PATH)


class NativeEurocLoader:
    """Iterates (t_frame, image (H, W), imu (N, 7) float32 [gyro, acc, dt]);
    the image is uint8 (EuRoC PNGs are 8-bit gray: lossless, a quarter of the
    upload) or, with uint8=False, float32."""

    def __init__(self, mav0_path: str, n_prefetch: int = 4, imu_cap: int = 64,
                 uint8: bool = True):
        lib = _load()
        self._lib = lib
        self._h = lib.el_open(mav0_path.encode(), n_prefetch)
        if not self._h:
            raise RuntimeError(f"native loader failed to open {mav0_path}")
        self.n_frames = lib.el_num_frames(self._h)
        self.width = lib.el_width(self._h)
        self.height = lib.el_height(self._h)
        self._imu_cap = imu_cap
        self._img = np.empty((self.height, self.width), np.float32)
        self._imu = np.empty((imu_cap, 7), np.float32)
        self._idx = 0
        self._uint8 = uint8

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        n = self._lib.el_next(self._h, self._img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              self._imu.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              self._imu_cap)
        if n == -1:
            self.close()
            raise StopIteration
        if n == -2:
            raise RuntimeError(f"PNG decode failed at frame {self._idx}")
        t = self._lib.el_frame_time(self._h, self._idx)
        self._idx += 1
        img = self._img.astype(np.uint8) if self._uint8 else self._img.copy()
        return t, img, self._imu[:n].copy()

    def close(self):
        if self._h is not None:
            self._lib.el_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
