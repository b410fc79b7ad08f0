"""YAML settings loader (port of mc_slam_tpu/settings.py): ConfigParam /
Tracking-constructor parity (src/IMU/configparam.cpp:20-96,
src/Tracking.cpp:537-649).

Reads the reference's euroc.yaml schema (Camera.*, ORBextractor.*, Tbc,
LocalMapping.LocalWindowSize, test.*) into (Camera, SlamConfig keywords, Tbc).
Unknown keys are ignored; missing keys fall back to EuRoC defaults so the
reference's own config files work unchanged.
"""
from __future__ import annotations

import numpy as np

from mc_slam_tpu_torch.camera import make_camera


def load_settings(path, device=None):
    """Returns (camera on `device`, slam_config_kwargs: dict,
    Tbc: (4, 4) np.ndarray | None)."""
    import yaml
    with open(path) as f:
        text = f.read()
    # the reference files start with "%YAML:1.0" (OpenCV dialect): strip it
    lines = [l for l in text.splitlines()
             if not l.strip().startswith("%YAML") and not l.strip() == "---"]
    # OpenCV matrix nodes (!!opencv-matrix) are not valid YAML tags for pyyaml
    cleaned = "\n".join(l.replace("!!opencv-matrix", "") for l in lines)
    cfg = yaml.safe_load(cleaned) or {}

    g = lambda k, d: cfg.get(k, d)
    cam = make_camera(
        fx=g("Camera.fx", 458.654), fy=g("Camera.fy", 457.296),
        cx=g("Camera.cx", 367.215), cy=g("Camera.cy", 248.375),
        k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0), p2=g("Camera.p2", 0.0), k3=g("Camera.k3", 0.0),
        width=g("Camera.width", 752), height=g("Camera.height", 480), device=device)

    slam_kwargs = dict(
        n_feat=int(g("ORBextractor.nFeatures", 1024)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        local_window=int(g("LocalMapping.LocalWindowSize", 20)),
        vi_init_time=float(g("test.VINSInitTime", 15.0)),
    )
    fps = g("Camera.fps", 20.0)
    slam_kwargs["kf_max_gap"] = int(fps)  # reference: at most 1 s between keyframes

    Tbc = None
    node = cfg.get("Camera.Tbc")
    if isinstance(node, dict) and "data" in node:
        Tbc = np.asarray(node["data"], np.float32).reshape(4, 4)
    elif isinstance(node, list):
        Tbc = np.asarray(node, np.float32).reshape(4, 4)
    return cam, slam_kwargs, Tbc
