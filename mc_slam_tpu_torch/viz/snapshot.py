"""Headless visualization: map / trajectory snapshots and frame overlays
(port of mc_slam_tpu/viz/snapshot.py).

The offline analog of the reference's Pangolin side-car (src/Viewer.cpp,
src/MapDrawer.cpp, src/FrameDrawer.cpp): map points, keyframes, the
covisibility graph, the trajectory and a per-frame feature overlay render to
PNG from a port MapState (pulled to the host once) and a trajectory.
matplotlib is imported inside the functions, so the package does not need it.

Usage:
    from mc_slam_tpu_torch.viz import save_map_snapshot
    save_map_snapshot(slam.m, slam.get_trajectory(), "map.png")
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _covis_edges(m, min_weight=30, max_kf_edges=400):
    """(i, j) strong covisibility pairs from the observation table (a host
    numpy mirror of slam_map.mapstate.covisibility_weights)."""
    kf_mp = _host(m.kf_mp)
    active = _host(m.kf_active)
    K, F = kf_mp.shape
    P = int(_host(m.mp_active).shape[0])
    sees = np.zeros((K, P), np.float32)
    rows = np.repeat(np.arange(K), F)
    cols = kf_mp.reshape(-1)
    ok = (cols >= 0) & _host(m.kf_feat_valid).reshape(-1)
    sees[rows[ok], cols[ok]] = 1.0
    W = sees @ sees.T
    np.fill_diagonal(W, 0)
    W *= active[:, None] * active[None, :]
    ii, jj = np.nonzero(np.triu(W) >= min_weight)
    if len(ii) > max_kf_edges:
        order = np.argsort(-W[ii, jj])[:max_kf_edges]
        ii, jj = ii[order], jj[order]
    return ii, jj


def save_map_snapshot(m, trajectory=None, path="map.png", elev=-70.0, azim=-90.0,
                      covis_min_weight=30, title=None):
    """Render the SLAM map to a PNG: map points (grey), keyframes (blue),
    covisibility graph (green, MapDrawer::DrawKeyFrames), frame trajectory
    (orange). `trajectory`: rows (t, P, ...), as SlamSystem.get_trajectory()
    returns them."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mp_active = _host(m.mp_active)
    pts = _host(m.mp_pos)[mp_active]
    kf_active = _host(m.kf_active)
    allP = _host(m.kf_ns.P)
    kP = allP[kf_active]

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0, c="0.55", alpha=0.35, linewidths=0)
    ii, jj = _covis_edges(m, covis_min_weight)
    for a, b in zip(ii, jj):
        ax.plot(*np.stack([allP[a], allP[b]], 1), c="#2ca02c", lw=0.5, alpha=0.6)
    if len(kP):
        ax.scatter(kP[:, 0], kP[:, 1], kP[:, 2], s=14, c="#1f77b4", depthshade=False,
                   label=f"keyframes ({len(kP)})")
    if trajectory is not None and len(trajectory):
        tp = np.asarray([_host(row[1]) for row in trajectory], np.float64)
        ax.plot(tp[:, 0], tp[:, 1], tp[:, 2], c="#ff7f0e", lw=1.2,
                label=f"trajectory ({len(tp)} frames)")
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    ax.legend(loc="upper left", fontsize=8)
    if title:
        ax.set_title(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_frame_overlay(img, feats_xy, feats_valid, matched_mask=None, path="frame.png",
                         title=None):
    """Per-frame overlay (FrameDrawer::DrawFrame): detected keypoints (green
    rings), map-matched keypoints (filled) over the grayscale image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = _host(img).astype(np.float32)
    xy = _host(feats_xy)
    valid = _host(feats_valid).astype(bool)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 96, img.shape[0] / 96))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    sel = valid
    if matched_mask is not None:
        mm = _host(matched_mask).astype(bool) & valid
        sel = valid & ~mm
        ax.scatter(xy[mm, 0], xy[mm, 1], s=14, facecolors="#2ca02c", edgecolors="none",
                   alpha=0.9)
    ax.scatter(xy[sel, 0], xy[sel, 1], s=12, facecolors="none", edgecolors="#2ca02c",
               linewidths=0.7, alpha=0.8)
    ax.set_axis_off()
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout(pad=0)
    fig.savefig(path, dpi=96)
    plt.close(fig)
    return path
