"""Representative synthetic problems for compile-free checks and timing (port
of mc_slam_tpu/bench_problems.py): the EuRoC-scale local-window VI BA built
from deterministic numpy, the same draws in the same order as the JAX
function, so a seed gives both packages the same problem. No dataset needed.
"""
from __future__ import annotations

import numpy as np
import torch

from mc_slam_tpu_torch import lie
from mc_slam_tpu_torch.camera import euroc_camera
from mc_slam_tpu_torch.device import resolve
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import euroc_noise, preintegrate_batch
from mc_slam_tpu_torch.solver import ba_vi, ba_vi_idp, factors
from mc_slam_tpu_torch.solver.ba import VisualObs


def vi_window_problem(n_kf=20, n_pts=2048, obs_per_kf=512, seed=0, device=None):
    """EuRoC-scale sliding-window VI BA problem (LocalWindowSize 20,
    config/euroc.yaml:47; ~1000 features a frame), float32 on `device`."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    cam = euroc_camera(device=dev)
    ext = factors.identity_extrinsics(device=dev)
    gw = t([0.0, 0.0, -9.81])

    pts = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                    rng.uniform(4, 12, n_pts)], 1).astype(np.float32)
    P = np.stack([np.linspace(-2, 2, n_kf), 0.1 * rng.normal(size=n_kf),
                  0.05 * rng.normal(size=n_kf)], 1).astype(np.float32)
    phis = (rng.normal(size=(n_kf, 3)) * 0.05).astype(np.float32)
    R = lie.so3_exp(torch.from_numpy(phis)).numpy()
    V = np.gradient(P, axis=0) / 0.25
    z3 = torch.zeros((n_kf, 3), device=dev)
    ns = NavState(P=t(P), V=t(V), R=t(R), bg=z3, ba=z3.clone(), dbg=z3.clone(), dba=z3.clone())

    # observations: obs_per_kf random points a keyframe with noisy projections
    O = n_kf * obs_per_kf
    cam_i = np.repeat(np.arange(n_kf), obs_per_kf).astype(np.int64)
    pt_i = rng.integers(0, n_pts, size=O).astype(np.int64)
    Pc = np.einsum('oij,oj->oi', np.swapaxes(R[cam_i], 1, 2), pts[pt_i] - P[cam_i])
    z = np.maximum(Pc[:, 2], 0.5)
    uv = np.stack([458.654 * Pc[:, 0] / z + 367.215, 457.296 * Pc[:, 1] / z + 248.375], 1)
    uv += rng.normal(size=uv.shape) * 0.7
    obs = VisualObs(cam=t(cam_i, torch.int64), pt=t(pt_i, torch.int64), uv=t(uv),
                    inv_sigma2=torch.ones(O, device=dev), valid=t(Pc[:, 2] > 0.5))

    # IMU chain: 50 samples a gap at 200 Hz, all gaps in one batched pass
    noise = euroc_noise(device=dev)
    rows = np.zeros((n_kf - 1, 50, 7), np.float32)
    rows[..., 0:3] = rng.normal(size=(n_kf - 1, 50, 3)) * 0.2
    rows[..., 3:6] = rng.normal(size=(n_kf - 1, 50, 3)) * 0.5 + [0, 0, 9.81]
    rows[..., 6] = 0.005
    z3e = torch.zeros(3, device=dev)
    pre = preintegrate_batch(t(rows), z3e, z3e, noise)
    edges = ba_vi.IMUEdges(
        i=torch.arange(0, n_kf - 1, device=dev), j=torch.arange(1, n_kf, device=dev),
        pre=pre, info_prv=factors.imu_prv_info(pre),
        info_bias=factors.bias_rw_info(pre.dT, 2e-5, 5e-3),
        valid=torch.ones(n_kf - 1, device=dev))
    free = torch.ones(n_kf, device=dev)
    free[0] = 0.0
    return dict(ns=ns, pts=t(pts), obs=obs, edges=edges, cam=cam, ext=ext, gw=gw, free=free,
                pt_mask=torch.ones(n_pts, device=dev))


def vi_window_idp_problem(n_kf=20, n_pts=2048, obs_per_kf=512, seed=0, device=None):
    """The same window in the anchored inverse-depth form (LocalBAPRVIDP):
    each landmark anchored to its first observing keyframe."""
    p = vi_window_problem(n_kf, n_pts, obs_per_kf, seed, device)
    dev = p["pts"].device
    obs = p["obs"]
    cam_i = obs.cam.cpu().numpy()
    pt_i = obs.pt.cpu().numpy()
    uv = obs.uv.cpu().numpy()
    anchor = np.full(n_pts, -1, np.int64)
    uv0 = np.zeros((n_pts, 2), np.float32)
    for o in np.argsort(cam_i, kind="stable"):
        if anchor[pt_i[o]] < 0:
            anchor[pt_i[o]] = cam_i[o]
            uv0[pt_i[o]] = uv[o]
    used = anchor >= 0
    anc = torch.as_tensor(np.clip(anchor, 0, n_kf - 1), device=dev)
    rho = ba_vi_idp.xyz_to_idp(p["pts"], p["ns"].P[anc], p["ns"].R[anc],
                               torch.as_tensor(uv0, device=dev), p["cam"], p["ext"])
    keep = used[pt_i] & (cam_i != anchor[pt_i])
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    idp_obs = ba_vi_idp.IDPObs(
        anchor=anc[obs.pt], obs_kf=obs.cam, pt=obs.pt, uv0=t(uv0[pt_i]), uv=obs.uv,
        inv_sigma2=torch.ones(len(pt_i), device=dev), valid=t(keep))
    usedt = t(used)
    return dict(p, idp_obs=idp_obs, rho=torch.where(usedt > 0, rho, 0.1), rho_mask=usedt)
