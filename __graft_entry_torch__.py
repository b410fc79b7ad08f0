"""Entry points of the PyTorch port (the counterpart of __graft_entry__.py).

entry() -> (fn, example_args): one local-window VI bundle-adjustment solve
(`ba_vi.vi_ba`, the engine's heart: the reference's LocalBAPRVIDP hot path)
on a synthetic EuRoC-like window; `fn(*example_args)` returns its cost.

dryrun_multichip(n_devices): ONE distributed VI-BA step on an n-shard mesh
(`parallel.dist_ba.dist_schur_solve`: landmark-sharded Schur reduction, one
reduction of the camera system, the reduced solve, the retraction) on small
shapes, plus the edge-sharded pose graph and the sharded chunked GBA. The
mesh's n shards go round the visible CUDA devices (a mesh may name one
device more than once: n shards on one card); device="cpu" puts all n on the
CPU.
"""
from __future__ import annotations


def entry(device=None):
    from mc_slam_tpu_torch.bench_problems import vi_window_problem
    from mc_slam_tpu_torch.solver import ba_vi

    p = vi_window_problem(n_kf=10, n_pts=512, obs_per_kf=256, device=device)

    def fn(ns, pts, obs, edges, free, pt_mask):
        _, _, _, cost, _ = ba_vi.vi_ba(ns, pts, obs, edges, p["cam"], p["ext"], p["gw"], free,
                                       pt_mask, iters=4)
        return cost

    args = (p["ns"], p["pts"], p["obs"], p["edges"], p["free"], p["pt_mask"])
    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    import numpy as np
    import torch

    from mc_slam_tpu_torch import lie
    from mc_slam_tpu_torch.bench_problems import vi_window_problem
    from mc_slam_tpu_torch.parallel import dist_ba, dist_gba, dist_posegraph
    from mc_slam_tpu_torch.solver import ba_chunked, ba_vi, factors, lm, posegraph

    from mc_slam_tpu_torch.device import resolve

    dev = resolve(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        devs = [f"cuda:{i % n_cards}" for i in range(n_devices)]
    else:
        devs = [dev] * n_devices
    mesh = dist_ba.make_mesh(devices=devs)
    dev = mesh.devices[0]
    n_kf, n_pts = 6, 16 * n_devices
    p = vi_window_problem(n_kf=n_kf, n_pts=n_pts, obs_per_kf=n_pts, device=dev)
    cam, ext, gw, edges = p["cam"], p["ext"], p["gw"], p["edges"]
    # observations sorted by landmark, padded to 2 a landmark so the shards
    # own contiguous landmark ranges with equal observation counts
    o = p["obs"]
    order = torch.argsort(o.pt, stable=True)
    o = type(o)(*[None if a is None else a[order] for a in o])
    counts = torch.bincount(o.pt, minlength=n_pts)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(o.pt), device=dev) - first[o.pt]
    keep = slot < 2
    sel = o.pt[keep] * 2 + slot[keep]

    def padded(a, fill=0):
        out = torch.full((n_pts * 2,) + a.shape[1:], fill, dtype=a.dtype, device=dev)
        out[sel] = a[keep]
        return out
    cam_o, uv_o = padded(o.cam), padded(o.uv)
    pt_o = torch.arange(n_pts * 2, device=dev) // 2
    val_o = padded(o.valid)
    ns, pts = p["ns"], p["pts"]
    r, J_pr, J_pt, z = factors.reproj_xyz(cam, ext, ns.P[cam_o], ns.R[cam_o], pts[pt_o], uv_o)
    w = val_o * (z > 0).to(val_o.dtype)
    Jc = torch.zeros(J_pr.shape[:-1] + (ba_vi.DC,), device=dev)
    Jc[..., :6] = J_pr
    obs = lm.Observations(cam=cam_o[:, None], pt=pt_o, Jc=Jc[:, None], Jp=J_pt, r=r, w=w)
    H = torch.zeros((n_kf, ba_vi.DC, n_kf, ba_vi.DC), device=dev)
    g = torch.zeros((n_kf, ba_vi.DC), device=dev)
    prv, bias = ba_vi._imu_edge_factors(ns, edges, gw)
    zero = torch.zeros((), device=dev)
    H, g, _ = lm.accumulate_cam_factors(H, g, zero, prv, p["free"])
    H, g, _ = lm.accumulate_cam_factors(H, g, zero, bias, p["free"])
    dxc, dxp = dist_ba.dist_schur_solve(mesh, obs, H, g, p["free"], p["pt_mask"], 1e-3, n_kf,
                                        ba_vi.DC, n_pts, 3)
    ns2, pts2 = ba_vi.retract_states(ns, dxc), pts + dxp
    assert bool(torch.isfinite(ns2.P).all()), "non-finite pose update"
    assert bool(torch.isfinite(pts2).all()), "non-finite landmark update"

    # the edge-sharded Sim3 pose graph on an 8-keyframe ring
    K = 8
    ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K).astype(np.float32)
    R_gt = lie.so3_exp(torch.as_tensor(np.stack([np.zeros(K), np.zeros(K), ang], 1),
                                       dtype=torch.float32)).to(dev)
    P_gt = torch.as_tensor(np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], 1),
                           dtype=torch.float32, device=dev)
    Rcw = R_gt.transpose(-1, -2)
    tcw = -(Rcw @ P_gt[..., None])[..., 0]
    s_v = torch.ones(K, device=dev)
    ei, ej = torch.arange(0, K - 1, device=dev), torch.arange(1, K, device=dev)
    sm, Rm, tm = posegraph.edge_measurement(s_v[ei], Rcw[ei], tcw[ei], s_v[ej], Rcw[ej],
                                            tcw[ej])
    free = torch.ones(K, device=dev)
    free[0] = 0.0
    gpg = posegraph.Sim3Graph(s=s_v * 1.01, R=Rcw, t=tcw + 0.01, ei=ei, ej=ej, s_m=sm, R_m=Rm,
                              t_m=tm, w=torch.ones(K - 1, device=dev), free=free)
    mesh_e = dist_ba.make_mesh(axis="e", devices=devs)
    _, _, t_d, _ = dist_posegraph.optimize_pose_graph_dist(mesh_e, gpg, iters=5)
    assert bool(torch.isfinite(t_d).all()), "non-finite pose-graph update"

    # the mesh-sharded landmark-chunked whole-map VI GBA
    S = 2 * n_devices
    cobs, _ = ba_chunked.chunk_observations(
        o.cam.cpu().numpy(), o.pt.cpu().numpy(), o.uv.cpu().numpy(),
        o.inv_sigma2.cpu().numpy(), o.valid.cpu().numpy(), n_pts, S, device=dev)
    ns_g, pts_g, _, _ = dist_gba.vi_gba_chunked_sharded(mesh, ns, pts, cobs, edges, cam, ext,
                                                        gw, p["free"], p["pt_mask"], iters=2)
    assert bool(torch.isfinite(ns_g.P).all()), "non-finite sharded-GBA pose"
    assert bool(torch.isfinite(pts_g).all()), "non-finite sharded-GBA points"
