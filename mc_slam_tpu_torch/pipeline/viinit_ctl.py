"""VI-initialization control (port of mc_slam_tpu/pipeline/viinit_ctl.py):
the gates of TryInitVIO, the solve, and the application of its result to the
map (LocalMapping.cpp:200-893), as one synchronous module function.
"""
from __future__ import annotations

import math
import time
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from mc_slam_tpu_torch.camera import Camera
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import (IMUNoise, PreintState,
                                                  preintegrate_batch)
from mc_slam_tpu_torch.pipeline import mapping_ctl, viinit
from mc_slam_tpu_torch.slam_map.mapstate import MapState, _set_drop
from mc_slam_tpu_torch.solver import factors

if TYPE_CHECKING:
    from mc_slam_tpu_torch.pipeline.system import SlamConfig


class VIAttempt(NamedTuple):
    """One call of maybe_vi_init. `reason` says which gate let it through or
    stopped it: "time", "keyframes", "same keyframes" (no attempt made),
    "scale", "cond", "agreement" (solved and refused), "accepted"."""
    attempted: bool
    accepted: bool
    reason: str
    n_kf: int = 0
    scale: float = math.nan
    scale_star: float = math.nan
    cond: float = math.nan
    bg: np.ndarray | None = None
    ba: np.ndarray | None = None
    gw: torch.Tensor | None = None           # (3,) device, when accepted
    ba_visual: mapping_ctl.BAStats | None = None
    ba_vi: mapping_ctl.BAStats | None = None


def maybe_vi_init(m: MapState, st: mapping_ctl.MappingState,
                  cfg: SlamConfig, t, cam: Camera, ext: factors.Extrinsics, gw,
                  noise: IMUNoise, traj=None, mark=None, log=None):
    """Try the VI initialization at time t (SlamSystem._maybe_vi_init).

    Gates before the attempt: `vi_init_time` seconds since the first
    keyframe, 8 keyframes, one attempt per new keyframe. The attempt: the
    whole-map visual BA, `viinit.try_init_vio` over the keyframe window
    padded to a multiple of 16 (masked rows), ONE host copy of its result,
    then the acceptance gates (finite positive scale, condition number of
    the step-3 system, agreement of the step-2 and step-3 scales). On
    acceptance: every keyframe's raw IMU rows are integrated again at the
    estimated biases (one batched pass), velocities, NavStates, the map and
    its scale bands and the recorded trajectory are rescaled to metres, and
    the whole-map VI BA runs. Pad rows are never written back.

    traj: the TrajStore to rescale, or None. mark: optional
    callable(stage_name) invoked before "gba_visual", "solve", "repreint",
    "apply", "gba_vi" and "end". log: an optional utils.metrics.VIInitLog that
    receives every solved attempt (one more host copy each). Returns
    (m, VIAttempt); on acceptance
    st.vi_inited is set and the caller continues VI tracking from the newest
    keyframe's NavState with `VIAttempt.gw`, a fresh prior, and the IMU rows
    since that keyframe."""
    mark = mark if mark is not None else (lambda name: None)
    if st.first_kf_time is None or t - st.first_kf_time < cfg.vi_init_time:
        return m, VIAttempt(False, False, "time")
    act = list(st.kf_slots)
    if len(act) < 8:
        return m, VIAttempt(False, False, "keyframes", n_kf=len(act))
    if st.last_init_attempt_nkf == st.n_kf:
        return m, VIAttempt(False, False, "same keyframes", n_kf=len(act))
    st.last_init_attempt_nkf = st.n_kf
    dev = m.mp_pos.device
    # clean the visual map first (TryInitVIO's visual-only global BA)
    t_start = time.perf_counter()
    mark("gba_visual")
    m, ba_visual = mapping_ctl.local_ba(m, st, cfg, cam, ext, gw, noise, force_all=True)
    mark("solve")
    n_real = len(act)
    pad_n = int(math.ceil(n_real / 16)) * 16
    host_rows = np.zeros((2, pad_n), np.float32)
    host_rows[0] = act + [act[-1]] * (pad_n - n_real)
    host_rows[1, 1:n_real] = 1.0
    packed = torch.as_tensor(host_rows, device=dev)         # one host->device copy
    ks, valid = packed[0].to(torch.int64), packed[1]
    # camera poses from the stored body poses
    Rwb, Pwb = m.kf_ns.R[ks], m.kf_ns.P[ks]
    Rbc = ext.Rcb.transpose(-1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    Rwc = Rwb @ Rbc
    Pwc = Pwb + (Rwb @ pbc[..., None])[..., 0]
    pre = PreintState(*[a[ks] for a in m.kf_preint])
    res = viinit.try_init_vio(Pwc, Rwc, pre, valid, ext.Rcb, ext.tcb, g_mag=cfg.g_mag)
    h = torch.cat([res.scale.reshape(1), res.scale_star.reshape(1), res.cond,
                   res.bg, res.ba]).cpu().numpy()           # one device->host copy
    s, s_star, sv, bg_h, ba_h = float(h[0]), float(h[1]), h[2:8], h[8:11], h[11:14]
    cond = float(sv[0] / max(float(sv[-1]), 1e-12))
    if log is not None:
        log.log_attempt(t, res, (time.perf_counter() - t_start) * 1e3)

    def refused(why):
        mark("end")
        return m, VIAttempt(True, False, why, n_real, s, s_star, cond, bg_h, ba_h,
                            ba_visual=ba_visual)

    if not np.isfinite(s) or s <= 1e-3:
        return refused("scale")
    # beyond the time rule: the step-3 system must be well conditioned and its
    # scale must agree with step 2's; otherwise the trajectory has not excited
    # scale and gravity yet and the init would seed a wrong-metric map
    if cond > cfg.vi_init_max_cond:
        return refused("cond")
    if abs(s - s_star) > cfg.vi_init_scale_tol * max(s, 1e-6):
        return refused("agreement")

    # integrate every keyframe's raw rows again, at the estimated biases
    mark("repreint")
    with_raw = [slot for slot in act if slot in st.kf_imu_raw]
    if with_raw:
        T = max(st.kf_imu_raw[slot].shape[0] for slot in with_raw)
        raw = torch.stack([torch.nn.functional.pad(
            st.kf_imu_raw[slot], (0, 0, 0, T - st.kf_imu_raw[slot].shape[0]))
            for slot in with_raw])
        pre1 = preintegrate_batch(raw, res.bg, res.ba, noise)
        kr = torch.as_tensor(np.asarray(with_raw, np.int64), device=dev)
        m = m._replace(kf_preint=PreintState(
            *[a.index_copy(0, kr, b) for a, b in zip(m.kf_preint, pre1)]))
    mark("apply")
    pre2 = PreintState(*[a[ks] for a in m.kf_preint])
    V = viinit.compute_velocities(Pwc, Rwc, pre2, valid, ext.Rcb, ext.tcb, res.scale,
                                  res.gw, res.ba)
    P_b, R_b, V = viinit.apply_init_to_navstates(Pwc, Rwc, ext.Rcb, ext.tcb, res.scale,
                                                 res.bg, res.ba, V)
    ks_real = torch.where(torch.arange(pad_n, device=dev) < n_real, ks, m.K)
    z3 = torch.zeros_like(V)
    rows = NavState(P=P_b, V=V, R=R_b, bg=res.bg.expand(pad_n, 3),
                    ba=res.ba.expand(pad_n, 3), dbg=z3, dba=z3)
    ns = NavState(*[_set_drop(full, ks_real, w) for full, w in zip(m.kf_ns, rows)])
    m = m._replace(kf_ns=ns, mp_pos=m.mp_pos * res.scale,
                   mp_min_dist=m.mp_min_dist * res.scale,
                   mp_max_dist=m.mp_max_dist * res.scale)
    # the recorded per-frame offsets were taken in the visual scale
    if traj is not None:
        traj.rescale(res.scale)
    st.vi_inited = True
    st.covis_row = None        # the caches of the visual map are stale
    st.ref_tracked = None
    # the whole-map VI BA (GlobalBundleAdjustmentNavStatePRV)
    mark("gba_vi")
    m, ba_vi_stats = mapping_ctl.local_ba(m, st, cfg, cam, ext, res.gw, noise,
                                          force_all=True)
    mark("end")
    return m, VIAttempt(True, True, "accepted", n_real, s, s_star, cond, bg_h, ba_h,
                        gw=res.gw, ba_visual=ba_visual, ba_vi=ba_vi_stats)
