"""The asynchronous frame loop (pipeline/frameloop.py) against the JAX
package's (mc_slam_tpu/pipeline/frameloop.py), on the state of
`torch_port_helpers.boot_run()` (BOOT profile: 480x360, K = 16, P = 2048,
F = 512, VI initialized) handed to a JAX SlamSystem with its tracking state,
and on `revisit_run()`'s planted seam for the deferred loop stages.

The frames after boot_run come from the same clone rendered to 130 frames
(its images equal the 106-frame sequence's; its IMU noise is drawn for the
longer span). Both packages see the same feature tables: the port's ORB
extraction hands out the JAX package's (`jax_features`).

Readiness is a rule set on each instance here, never in the packages: the
summaries are never ready (a frame is harvested at exactly the depth limit)
or always ready (harvested at the next call); keyframe events, Sim3 batches
and verifications have always landed (the JAX side forces their harvests).

Tolerances, beside each assertion:
* feature tables exact; per-frame poses 1e-3 m / 1e-3 and the summary counts
  within 1 % (tests/test_torch_slice.py's VI-frame tolerances); the marginal
  prior 1e-2 of its largest entry (its 15 x 15 Hessian sums the same float32
  Jacobian products in another order);
* keyframe frame ids, lost counts and the event log exact; trajectory rows,
  keyframe poses 1e-3 m / 1e-3, velocities 1e-2, landmarks 5e-3 m, the
  association table to 0.2 % (tests/test_torch_kf_event.py's, after a window
  BA), but for landmarks two events in a row part 5 of 771 by up to 1.4 cm:
  the synchronous port and the JAX parity mode do the same on these frames
  (measured on the CPU), so 99 % of the landmarks are held to 5e-3 m and
  every one to 2e-2 m;
* the port's pair against its own single frames, the deferred loop stages
  against the synchronous ones, and the synchronous mode against the parent
  code's digest: bit for bit."""
import collections
import copy
import dataclasses
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mc_slam_tpu.frontend.extractor import Features as JFeatures
from mc_slam_tpu.imu.navstate import NavState as JNavState
from mc_slam_tpu.imu.preintegration import euroc_noise as j_noise
from mc_slam_tpu.pipeline import tracking as jtracking
from mc_slam_tpu.pipeline.pipebase import LOST as JLOST
from mc_slam_tpu.solver import ba_vi as jba_vi
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.io.stream import StreamDriver
from mc_slam_tpu_torch.pipeline import frameloop, loopctl, tracking, tracking_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, OK
from mc_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
from mc_slam_tpu_torch.solver import ba_vi
from mc_slam_tpu_torch.tools import eval_clone

from torch_port_helpers import (BOOT, REVISIT_FRAMES, REVISIT_SRC, boot_run, jax_cam,
                                jax_drift_injector, jax_ext, jax_features, jax_map,
                                jax_samples, jax_system_from_port, revisit_run)

torch.set_num_threads(2)
DIGEST = Path(__file__).with_name("torch_sync_digest.npz")
FIRST = 105                  # the first frame after boot_run's
EVENT_KW = dict(max_new=256, ba_Pw=2048)    # the JAX event's sizes at P = 2048
POS_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def long_seq():
    return chip_smoke.make_sequence(dataclasses.replace(BOOT, n_frames=130), seed=0)


def _port(lag_max, pair, ready=None):
    """A copy of boot_run's system in the given mode; ready: the readiness
    rule of its summaries (None: the copies' own)."""
    slam = copy.deepcopy(boot_run()[3]["slam"])
    slam.event_kw = dict(EVENT_KW)
    slam.LAG_MAX, slam.PAIR = lag_max, pair
    if ready is not None:
        slam._summary_ready = lambda p: ready
    return slam


def _jnav(ns):
    return JNavState(**{k: jnp.asarray(v) for k, v in convert.to_numpy(ns).items()})


def _jax_twin(monkeypatch, slam, lag_max, pair, ready):
    """A JAX SlamSystem holding the port system's map, host state, detector,
    trajectory and tracking state, in the given mode; its deferred stages
    are harvested as soon as asked."""
    ts = slam.ts
    js = jax_system_from_port(monkeypatch, slam.cam, slam.m, slam.st, slam.traj,
                              frame_id=slam.frame_id)
    d = convert.detector_to_dict(slam.loop)
    js.loop.hists, js.loop.hist_ids = jnp.asarray(d["hists"]), d["hist_ids"]
    js.loop.consistent_groups = copy.deepcopy(d["consistent_groups"])
    h = convert.host_state_to_dict(slam.st, ts=ts)
    js.imu_since_kf, js.imu_since_frame = h["imu_since_kf"], h["imu_since_frame"]
    js.gw = jnp.asarray(ts.gw.numpy())
    js.last_ns = _jnav(ts.ns)
    js.last_pose = (jnp.asarray(ts.P.numpy()), jnp.asarray(ts.R.numpy()))
    js.velocity = (jnp.asarray(ts.dP.numpy()), jnp.asarray(ts.dR.numpy()))
    js.prior = None if ts.prior is None else jba_vi.PriorFactor(
        cam=jnp.asarray(0, jnp.int32), ns0=_jnav(ts.prior.ns0),
        info=jnp.asarray(ts.prior.info.numpy()), valid=jnp.asarray(1.0, jnp.float32))
    js._prev_match = ((jnp.asarray(ts.prev_feat_mp.numpy()), jnp.asarray(ts.prev_angle.numpy()))
                      if ts.has_prev else None)
    js._cur_feat_mp = jnp.asarray(ts.prev_feat_mp.numpy())
    js.last_time = ts.last_time
    js._cur_inliers = ts.n_inliers
    js.LAG_MAX, js.PAIR = lag_max, pair
    js._summary_ready = lambda p: ready
    for name in ("_harvest_event", "_harvest_sim3", "_harvest_verify"):
        fn = getattr(js, name)
        setattr(js, name, lambda force=False, fn=fn: fn(force=True))
    return js


def _feed(systems, srcs, blank=None):
    seq = long_seq()
    for i in srcs:
        img = np.zeros_like(seq.imgs[i]) if i == blank else seq.imgs[i]
        for s in systems:
            s.track(img, float(seq.times[i]), seq.imu[i])


def _kf_ids(slam_or_js, st=None):
    ids = slam_or_js.kf_id_host if st is None else st.kf_id_host
    slots = slam_or_js.kf_slots if st is None else st.kf_slots
    return [ids[s] for s in slots]


def _events(events, skip=("kf_culled",)):
    return [(int(f), k) for f, k, _ in events if k not in skip]


def _assert_states_match(js, slam, n_events0):
    """Keyframes, losses and the events since the hand-over (the JAX log
    starts empty there, the port's holds n_events0) exactly; trajectory and
    tables to the keyframe event's tolerances."""
    assert _kf_ids(js) == _kf_ids(slam, slam.st)
    assert js.n_lost_frames == slam.n_lost_frames
    assert _events(js.events) == _events(slam.events[n_events0:])
    ref, got = js.get_trajectory(), slam.get_trajectory()
    assert len(ref) == len(got) > 100
    for (t0, P0, R0), (t1, P1, R1) in zip(ref, got):
        assert t0 == t1
        np.testing.assert_allclose(P1, P0, rtol=0, atol=POS_TOL)        # 1e-3 m
        np.testing.assert_allclose(R1, R0, rtol=0, atol=1e-3)
    jm, tm = jax.tree_util.tree_map(np.asarray, js.m), slam.m
    ks = slam.st.kf_slots
    np.testing.assert_allclose(tm.kf_ns.P.numpy()[ks], jm.kf_ns.P[ks], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_ns.R.numpy()[ks], jm.kf_ns.R[ks], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_ns.V.numpy()[ks], jm.kf_ns.V[ks], rtol=0, atol=1e-2)
    act = jm.mp_active
    np.testing.assert_array_equal(tm.mp_active.numpy(), act)
    d = np.linalg.norm(tm.mp_pos.numpy()[act] - jm.mp_pos[act], axis=1)
    assert np.mean(d <= 5e-3) >= 0.99 and d.max() <= 2e-2, np.sort(d)[-8:]   # see the docstring
    assert (tm.kf_mp.numpy()[ks] != jm.kf_mp[ks]).mean() <= 2e-3      # 0.2 %


# ---------------------------------------------------------------------------
# (a) the pair program
# ---------------------------------------------------------------------------

def _pair_inputs():
    slam = _port(1, 1)
    seq, ts, c = long_seq(), slam.ts, slam._consts
    prior = ts.prior if ts.prior is not None else ba_vi.PriorFactor(
        cam=c.c0, ns0=ts.ns, valid=c.c1, info=c.prior_fresh)
    srcs = (FIRST, FIRST + 1)
    dts = [float(seq.times[i] - seq.times[i - 1]) for i in srcs]
    return slam, seq, prior, srcs, dts


def test_pair_program_matches_jax_and_two_single_frames():
    slam, seq, prior, srcs, dts = _pair_inputs()
    ts, c, cfg = slam.ts, slam._consts, slam.cfg
    anchor = slam.st.last_kf_slot
    kw = dict(sigma_bg=c.sigma_bg, sigma_ba=c.sigma_ba, n_features=cfg.n_feat,
              n_levels=cfg.n_levels, has_prev=ts.has_prev)
    imgs = [torch.from_numpy(seq.imgs[i]) for i in srcs]
    raws = [torch.from_numpy(seq.imu[i]) for i in srcs]
    # the port's pair against two of its own single frames: bit for bit
    frames, Hp, found, vis, summary = tracking.frame_pipeline_vi_pair(
        slam.m, imgs, raws, slam.cam, slam.ext, slam.noise, ts.ns, ts.gw, prior,
        ts.prev_feat_mp, ts.prev_angle, anchor, dts, c.fresh_fb, **kw)
    assert summary.shape == (2, 4) and len(frames) == 2
    m, ns, pr, pfm, pan = slam.m, ts.ns, prior, ts.prev_feat_mp, ts.prev_angle
    for k in range(2):
        out = tracking.frame_pipeline_vi(m, imgs[k], raws[k], slam.cam, slam.ext, slam.noise, ns,
                                         ts.gw, pr, pfm, pan, anchor, dts[k], c.fresh_fb,
                                         **dict(kw, has_prev=ts.has_prev if k == 0 else True))
        feats, uv, ns, pfm, H, m_found, m_vis, traj, s = out
        pr = ba_vi.PriorFactor(cam=c.c0, ns0=ns, info=H, valid=c.c1)
        pan = feats.angle
        m = m._replace(mp_found=m_found, mp_visible=m_vis)
        f_feats, f_uv, f_fmp, f_ns, f_traj = frames[k]
        assert torch.equal(f_fmp, pfm) and torch.equal(summary[k], s)
        for a, b in zip(f_ns, ns):
            assert torch.equal(a, b)
        for a, b in zip(f_traj, traj):
            assert torch.equal(a, b)
    assert torch.equal(Hp, pr.info) and torch.equal(found, m.mp_found)
    assert torch.equal(vis, m.mp_visible)

    # against the JAX program on the same map, images, IMU spans (the JAX
    # frame pads each to max_imu_per_kf rows of zero dt) and prior
    rawp = np.zeros((2, cfg.max_imu_per_kf, 7), np.float32)
    for k, i in enumerate(srcs):
        rawp[k, :len(seq.imu[i])] = seq.imu[i]
    jprior = jba_vi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=_jnav(prior.ns0),
                                info=jnp.asarray(prior.info.numpy()),
                                valid=jnp.asarray(1.0, jnp.float32))
    out_j = jtracking.frame_pipeline_vi_pair(
        jax_map(slam.m), tuple(jnp.asarray(seq.imgs[i]) for i in srcs), jnp.asarray(rawp),
        jax_cam(slam.cam), jax_ext(), j_noise(), _jnav(ts.ns), jnp.asarray(ts.gw.numpy()),
        jprior, jnp.asarray(ts.prev_feat_mp.numpy()), jnp.asarray(ts.prev_angle.numpy()),
        np.int32(anchor), np.asarray(dts, np.float32),
        jnp.asarray(c.fresh_fb.numpy()), **kw)
    frames_j, Hp_j, found_j, vis_j, summary_j = jax.tree_util.tree_map(np.asarray, out_j)
    with jax_features():
        frames_t, Hp_t, found_t, vis_t, summary_t = tracking.frame_pipeline_vi_pair(
            slam.m, imgs, raws, slam.cam, slam.ext, slam.noise, ts.ns, ts.gw, prior,
            ts.prev_feat_mp, ts.prev_angle, anchor, dts, c.fresh_fb, **kw)
    for (fj, _, fmp_j, ns_j, _), (ft, _, fmp_t, ns_t, _), sj, st_ in zip(
            frames_j, frames_t, summary_j, summary_t.numpy()):
        for name in ("level", "valid", "desc_pm1", "angle", "xy"):     # exact
            np.testing.assert_array_equal(getattr(ft, name).numpy(), getattr(fj, name))
        np.testing.assert_allclose(ns_t.P.numpy(), ns_j.P, rtol=0, atol=1e-3)   # 1e-3 m
        np.testing.assert_allclose(ns_t.R.numpy(), ns_j.R, rtol=0, atol=1e-3)
        assert abs(st_[0] - sj[0]) <= max(1.0, 0.01 * sj[0]), (st_, sj)          # 1 %
        assert abs(st_[3] - sj[3]) <= max(1.0, 0.01 * sj[3]), (st_, sj)
        assert st_[1] == sj[1] and st_[2] == sj[2]                    # bias jump, fallback
        either = (fmp_t.numpy() >= 0) | (fmp_j >= 0)
        assert (fmp_t.numpy() == fmp_j)[either].mean() >= 0.99
    np.testing.assert_allclose(Hp_t.numpy(), Hp_j, rtol=0, atol=1e-2 * np.abs(Hp_j).max())
    # found / visible except map slot 0 (F8: the JAX scatter's order)
    np.testing.assert_array_equal(found_t.numpy()[1:], found_j[1:])
    np.testing.assert_array_equal(vis_t.numpy()[1:], vis_j[1:])


# ---------------------------------------------------------------------------
# (b) the loop against the JAX loop; (c) rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ready", [False, True], ids=["at_depth_limit", "lag_one"])
def test_loop_matches_jax_loop(monkeypatch, ready):
    """PAIR 2, LAG_MAX 3, 12 frames, then flush() on both sides."""
    slam = _port(3, 2, ready)
    js = _jax_twin(monkeypatch, slam, 3, 2, ready)
    n_ev = len(slam.events)
    depth = []
    seq = long_seq()
    with jax_features():
        for i in range(FIRST, FIRST + 12):
            for s in (js, slam):
                s.track(seq.imgs[i], float(seq.times[i]), seq.imu[i])
            assert len(js._pendings) == len(slam.fl.pendings)
            assert bool(js._pair_buf) == bool(slam.fl.pair_buf)
            depth.append(len(slam.fl.pendings))
        js.flush()
        slam.flush()
    # never ready: the queue fills to LAG_MAX - 1 after a harvest, then takes
    # the new pair; ready: every pair is harvested at the next call
    assert max(depth) == (3 if not ready else 1)
    assert slam.fl.n_dispatched["vi2"] == 6 and not slam.fl.pendings and not js._pendings
    _assert_states_match(js, slam, n_ev)
    np.testing.assert_allclose(slam.last_pose[0].numpy(), np.asarray(js.last_pose[0]),
                               rtol=0, atol=POS_TOL)
    assert slam.state == js.state == OK


@pytest.mark.parametrize("ready", [False, True], ids=["at_depth_limit", "lag_one"])
def test_injection_under_the_loop_matches_jax(monkeypatch, ready):
    """tools/eval_clone.py's drift injection after every `track` call of the
    frame loop (PAIR 2, LAG_MAX 3, 10 frames, then flush()) against the JAX
    loop with examples/eval_clone.py's `maybe_inject`
    (`torch_port_helpers.jax_drift_injector`): the injection starts on the
    first frame (cutoff: its frame id) and moves the map past the cutoff and
    the optimistic tracking state, never the entries in flight, so the
    keyframes decided at harvest carry the poses of their dispatch. The
    same keyframes, losses, trajectory and tables as the JAX loop's, to
    `_assert_states_match`'s tolerances."""
    slam = _port(3, 2, ready)
    js = _jax_twin(monkeypatch, slam, 3, 2, ready)
    args = types.SimpleNamespace(inject_drift=True, drift_window=[0.0, 10.0],
                                 drift_step=[0.0008, -0.0005, 0.0005, 0.0004])
    inject = eval_clone.DriftInjector(args.drift_window, args.drift_step, "cpu")
    jinject, jdrift = jax_drift_injector(args, js)
    n_ev = len(slam.events)
    seq = long_seq()
    with jax_features():
        for i in range(FIRST, FIRST + 10):
            for s in (js, slam):
                s.track(seq.imgs[i], float(seq.times[i]), seq.imu[i])
            jinject(float(seq.times[i]))
            assert inject(slam, float(seq.times[i]))
        js.flush()
        slam.flush()
    assert inject.n_injected == 10 and not slam.fl.pendings and not js._pendings
    assert (inject.t_start, inject.cutoff) == (jdrift["t_start"], jdrift["cutoff"])
    assert inject.cutoff == boot_run()[3]["last_frame"] + 1          # the first fed frame
    # keyframes of the injected span, decided at harvest, were moved by the later steps
    assert [k for k in _kf_ids(slam, slam.st) if k > inject.cutoff]
    _assert_states_match(js, slam, n_ev)
    # the optimistic state, and the prior where the last keyframe's reseat left one
    pairs = [(slam.ts.ns.P, js.last_ns.P), (slam.ts.ns.R, js.last_ns.R)]
    assert (slam.ts.prior is None) == (js.prior is None)
    if js.prior is not None:
        pairs.append((slam.ts.prior.ns0.P, js.prior.ns0.P))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=POS_TOL)
    assert slam.state == js.state == OK


def test_rollback_matches_jax(monkeypatch):
    """A blank frame inside the second of four pairs in flight: LOST at the
    harvest, the newer pairs dropped and counted, the trajectory cut at the
    pair and the state before it restored; the next call drains and
    relocalizes through the synchronous path (on a view of the start of the
    sequence, as path 5 does: from the frames right after the blank one
    PnP does not pass on this scene's walls, in either mode, F17)."""
    slam = _port(3, 2, False)
    slam.cfg.pnp_iters = chip_smoke.PATH5_PNP_ITERS       # path 5's relocalization
    js = _jax_twin(monkeypatch, slam, 3, 2, False)
    rows0, n_ev = len(slam.traj), len(slam.events)
    blank = FIRST + 3
    with jax_features():
        _feed((js, slam), range(FIRST, FIRST + 8), blank=blank)
        assert len(slam.fl.pendings) == 3 and slam.state == OK
        backup = slam.fl.pendings[0].backup
        js._harvest_pending()
        frameloop.harvest_pending(slam)
    assert slam.state == LOST and js.state == JLOST
    # frame FIRST+3 lost (1), the pair's rows and the two pairs after it dropped (4)
    assert slam.n_lost_frames == js.n_lost_frames == 5
    assert len(slam.traj) == len(js.traj.meta) == rows0 + 2
    assert slam.events[-1][:2] == (blank - FIRST + boot_run()[3]["last_frame"] + 1, "lost")
    assert _events(slam.events[-1:]) == _events(js.events[-1:])
    assert len(js.events) == len(slam.events) - n_ev
    for a, b in zip(slam.ts.ns, backup[0]):            # the state before the pair, exactly
        assert torch.equal(a, b)
    for a, b in zip(slam.ts.ns, _jnav(slam.ts.ns)._replace(**js.last_ns._asdict())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=POS_TOL)
    assert not slam.fl.pendings and not js._pendings and slam.ts.has_prev is False
    # the next call: nothing left to drain, the synchronous path relocalizes
    calls = []
    orig = tracking_ctl.relocalize
    monkeypatch.setattr(tracking_ctl, "relocalize",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    seq = long_seq()
    i = FIRST + 8
    assert slam.track(seq.imgs[REVISIT_SRC], float(seq.times[i]), seq.imu[i]) is True
    assert calls and slam.state == OK and slam.events[-1][1] == "reloc"
    assert slam.reloc_buf is not None and slam.last_outcome.mode == "reloc"


def _same_pnp_samples(monkeypatch, js):
    """The port's relocalization draws the PnP samples the JAX `_relocalize`
    draws (its key splits repeated at each call, tests/test_torch_reloc.py)."""
    from mc_slam_tpu_torch.geometry import pnp
    keys, orig_reloc, orig_draw = [], js._relocalize, pnp.draw_samples

    def j_reloc(*a, **k):
        _, sub = jax.random.split(js.key)
        keys.append(jax.random.split(sub, tracking_ctl.C_PAD))
        return orig_reloc(*a, **k)

    def draw(generator, w, n_iters, k):
        if w.dim() != 2:                                   # not a relocalization
            return orig_draw(generator, w, n_iters, k)
        kk = keys.pop()
        return torch.from_numpy(np.stack([
            jax_samples(kk[c], jnp.asarray(w[c].numpy(), jnp.float32), n_iters, k)
            for c in range(w.shape[0])]).astype(np.int64))

    js._relocalize = j_reloc
    monkeypatch.setattr(pnp, "draw_samples", draw)


def _decisions(monkeypatch, js):
    """What need_new_kf read and decided at each call, in both packages:
    [(frame, inliers, reference count, new keyframe)]."""
    port, jx = [], []
    orig, orig_j = tracking_ctl.need_new_kf, js._need_new_kf

    def need(m, st, cfg, fid, n_in, reloc_open=False):
        r = orig(m, st, cfg, fid, n_in, reloc_open)
        port.append((int(fid), int(n_in), st.ref_tracked, bool(r)))
        return r

    def need_j(fid=None):
        r = orig_j(fid=fid)
        jx.append((int(js.frame_id if fid is None else fid), int(js._cur_inliers),
                   js._ref_tracked_cache, bool(r)))
        return r

    monkeypatch.setattr(tracking_ctl, "need_new_kf", need)
    js._need_new_kf = need_j
    return port, jx


def _port_events(events):
    """The port's log as the JAX class writes it: the JAX class logs no event
    for a frame that stays LOST or drops out of the bias window."""
    return _events([e for e in events
                    if not (e[1] == "lost" and e[2].get("mode") in ("lost", "reloc_window"))])


def test_sync_keyframe_in_the_loop_defers_its_event_as_jax(monkeypatch):
    """The unit of the repair: a keyframe decided off the steady state while
    the frame loop is on (`SlamSystem._sync_keyframe_in_loop`) against the
    JAX `_track_sync` block it ports (mc_slam_tpu/pipeline/system.py:365-373)
    on boot_run()'s state: the keyframe written with the same IMU span, its
    event's host half left pending, a loop-closing attempt of its own, the
    caches dropped and the map epoch bumped; at the harvest that follows, the
    reference count (within one point) and a second loop-closing attempt on
    the event's detection. Events exact, the keyframe's pose to POS_TOL."""
    slam = _port(12, 2, True)
    js = _jax_twin(monkeypatch, slam, 12, 2, True)
    n_ev, seq = len(slam.events), long_seq()
    fid = slam.st.last_kf_frame + slam.cfg.kf_max_gap        # a keyframe by the gap rule
    slam.frame_id = js.frame_id = fid
    with jax_features():
        feats, uv, t = _frame(slam)
    rows = torch.from_numpy(seq.imu[FIRST])
    slam.ts.imu_since_kf.append((fid, rows))
    js.imu_since_kf.append((fid, seq.imu[FIRST]))
    n_in = slam.ts.n_inliers
    slot, _ = slam._sync_keyframe_in_loop(feats, uv, t, slam.ts.prev_feat_mp, n_in)
    assert slot is not None
    jf = JFeatures(**{k: jnp.asarray(v) for k, v in convert.to_numpy(feats).items()})
    assert js._need_new_kf()
    jslot = js._create_keyframe(jf, jnp.asarray(uv.numpy()), t)
    js._local_mapping()
    js._try_close_loop(jslot)
    js._invalidate_frame_caches()
    assert jslot == slot and _kf_ids(js) == _kf_ids(slam, slam.st)
    assert js._map_epoch == slam.fl.map_epoch == 1
    assert slam.st.ref_tracked is None and js._ref_tracked_cache is None
    assert slam.fl.event is not None and js._deferred_event is not None
    assert _events(js.events) == _events(slam.events[n_ev:])
    np.testing.assert_array_equal(slam.st.kf_imu_raw[slot].numpy(), js.kf_imu_raw[jslot])
    for f, tol in (("P", POS_TOL), ("R", 1e-3), ("V", 1e-2)):
        np.testing.assert_allclose(getattr(slam.m.kf_ns, f).numpy()[slot],
                                   np.asarray(getattr(js.m.kf_ns, f))[jslot], rtol=0, atol=tol)
    np.testing.assert_allclose(slam.ts.P.numpy(), np.asarray(js.last_pose[0]), rtol=0,
                               atol=POS_TOL)
    # the next call's harvest of the event's host half
    frameloop._harvest_event(slam)
    js._harvest_event()
    assert slam.fl.event is None and js._deferred_event is None
    # the new keyframe's well-observed count, after the event's BA and landmark
    # cull in each package: a point on the min_obs threshold may flip (one)
    assert js._ref_tracked_cache is not None
    assert abs(slam.st.ref_tracked - js._ref_tracked_cache) <= 1
    assert _events(js.events) == _events(slam.events[n_ev:])
    assert _kf_ids(js) == _kf_ids(slam, slam.st)


RETURN_PAIRS = 24            # pairs fed after the bias window: 2 x LAG_MAX


@pytest.mark.parametrize("ready", [False, True], ids=["at_depth_limit", "lag_one"])
def test_reloc_window_and_return_to_the_loop_match_jax(monkeypatch, ready):
    """The path from the synchronous relocalization back into the frame loop
    (LAG_MAX 12, PAIR 2) against the JAX loop: a blank frame in flight, LOST
    at its harvest; relocalization on REVISIT_SRC's view in that call (the
    same PnP samples); the 20 frames of the bias window; the keyframe that
    closes it (its event's host half deferred, a loop-closing attempt of its
    own), then 2 x 12 pairs back in the loop, the first keyframes decided at
    harvest among them; flush(). Held: the events, keyframe ids, lost
    frames, map epoch and pending depth after every call, exactly; what
    need_new_kf read and decided (reference counts exactly, inliers within
    1 %); the keyframe poses and NavStates after every call that changed the
    keyframes, and at the end `_assert_states_match`'s trajectory and tables."""
    slam = _port(12, 2, ready)
    js = _jax_twin(monkeypatch, slam, 12, 2, ready)
    _same_pnp_samples(monkeypatch, js)
    dec_p, dec_j = _decisions(monkeypatch, js)
    n_ev = len(slam.events)
    seq = long_seq()
    fdt = float(seq.times[1] - seq.times[0])

    def step(img, t, rows):
        js.track(img, t, rows)
        slam.track(img, t, rows)
        assert _port_events(slam.events[n_ev:]) == _events(js.events)
        assert _kf_ids(js) == _kf_ids(slam, slam.st) and js.state == slam.state
        assert js.n_lost_frames == slam.n_lost_frames
        assert js._map_epoch == slam.fl.map_epoch
        assert len(js._pendings) == len(slam.fl.pendings)
        if kf_seen[-1] != _kf_ids(slam, slam.st):
            kf_seen.append(_kf_ids(slam, slam.st))
            ks = slam.st.kf_slots
            for f, tol in (("P", POS_TOL), ("R", 1e-3), ("V", 1e-2)):
                np.testing.assert_allclose(getattr(slam.m.kf_ns, f).numpy()[ks],
                                           np.asarray(getattr(js.m.kf_ns, f))[ks],
                                           rtol=0, atol=tol)

    kf_seen = [_kf_ids(slam, slam.st)]
    t = float(seq.times[FIRST - 1])
    blank = slam.frame_id
    with jax_features():
        # a blank frame opens the first pair; clone frames follow up to the
        # call that harvests that pair
        i = FIRST
        while not (slam.fl.pendings and slam.fl.pendings[0].frames[0]["frame_id"] == blank
                   and (ready or len(slam.fl.pendings) >= slam.LAG_MAX)):
            t += fdt
            step(np.zeros_like(seq.imgs[i]) if i == FIRST else seq.imgs[i], t, seq.imu[i])
            i += 1
        # that call loses the camera and relocalizes on REVISIT_SRC's view;
        # then the bias window and the pairs back in the loop
        for k in range(1 + slam.reloc_window + 2 * RETURN_PAIRS):
            t += fdt
            step(seq.imgs[REVISIT_SRC + k], t, seq.imu[REVISIT_SRC + k])
            if k == 0:
                assert slam.state == OK and slam.reloc_buf is not None
        js.flush()
        slam.flush()
        assert _port_events(slam.events[n_ev:]) == _events(js.events)
    kinds = _port_events(slam.events[n_ev:])
    assert [k for _, k in kinds].count("lost") == 1
    (f_reloc,) = [f for f, k in kinds if k == "reloc"]
    closing = f_reloc + slam.reloc_window                  # the window-closing keyframe
    ids = _kf_ids(slam, slam.st)
    assert closing in ids and [f for f in ids if f > closing]     # ... and keyframes after it
    assert slam.reloc_buf is None and slam.state == OK and not slam.fl.pendings
    assert [(f, r, d) for f, _, r, d in dec_p] == [(f, r, d) for f, _, r, d in dec_j]
    assert any(f > closing and d for f, _, _, d in dec_p)        # decided at harvest
    for (_, a, _, _), (_, b, _, _) in zip(dec_p, dec_j):
        assert abs(a - b) <= max(1.0, 0.01 * b)                            # 1 %
    ref, got = js.get_trajectory(), slam.get_trajectory()
    assert len(ref) == len(got) > 100
    for (t0, P0, R0), (t1, P1, R1) in zip(ref, got):
        assert t0 == t1
        np.testing.assert_allclose(P1, P0, rtol=0, atol=POS_TOL)        # 1e-3 m
        np.testing.assert_allclose(R1, R0, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# (d) the deferred loop stages
# ---------------------------------------------------------------------------

def _planted():
    """revisit_run()'s system with chip_smoke.py's planted seam (the
    construction of tests/test_torch_loop_event.py)."""
    seq, cam, ext, slam0, rv, _ = revisit_run()
    slam = copy.deepcopy(slam0)
    st = slam.st
    src_end = REVISIT_SRC + REVISIT_FRAMES - 1
    revisit = rv["new_kf"]
    spread = [s for s in rv["kf_before"] if st.kf_id_host[s] > src_end]
    axis = torch.tensor([0.3, 0.2, 0.93])
    R_d = tlie.so3_exp(axis / axis.norm() * float(np.radians(chip_smoke.SEAM_ROT_DEG)))
    c = slam.m.kf_ns.P[revisit[-1]]
    t_d = torch.tensor(chip_smoke.SEAM_T) + c - R_d @ c
    slam.m, _ = chip_smoke.plant_seam(slam.m, st, revisit, spread, R_d, t_d)
    slam.loop.consistent_groups = []
    return slam, revisit[0]


def test_deferred_loop_stages_match_the_synchronous_ones():
    """Dispatch, then harvest when landed (frameloop's Sim3 and verification
    stages) against `loopctl.try_close_loop` on the same RANSAC stream: the
    same events, Sim3 rows, guided counts, loop edge and corrected map, bit
    for bit; tracking goes on from the newest keyframe."""
    base, cur = _planted()
    a, b = copy.deepcopy(base), copy.deepcopy(base)
    n_ev = len(base.events)
    m_a, out = loopctl.try_close_loop(a.m, a.st, a.cfg, a.ts, a._loopctx, cur, a.frame_id,
                                      a.cam, a.ext, a.noise)
    assert out.closed is not None
    frameloop._try_close_loop(b, cur, None)
    assert b.fl.sim3 is not None and b.fl.sim3.copy.ready()     # the CPU copy has landed
    kinds = _events(b.events[n_ev:])
    assert kinds[-1][1] == "sim3_dispatch" and not any(k == "sim3_result" for _, k in kinds)
    frameloop._harvest_sim3(b)
    assert b.fl.sim3 is None and b.fl.verify is not None
    n_verify = 0
    while b.fl.verify is not None:
        frameloop._harvest_verify(b)
        n_verify += 1
    assert n_verify == len(out.verify)                  # one verification a harvest
    assert [e[1:] for e in a.events[n_ev:]] == [e[1:] for e in b.events[n_ev:]]
    assert a.st.loop_edges == b.st.loop_edges and b.st.n_loops_closed == 1
    for f in ("kf_ns", "mp_pos", "kf_mp", "mp_active"):
        ta, tb = getattr(m_a, f), getattr(b.m, f)
        for x, y in (zip(ta, tb) if isinstance(ta, tuple) else [(ta, tb)]):
            assert torch.equal(x, y), f
    newest = b.st.last_kf_slot
    assert torch.equal(b.ts.P, b.m.kf_ns.P[newest]) and b.ts.prior is None
    # the closure bumps the map epoch once (revisit_run's relocalization and
    # bias window bumped it before, as the JAX class does)
    assert float(b.ts.dP.abs().sum()) == 0.0 and b.fl.map_epoch == base.fl.map_epoch + 1


# ---------------------------------------------------------------------------
# (e) the synchronous mode is the parent code's
# ---------------------------------------------------------------------------

def sync_digest():
    """boot_run()'s system and 8 more frames in the synchronous mode (one
    keyframe event among them): the composed trajectory and the map tables
    that the frames and the event write. tests/torch_sync_digest.npz holds
    the same digest computed by the code before the frame loop was added."""
    slam = copy.deepcopy(boot_run()[3]["slam"])
    assert not slam.async_loop and (slam.LAG_MAX, slam.PAIR) == (1, 1)
    _feed((slam,), range(FIRST, FIRST + 8))
    tr = slam.get_trajectory()
    m = slam.m
    return dict(t=np.asarray([x[0] for x in tr]), P=np.stack([x[1] for x in tr]),
                R=np.stack([x[2] for x in tr]), kf_P=m.kf_ns.P.numpy(), kf_V=m.kf_ns.V.numpy(),
                mp_pos=m.mp_pos.numpy(), kf_mp=m.kf_mp.numpy(), mp_found=m.mp_found.numpy(),
                kf_slots=np.asarray(slam.st.kf_slots), n_kf=slam.n_kf)


def test_synchronous_mode_is_bit_equal_to_the_parent_code(monkeypatch):
    monkeypatch.delenv("MC_SLAM_LAG_MAX", raising=False)
    monkeypatch.delenv("MC_SLAM_PAIR", raising=False)
    got = sync_digest()
    with np.load(DIGEST) as ref:
        assert sorted(ref.files) == sorted(got)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)      # bit for bit
    assert got["n_kf"] == 12 and len(got["t"]) == 112


# ---------------------------------------------------------------------------
# (f) the stream driver with the loop on; the switch
# ---------------------------------------------------------------------------

def test_mode_switch_reads_the_jax_variables(monkeypatch):
    cam = boot_run()[1]
    monkeypatch.delenv("MC_SLAM_LAG_MAX", raising=False)
    monkeypatch.delenv("MC_SLAM_PAIR", raising=False)
    slam = SlamSystem(cam, SlamConfig(max_kf=8, max_mp=256, n_feat=64, n_levels=2), device="cpu")
    assert (slam.LAG_MIN, slam.LAG_MAX, slam.PAIR, slam.async_loop) == (1, 1, 1, False)
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "12")
    monkeypatch.setenv("MC_SLAM_PAIR", "2")
    slam.reset()
    assert (slam.LAG_MAX, slam.PAIR, slam.async_loop) == (12, 2, True)
    assert isinstance(slam.fl.pendings, collections.deque) and slam.fl.map_epoch == 0
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "1")
    assert SlamSystem(cam, slam.cfg, device="cpu").async_loop       # PAIR 2 alone


def test_stream_driver_backpressure_and_imu_carry_with_the_loop(monkeypatch, rng):
    """tests/test_io.py::test_stream_driver_backpressure_and_imu_carry on the
    port with the frame loop on: frames are dropped while LAG_MAX entries are
    in flight, their IMU rows carried into the next processed frame;
    finish() drains."""
    monkeypatch.setenv("MC_SLAM_LAG_MAX", "12")
    monkeypatch.setenv("MC_SLAM_PAIR", "2")
    cam = boot_run()[1]
    slam = SlamSystem(cam, SlamConfig(max_kf=16, max_mp=512, n_feat=64, n_levels=2,
                                      use_imu=True), device="cpu")
    drv = StreamDriver(slam)
    seen = []
    orig_track = slam.track
    slam.track = lambda img, t, imu=None, **kw: seen.append((t, 0 if imu is None else len(imu)))
    imu1 = np.zeros((5, 7), np.float32)
    img = rng.uniform(0, 255, (360, 480)).astype(np.float32)
    assert drv.on_frame(0.0, img, imu=None)
    slam.fl.pendings.extend({} for _ in range(slam.LAG_MAX))     # the pipeline full
    assert not drv.accepting()
    assert not drv.on_frame(0.05, img, imu=imu1)
    assert not drv.on_frame(0.10, img, imu=imu1)
    assert drv.n_dropped == 2
    drv.budget = 1                                               # one entry more tolerated
    assert drv.accepting()
    drv.budget = 0
    slam.fl.pendings.clear()                                     # the pipeline drains
    assert drv.on_frame(0.15, img, imu=imu1)
    assert seen[-1] == (0.15, 15) and drv.n_processed == 2
    slam.track = orig_track
    # finish() drains real entries: two pairs of boot_run's system in flight
    live = _port(12, 2, False)
    drv = StreamDriver(live)
    seq = long_seq()
    for i in range(FIRST, FIRST + 4):
        assert drv.on_frame(float(seq.times[i]), seq.imgs[i], imu=seq.imu[i])
    assert len(live.fl.pendings) == 2 and drv.accepting()
    n_rows = len(live.traj)
    drv.finish()
    assert not live.fl.pendings and live.fl.event is None and len(live.traj) == n_rows
    assert live.n_lost_frames == 0


def test_checkpoint_keeps_the_imu_tags(tmp_path):
    """Rows kept for the next keyframe keep their frame ids through
    `.track.npz` and `convert.host_state_to_dict`, in the JAX attribute's
    form [(frame id, rows)]."""
    from mc_slam_tpu_torch.io import checkpoint
    slam = _port(1, 1)
    seq = long_seq()
    st, ts = slam.st, slam.ts
    # stand on a keyframe's frame with rows of two later frames kept
    ts.imu_since_kf = [(slam.frame_id - 1, torch.from_numpy(seq.imu[FIRST])),
                       (slam.frame_id, torch.from_numpy(seq.imu[FIRST + 1]))]
    st.last_kf_frame = slam.frame_id - 1
    d = convert.host_state_to_dict(st, ts=ts)
    assert [f for f, _ in d["imu_since_kf"]] == [slam.frame_id - 1, slam.frame_id]
    np.testing.assert_array_equal(d["imu_since_kf"][1][1], seq.imu[FIRST + 1])
    path = str(tmp_path / "ck.npz")
    checkpoint.save_system(path, slam)
    new = checkpoint.load_system(path, SlamSystem(slam.cam, dataclasses.replace(slam.cfg),
                                                  Tbc=chip_smoke.TBC, device="cpu"))
    got = new.ts.imu_since_kf
    assert [f for f, _ in got] == [f for f, _ in ts.imu_since_kf]
    for (_, a), (_, b) in zip(got, ts.imu_since_kf):
        assert torch.equal(a, b)
    # a keyframe cut at the first of those frames takes its rows only
    m, slot = tracking_ctl.create_keyframe(new.m, new.st, new.cfg, new.ts, *_frame(new),
                                           slam.frame_id - 1, new.ts.prev_feat_mp, new.noise)
    assert new.st.kf_imu_raw[slot].shape[0] == seq.imu[FIRST].shape[0]
    assert [f for f, _ in new.ts.imu_since_kf] == [slam.frame_id]


def _frame(slam):
    """(feats, uv, t) of the next clone frame, extracted."""
    from mc_slam_tpu_torch.camera import undistort_points
    from mc_slam_tpu_torch.frontend import extractor
    seq = long_seq()
    feats = extractor.extract(torch.from_numpy(seq.imgs[FIRST]), n_features=slam.cfg.n_feat,
                              n_levels=slam.cfg.n_levels)
    return feats, undistort_points(slam.cam, feats.xy), float(seq.times[FIRST])


def test_chip_smoke_async_modes_on_the_cpu(tmp_path):
    """chip_smoke.py's phase "async" at the BOOT profile on the CPU, shortened:
    the checkpoint of revisit_run()'s system written by the phase
    "checkpoint", loaded into a synchronous system and one with LAG_MAX 12 /
    PAIR 2, 6 frames each, then one profiled frame each. Every frame tracked
    in both, none lost or pending, the same positions to 1e-3 m (the loop
    decides the same keyframes here: on the CPU every copy has landed by the
    next call)."""
    seq, cam, ext, slam0, rv, _ = revisit_run()
    slam = copy.deepcopy(slam0)
    first = REVISIT_SRC + REVISIT_FRAMES
    ck = chip_smoke.run_checkpoint_phase(slam, seq, rv, first, n_frames=3,
                                         keep_dir=str(tmp_path))
    _, srcs, times, rows = chip_smoke.resume_feed(slam.st, rv, seq, first, 6)
    args = (ck["path"], slam.cam, slam.cfg, slam.event_kw, seq, srcs, times, rows, slam.device)
    a, sys_a = chip_smoke.run_async_mode(*args, 1, 1)
    b, sys_b = chip_smoke.run_async_mode(*args, chip_smoke.ASYNC_LAG_MAX, chip_smoke.ASYNC_PAIR)
    for r in (a, b):
        assert r["tracked"] == r["rows"] == 6 and r["lost"] == 0 and r["pending_after_flush"] == 0
        assert r["ate"]["rmse"] < chip_smoke.RELOC_POS_TOL
    assert a["dispatched"]["vi2"] == 0 and b["dispatched"]["vi2"] == 3 and b["max_depth"] == 1
    for k in a["pos"]:
        np.testing.assert_allclose(b["pos"][k], a["pos"][k], rtol=0, atol=POS_TOL)
    # mode C, the transition, at LAG_MAX 3: 3 pairs in flight before the loss,
    # 14 pairs after the window (a keyframe at kf_max_gap, decided at harvest)
    _, srcs_c, times_c, rows_c = chip_smoke.resume_feed(slam.st, rv, seq, first, 2 * 3)
    c, sys_c = chip_smoke.run_transition(ck["path"], slam.cam, slam.cfg, slam.event_kw, seq,
                                         srcs_c, times_c, rows_c, REVISIT_SRC, slam.device,
                                         lag_max=3, n_pairs=14)
    assert c["frames_before"] == 6 and c["lost_frames"] == 6 and c["lost_after_reloc"] == 0
    assert c["reloc_attempts"] == 1 and c["closing_is_kf"] and c["kf_after"]
    assert c["twin_checked"] > 2 * c["frames_after"] and c["launches"] == 0    # CPU: the twin
    assert sys_c.fl.n_dispatched["vi2"] >= 3 + 14 and c["epoch"] >= 3
    chip_smoke.profile_async_mode(sys_b, b, seq, n_profile=1)
    assert b["profile_frames"] == 1 and b["profile_wall_ms"] > 0
    assert b["profile_device_ms"] == 0.0        # no device on the CPU
    assert "LAG_MAX 12, PAIR 2" in chip_smoke._async_line("B", b)
