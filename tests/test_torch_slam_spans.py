"""SlamSystem's stages as spans of an active timer, on deep copies of the
cached `boot_run()` system (no new bootstrap), continued on the BOOT clone's
next frames: under `metrics.tracing(T)` each VI frame leaves a `track`
record holding `imu.preintegrate`, two `tracking.search` and two
`tracking.solve`, and a keyframe event leaves `mapping.event` holding
`mapping.vi_ba`; with no timer active the copy tracks to the same bits and
`slam.timers` records the same stage names; the system's counters count the
VI frames, fallbacks, events and lost frames."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from mc_slam_tpu_torch.pipeline import tracking_ctl
from mc_slam_tpu_torch.sim import MavTrajectory, RoomWorld
from mc_slam_tpu_torch.utils import metrics
from torch_port_helpers import BOOT, boot_run

N_FRAMES = 3            # two VI frames, then one made a keyframe
COUNTERS = ("n_vi_frames", "n_vi_fallbacks", "n_kf_events", "n_lost_frames")


def next_frames(seq, k0, n):
    """(img, t, IMU rows) of frames k0 .. k0 + n - 1 of the BOOT clone: the
    sequence's own where it has them, past its end rendered from the same
    world (its textures are the first draws of seed 0, as
    chip_smoke.make_sequence draws them) with IMU rows of fresh noise."""
    fdt = 1.0 / BOOT.fps
    world = traj = None
    out = []
    for k in range(k0, k0 + n):
        if k < len(seq.imgs):
            out.append((seq.imgs[k], float(seq.times[k]), seq.imu[k]))
            continue
        if world is None:
            world = RoomWorld(np.random.default_rng(0), tex_size=BOOT.tex_size, tex_scale=1.0)
            traj, rng = MavTrajectory(duration=120.0), np.random.default_rng(1)
            cam = chip_smoke.profile_camera(BOOT, "cpu")
        P, R = traj.pose(k * fdt)
        img = world.render(cam, R @ chip_smoke.TBC[:3, :3], P + R @ chip_smoke.TBC[:3, 3])
        rows = traj.imu_samples((k - 1) * fdt, k * fdt, bg=chip_smoke.TRUE_BG,
                                ba=chip_smoke.TRUE_BA, noise_g=1.7e-4, noise_a=2e-3, rng=rng)
        out.append((img, k * fdt, rows))
    return out


def _run(slam, frames, timer):
    """The frames through `track`, the last one made a keyframe, with
    `timer` active (or none); returns each frame's (P, R) after it."""
    need = tracking_ctl.need_new_kf
    poses = []
    with metrics.tracing(timer):
        for i, f in enumerate(frames):
            if i == len(frames) - 1:
                tracking_ctl.need_new_kf = lambda *a, **k: True
            try:
                assert slam.track(*f)
            finally:
                tracking_ctl.need_new_kf = need
            poses.append((slam.ts.P.clone(), slam.ts.R.clone()))
    return poses


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(2)
    seq, _, _, res, _ = boot_run()
    assert res["slam"].st.vi_inited
    frames = next_frames(seq, res["last_frame"] + 1, N_FRAMES)
    traced, plain = copy.deepcopy(res["slam"]), copy.deepcopy(res["slam"])
    before = {k: getattr(traced, k) for k in COUNTERS}
    n0 = len(traced.timers.records)
    T = metrics.StageTimer()
    out = dict(traced=traced, plain=plain, before=before, T=T, n0=n0)
    out["traced_poses"] = _run(traced, frames, T)
    out["plain_poses"] = _run(plain, frames, None)
    return out


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_each_vi_frame_is_a_track_span_holding_its_stages(runs):
    recs = runs["T"].records
    frames = sorted((r for r in recs if r.name == "track"), key=lambda r: r.start_ns)
    assert len(frames) == N_FRAMES
    for f in frames:
        held = [r.name for r in recs if r is not f and _within(r, f)]
        assert held.count("imu.preintegrate") == 1, held
        assert held.count("tracking.search") == 2 and held.count("tracking.solve") == 2, held
        assert held.count("frontend.extract") == 1, held
    for r in recs:
        if r.name in ("imu.preintegrate", "tracking.search", "tracking.solve"):
            assert r.parent == "track"


def test_a_keyframe_event_is_a_mapping_event_span_holding_the_window_vi_ba(runs):
    recs = runs["T"].records
    events = [r for r in recs if r.name == "mapping.event"]
    assert len(events) == 1
    ev = events[0]
    last = max((r for r in recs if r.name == "track"), key=lambda r: r.start_ns)
    assert ev.parent == "track" and _within(ev, last)
    ba = [r for r in recs if r.name == "mapping.vi_ba"]
    assert len(ba) == 1 and _within(ba[0], ev)
    # the event's own stage marks are spans of T too, between the two
    lm_ba = next(r for r in recs if r.name == "lm_ba")
    assert ba[0].parent == "lm_ba" and _within(lm_ba, ev)


def test_without_a_timer_the_frames_are_bit_identical_and_the_timers_unchanged(runs):
    for (P, R), (Pp, Rp) in zip(runs["traced_poses"], runs["plain_poses"]):
        assert torch.equal(P, Pp) and torch.equal(R, Rp)
    traced, plain = runs["traced"], runs["plain"]
    assert torch.equal(traced.m.mp_pos, plain.m.mp_pos)
    assert torch.equal(traced.m.kf_ns.P, plain.m.kf_ns.P)
    n0 = runs["n0"]
    names = [r.name for r in traced.timers.records[n0:]]
    assert names == [r.name for r in plain.timers.records[n0:]]
    assert {"track", "lm_pre", "lm_ba", "lm_post", "lm_cull"} <= set(names)
    # every stage of the system's timer is a span of T, and T has no other
    # records than those and the library's spans
    spans = {"frontend.extract", "imu.preintegrate", "tracking.search", "tracking.solve",
             "mapping.event", "mapping.vi_ba"}
    t_names = [r.name for r in runs["T"].records]
    assert sorted(n for n in t_names if n not in spans) == sorted(names)


def test_the_counters_count_vi_frames_fallbacks_events_and_losses(runs):
    slam, before = runs["traced"], runs["before"]
    moved = {k: getattr(slam, k) - before[k] for k in COUNTERS}
    assert moved == {"n_vi_frames": N_FRAMES, "n_vi_fallbacks": 0, "n_kf_events": 1,
                     "n_lost_frames": 0}
    assert before["n_vi_frames"] == BOOT.n_vi_frames and before["n_lost_frames"] == 0
    assert before["n_kf_events"] == len(boot_run()[3]["events"])
