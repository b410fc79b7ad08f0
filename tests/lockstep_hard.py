"""Lock step of the port and the JAX package on the hard clone's relocalization
(a script, not a test; CPU only, ~15 min).

Both SlamSystems run the frame loop at LAG_MAX 12 / PAIR 2 with every summary
harvested at the depth limit (the readiness rule set on the instances, as in
tests/test_torch_frameloop.py) from one port checkpoint of the hard profile:
the JAX one is handed the port's state (`test_torch_frameloop._jax_twin`,
with the hard profile's configuration). They are fed the same clone frames,
the same feature tables (`torch_port_helpers.jax_features`) and the same
relocalization PnP samples (the JAX key splits repeated). While both are
LOST and nothing is in flight, the frames before --resume-at are skipped (a
failed relocalization attempt costs ~12 s of CPU in each package and changes
nothing but the random streams and the lost counts); frame ids follow the
clone's. --events next harvests the keyframe events, Sim3 batches and
verifications at the next call in both (the test harness's rule); never:
only when forced (what the JAX package's TPU runs did: an event's host half
waited for the next event).

After every call it logs what each package holds and decided: keyframe ids,
map epoch, the reference count of need_new_kf, pending depth, state, lost
frames, events (the port's per-attempt "lost" records dropped: the JAX class
writes none), the tracked position, and every need_new_kf decision (frame,
inliers, reference count, result). With --traj (the trajectory file of the
run that wrote the checkpoint) the positions are also scored against the
ground truth under a similarity fit on that run's frames 100-339 (the first
lap). Prints the first frame where anything differs.

The checkpoint (the first keyframe event after frame 330 of a port run
pinned as the README gives it):

    MC_SLAM_LAG_MAX=12 MC_SLAM_PAIR=2 python3 -c "import sys; from
    mc_slam_tpu_torch.pipeline.system import SlamSystem as S; S._summary_ready =
    lambda self, p: False; from mc_slam_tpu_torch.tools import eval_clone;
    eval_clone.main(sys.argv[1:])" --profile hard --device cpu --max-frames 330
    --save-checkpoint CK/ck.npz --out CK/ate_clone_hard_ck.json

then:

    python3 tests/lockstep_hard.py --ck CK/ck.npz --traj CK/traj_clone_hard_ck.npz
        --last 780 --resume-at 588 --out CK/lock.json
"""
import argparse
import functools
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from _pytest.monkeypatch import MonkeyPatch  # noqa: E402

import test_torch_frameloop as tf  # noqa: E402
import torch_port_helpers as tph  # noqa: E402
from mc_slam_tpu.pipeline.pipebase import LOST as JLOST  # noqa: E402
from mc_slam_tpu.pipeline.system import SlamSystem as JSlamSystem  # noqa: E402
from mc_slam_tpu_torch.camera import euroc_camera  # noqa: E402
from mc_slam_tpu_torch.eval.ate import horn_align  # noqa: E402
from mc_slam_tpu_torch.geometry import pnp  # noqa: E402
from mc_slam_tpu_torch.io import checkpoint  # noqa: E402
from mc_slam_tpu_torch.pipeline import pipebase, tracking_ctl  # noqa: E402
from mc_slam_tpu_torch.pipeline.pipebase import LOST  # noqa: E402
from mc_slam_tpu_torch.pipeline.system import SlamSystem  # noqa: E402
from mc_slam_tpu_torch.tools import eval_clone  # noqa: E402

HARD = types.SimpleNamespace(n_levels=8, local_window=20, vi_init_time=15.0)


def systems(ck, events):
    """The port system loaded from `ck` and its JAX twin, both pinned."""
    slam = SlamSystem(euroc_camera(device="cpu"), eval_clone.profile_config("hard"),
                      Tbc=eval_clone.TBC, device="cpu")
    checkpoint.load_system(ck, slam)
    slam.LAG_MAX, slam.PAIR = 12, 2
    slam._summary_ready = lambda p: False
    tf.jax_system_from_port = functools.partial(tph.jax_system_from_port, profile=HARD,
                                                g_mag=eval_clone.profile_config("hard").g_mag)
    js = tf._jax_twin(MonkeyPatch(), slam, 12, 2, False)
    if events == "never":
        pipebase.HostCopy.ready = lambda self: False
        for name in ("_harvest_event", "_harvest_sim3", "_harvest_verify"):
            fn = getattr(JSlamSystem, name).__get__(js)
            setattr(js, name, lambda force=False, fn=fn: fn(force=True) if force else None)
    return slam, js


def same_pnp_samples(js):
    """The port's relocalization draws the samples the JAX one draws."""
    keys, orig_reloc, orig_draw = [], js._relocalize, pnp.draw_samples

    def j_reloc(*a, **k):
        _, sub = jax.random.split(js.key)
        keys.append(jax.random.split(sub, tracking_ctl.C_PAD))
        return orig_reloc(*a, **k)

    def draw(generator, w, n_iters, k):
        if w.dim() != 2 or not keys:
            return orig_draw(generator, w, n_iters, k)
        kk = keys.pop()
        return torch.from_numpy(np.stack([
            tph.jax_samples(kk[c], jnp.asarray(w[c].numpy(), jnp.float32), n_iters, k)
            for c in range(w.shape[0])]).astype(np.int64))

    js._relocalize = j_reloc
    pnp.draw_samples = draw


def watch_decisions(js):
    dec = {"port": [], "jax": []}
    orig, orig_j = tracking_ctl.need_new_kf, js._need_new_kf

    def need(m, st, cfg, fid, n_in, reloc_open=False):
        r = orig(m, st, cfg, fid, n_in, reloc_open)
        dec["port"].append((int(fid), int(n_in), st.ref_tracked, bool(r)))
        return r

    def need_j(fid=None):
        r = orig_j(fid=fid)
        dec["jax"].append((int(js.frame_id if fid is None else fid), int(js._cur_inliers),
                           js._ref_tracked_cache, bool(r)))
        return r

    tracking_ctl.need_new_kf = need
    js._need_new_kf = need_j
    return dec


def snapshot(s, n_ev0=0):
    if isinstance(s, JSlamSystem):
        return dict(kf=[s.kf_id_host[k] for k in s.kf_slots], epoch=s._map_epoch,
                    ref=s._ref_tracked_cache, depth=len(s._pendings), state=int(s.state),
                    lost=s.n_lost_frames, P=np.asarray(s.last_pose[0]).tolist(),
                    events=tf._events(s.events),
                    window=None if s.reloc_buf is None else len(s.reloc_buf))
    return dict(kf=[s.st.kf_id_host[k] for k in s.st.kf_slots], epoch=s.fl.map_epoch,
                ref=s.st.ref_tracked, depth=len(s.fl.pendings), state=int(s.state),
                lost=s.n_lost_frames, P=s.ts.P.tolist(),
                events=tf._port_events(s.events[n_ev0:]),
                window=None if s.ts.reloc_buf is None else len(s.ts.reloc_buf))


def first_lap_fit(traj_path):
    """(s, R, t) taking the run's positions of frames 100-339 to the truth."""
    z = np.load(traj_path)
    fid = np.round((z["t_est"] - z["t_gt"][0]) * 20).astype(int)
    sel = (fid >= 100) & (fid <= 339)
    return horn_align(z["P_est"][sel], z["P_gt"][fid[sel]], with_scale=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck", required=True)
    ap.add_argument("--last", type=int, default=780)
    ap.add_argument("--resume-at", type=int, default=0)
    ap.add_argument("--events", choices=("next", "never"), default="next")
    ap.add_argument("--traj", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    slam, js = systems(args.ck, args.events)
    same_pnp_samples(js)
    dec = watch_decisions(js)
    fit = first_lap_fit(args.traj) if args.traj else None
    clone = eval_clone.parse_args(["--profile", "hard", "--device", "cpu"])
    n_all = int(clone.duration * clone.fps)
    start, n_ev0 = slam.frame_id, len(slam.events)
    frames, _, P_gt = eval_clone.frames_span(clone, n_all, start, min(args.last, n_all))
    log, first_diff, t0 = [], None, time.time()
    with tph.jax_features():
        for k, (t, img, rows) in enumerate(frames):
            fid = start + k
            if (fid < args.resume_at and slam.state == LOST and js.state == JLOST
                    and not slam.fl.pendings and not js._pendings):
                continue
            js.frame_id = slam.frame_id = fid
            js.track(img, t, rows)
            slam.track(img, t, imu=rows)
            a, b = snapshot(js), snapshot(slam, n_ev0)
            same = {key: a[key] == b[key] for key in a if key != "P"}
            same["P"] = float(np.linalg.norm(np.subtract(a["P"], b["P"]))) < 1e-2
            rec = dict(fid=fid, jax=a, port=b, same=same)
            if fit is not None:
                s, R, tt = fit
                rec["err"] = [float(np.linalg.norm(s * R @ np.asarray(x["P"]) + tt - P_gt[fid]))
                              for x in (a, b)]
            log.append(rec)
            bad = [key for key, v in same.items() if not v]
            if bad and first_diff is None:
                first_diff = fid
            print(f"{fid} {time.time() - t0:.0f}s differ={bad} kf={a['kf'][-3:]}/{b['kf'][-3:]} "
                  f"epoch={a['epoch']}/{b['epoch']} ref={a['ref']}/{b['ref']} "
                  f"lost={a['lost']}/{b['lost']} err={rec.get('err')}", file=sys.stderr,
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(dict(start=start, first_diff=first_diff, log=log, decisions=dec), f)
    print("first difference at frame", first_diff)


if __name__ == "__main__":
    main()
