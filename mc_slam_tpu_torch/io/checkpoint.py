"""Map checkpoint / resume (port of mc_slam_tpu/io/checkpoint.py).

The file layout is the JAX package's, byte for byte, so that a checkpoint
written by either package loads in the other: one compressed `.npz` with the
MapState fields flattened by name (`kf_ns.P`, `kf_preint.dR`, ..., packed
descriptors as uint32), the host bookkeeping as JSON in the uint8 entry
`__extra__` (the JAX keys exactly), and the side file `<path>.bow.npz` with
the loop detector's histograms and vocabulary.

The port also writes `<path>.traj.npz`, the `TrajStore` rows (relative and
track-time poses, time, anchor slot, anchor keyframe id): a resumed port
system's `get_trajectory()` then covers the frames before the resume. The
JAX loader never opens it; a checkpoint without it resumes with an empty
trajectory, as the JAX `load_system` does.

A save taken on a keyframe's frame (right after its event, when tracking
already stands at the newest keyframe as the load reseats it) also writes
`<path>.track.npz`: what the tracker carries beside that pose (the last
frame's landmark associations and keypoint angles, the velocity model) and
the mapping's caches of the last event (reference count, covisibility row,
loop cooldown). Loaded with it, the resumed system tracks on exactly as the
uninterrupted one would; without it (a JAX file, or a save between
keyframes) the load is the JAX reseat, and the first frames after it are
tracked without the last frame's associations. It also holds the IMU rows
kept for the next keyframe, each row with the id of its frame
(`imu_fid`, `imu_rows`; none at a keyframe's frame unless frames were in
flight).

`save_system` drains the frame loop first (`SlamSystem.flush`); a load
starts with nothing in flight.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.imu.navstate import NavState
from mc_slam_tpu_torch.imu.preintegration import PreintState
from mc_slam_tpu_torch.pipeline import frameloop, mapping_ctl, tracking_ctl
from mc_slam_tpu_torch.pipeline.pipebase import LOST, NO_IMAGES_YET, OK
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.slam_map.mapstate import MapState


def _flatten(prefix, tree, out):
    for name, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{name}.", v, out)
        else:
            out[prefix + name] = np.asarray(v)


def save_map(path, m: MapState, extra: dict | None = None):
    """Write the MapState (+ JSON-serializable extras) to an npz file."""
    out = {}
    _flatten("", convert.to_numpy(m), out)
    out["__extra__"] = np.frombuffer(json.dumps(extra or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_map(path, device=None):
    """Returns (MapState on `device`, extra dict)."""
    with np.load(path) as data:
        d = {}
        for f in MapState._fields:
            if f == "kf_ns":
                d[f] = {g: data[f"kf_ns.{g}"] for g in NavState._fields}
            elif f == "kf_preint":
                d[f] = {g: data[f"kf_preint.{g}"] for g in PreintState._fields}
            else:
                d[f] = data[f]
        extra = (json.loads(bytes(data["__extra__"]).decode())
                 if "__extra__" in data.files else {})
    return convert.to_torch(MapState, d, device), extra


def save_system(path, sys):
    """Checkpoint a SlamSystem (map, host bookkeeping, loop detector, and the
    port's trajectory rows) for resume."""
    sys.flush()
    st = sys.st
    extra = {
        "frame_id": sys.frame_id,
        "n_kf": st.n_kf,
        "last_kf_slot": st.last_kf_slot,
        "last_kf_frame": st.last_kf_frame,
        "kf_slots": [int(s) for s in st.kf_slots],
        "vi_inited": bool(st.vi_inited),
        "gw": sys.gw.detach().cpu().numpy().tolist(),
        "first_kf_time": st.first_kf_time,
        "state": sys.state,
        "kf_imu_raw": {str(k): v.detach().cpu().numpy().tolist()
                       for k, v in st.kf_imu_raw.items()},
        "bow_hists_nonzero": [int(s) for s in st.kf_slots],
        "loop_edges": [[int(a), int(b)] for a, b in st.loop_edges],
        "n_loops_closed": st.n_loops_closed,
        "broken_chain_slots": [int(s) for s in st.broken_chain_slots],
        "free_slots": [int(s) for s in st.free_slots],
        "next_fresh_slot": st.next_fresh_slot,
        "hist_ids": {str(k): int(v) for k, v in sys.loop.hist_ids.items()},
    }
    save_map(path, sys.m, extra)
    np.savez_compressed(str(path) + ".bow.npz", hists=sys.loop.hists.detach().cpu().numpy(),
                        vocab=sys.loop.vocab.detach().cpu().numpy())
    d = convert.host_state_to_dict(st, sys.traj)
    if d["traj_rows"] is not None:
        meta = d["traj_meta"]
        np.savez_compressed(str(path) + ".traj.npz",
                            **dict(zip(("P_rel", "R_rel", "P_abs", "R_abs"), d["traj_rows"])),
                            t=np.asarray([x[0] for x in meta], np.float64),
                            slot=np.asarray([x[1] for x in meta], np.int64),
                            kid=np.asarray([x[2] for x in meta], np.int64))
    _save_tracker(str(path) + ".track.npz", sys)


# the tracker's and the mapping's state beside the reseat, in `.track.npz`
TRACK_TENSORS = ("prev_feat_mp", "prev_angle", "dP", "dR")
TRACK_SCALARS = ("has_prev", "n_inliers", "last_time")
MAPPING_CACHES = ("ref_tracked", "covis_row", "last_init_attempt_nkf", "last_loop_nkf",
                  "chain_break_pending")


def _save_tracker(path, sys):
    """`.track.npz` when the system stands on the frame of its newest keyframe
    (tracked, not LOST, no bias window open); otherwise none (an older one at
    the same path is removed)."""
    ts, st = sys.ts, sys.st
    if not (ts is not None and sys.state == OK and ts.reloc_buf is None
            and st.last_kf_slot >= 0 and st.last_kf_frame == sys.frame_id - 1):
        if os.path.exists(path):
            os.remove(path)
        return
    out = {f: getattr(ts, f).detach().cpu().numpy() for f in TRACK_TENSORS}
    out.update({f: np.asarray(getattr(ts, f)) for f in TRACK_SCALARS})
    rows = [(f, r.detach().cpu().numpy()) for f, r in ts.imu_since_kf]
    out["imu_fid"] = np.asarray([f for f, r in rows for _ in range(len(r))], np.int64)
    out["imu_rows"] = (np.concatenate([r for _, r in rows]) if rows
                       else np.zeros((0, 7), np.float32))
    out.update({f"st.{f}": np.asarray(getattr(st, f)) for f in MAPPING_CACHES
                if getattr(st, f) is not None})
    np.savez_compressed(path, **out)


def _load_tracker(path, ts, st, device):
    try:
        tk = np.load(path)
    except FileNotFoundError:
        return False
    with tk:
        for f in TRACK_TENSORS:
            setattr(ts, f, torch.as_tensor(tk[f], device=device))
        ts.has_prev = bool(tk["has_prev"])
        ts.n_inliers = int(tk["n_inliers"])
        ts.last_time = float(tk["last_time"])
        if "imu_fid" in tk.files:
            fid, rows = tk["imu_fid"], tk["imu_rows"]
            ts.imu_since_kf = [(int(f), torch.as_tensor(rows[fid == f], device=device))
                               for f in dict.fromkeys(fid.tolist())]
        for f in MAPPING_CACHES:
            if f"st.{f}" in tk.files:
                v = tk[f"st.{f}"]
                setattr(st, f, v if v.ndim else v.item())
    return True


def _rebuilt_slots(extra, kf_slots, kf_id):
    """F7: a file without `free_slots` / `hist_ids` (written before they were
    saved) gets them rebuilt, not emptied: the free slots are those below the
    allocation high-water mark that hold no active keyframe, and each active
    slot's histogram belongs to its keyframe."""
    nxt = extra.get("next_fresh_slot", (max(kf_slots) + 1) if kf_slots else 0)
    free = extra.get("free_slots")
    if free is None:
        free = [s for s in range(nxt) if s not in set(kf_slots)]
    hist_ids = extra.get("hist_ids")
    if hist_ids is None:
        hist_ids = {s: int(kf_id[s]) for s in kf_slots}
    return nxt, list(free), {int(k): int(v) for k, v in hist_ids.items()}


def load_system(path, sys):
    """Restore a SlamSystem in place (constructed with matching capacities)
    and reseat tracking at the newest keyframe, as the JAX package does: its
    pose and NavState, no prior, a zero velocity model, the frame caches
    dropped; then `.track.npz`, where the save wrote one, puts back what the
    tracker carried beside that pose. A mesh set by `enable_mesh` stays set.
    Raises ValueError on a capacity mismatch."""
    m, extra = load_map(path, sys.device)
    if (m.K, m.P, m.F) != (sys.cfg.max_kf, sys.cfg.max_mp, sys.cfg.n_feat):
        raise ValueError(f"checkpoint capacities (K, P, F) = {(m.K, m.P, m.F)} do not match "
                         f"the system's {(sys.cfg.max_kf, sys.cfg.max_mp, sys.cfg.n_feat)}")
    host = np.concatenate([m.kf_time.cpu().numpy().astype(np.float64)[:, None],
                           m.kf_id.cpu().numpy().astype(np.float64)[:, None],
                           (m.kf_ur >= 0).any(1).cpu().numpy()[:, None]], 1)   # one pull
    kf_slots = [int(s) for s in extra["kf_slots"]]
    nxt, free, hist_ids = _rebuilt_slots(extra, kf_slots, host[:, 1].astype(np.int64))
    st = mapping_ctl.MappingState(
        kf_slots=kf_slots, last_kf_slot=int(extra["last_kf_slot"]),
        vi_inited=bool(extra["vi_inited"]), n_kf=int(extra["n_kf"]),
        last_kf_frame=int(extra["last_kf_frame"]), first_kf_time=extra["first_kf_time"],
        broken_chain_slots={int(s) for s in extra.get("broken_chain_slots", [])},
        loop_edges=[tuple(int(x) for x in e) for e in extra.get("loop_edges", [])],
        n_loops_closed=int(extra.get("n_loops_closed", 0)), free_slots=free,
        next_fresh_slot=int(nxt),
        kf_time_host={s: float(host[s, 0]) for s in kf_slots},
        kf_id_host={s: int(host[s, 1]) for s in kf_slots},
        sensor_depth=bool(host[kf_slots, 2].any()) if kf_slots else False,
        mesh=sys.st.mesh, mesh_e=sys.st.mesh_e)     # the system's, not the file's
    st.kf_imu_raw = {int(k): torch.as_tensor(np.asarray(v, np.float32).reshape(-1, 7),
                                             device=sys.device)
                     for k, v in extra["kf_imu_raw"].items()}
    sys.m, sys.st = m, st
    sys.fl = frameloop.LoopState()
    sys.frame_id = int(extra["frame_id"])
    sys.state = int(extra["state"])
    sys._ref, sys._init_rows = None, []
    det = sys.loop
    det.hist_ids = hist_ids
    det.consistent_groups = []
    try:
        with np.load(str(path) + ".bow.npz") as bow:
            det.hists = torch.as_tensor(bow["hists"], device=sys.device)
            det.vocab = torch.as_tensor(bow["vocab"], device=sys.device)
    except FileNotFoundError:
        pass
    traj = TrajStore()
    try:
        with np.load(str(path) + ".traj.npz") as tj:
            traj.block = [torch.as_tensor(tj[k], device=sys.device)
                          for k in ("P_rel", "R_rel", "P_abs", "R_abs")]
            traj.meta = [(float(t), int(s), int(k))
                         for t, s, k in zip(tj["t"], tj["slot"], tj["kid"])]
    except FileNotFoundError:
        pass
    sys.traj = traj
    if st.last_kf_slot < 0 or not kf_slots:
        # saved before the map existed: the next frame starts the bootstrap
        sys.ts, sys.state = None, NO_IMAGES_YET
        return sys
    slot = st.last_kf_slot
    ts = tracking_ctl.start_tracking(m, st, sys.cfg.g_mag, float(host[slot, 0]), traj=traj)
    ts.gw = torch.as_tensor(np.asarray(extra["gw"], np.float32), device=sys.device)
    if st.vi_inited:
        ts.ns = mapping_ctl.keyframe_navstate(m, slot)
    ts.state = LOST if sys.state == LOST else OK
    sys.ts = ts
    sys.last_time = float(host[slot, 0])
    if _load_tracker(str(path) + ".track.npz", ts, st, sys.device):
        sys.last_time = ts.last_time
    return sys
