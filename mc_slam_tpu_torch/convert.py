"""State carried across from the JAX package: numpy <-> the port's NamedTuples.

The JAX side is handed over as dicts or NamedTuples of numpy arrays (the
caller flattens JAX arrays with `np.asarray`); this module never sees a JAX
type. Conversion is field by field, by the port class's field names and
annotations, with dtypes kept exactly (float32, int32, bool, int8). Two
changes of dtype: packed descriptor words (uint32 on the JAX side, fields in
PACKED_FIELDS) become int32 tensors holding the same bits, because
torch.uint32 has few operators, on CUDA least of all; `to_numpy` turns them
back into uint32. And the index columns of the solver tables (INDEX_FIELDS:
VisualObs.cam / pt, IMUEdges.i / j, PriorFactor.cam, Sim3Graph.ei / ej) become
int64, what torch gathers with.

Any NamedTuple of the port converts: MapState, Features, NavState,
PreintState, Camera, Extrinsics, PriorFactor, and the bootstrap's
TwoViewResult, VIInitResult, VisualObs, IMUEdges (nested PreintState) and the
pose graph's Sim3Graph.

The host bookkeeping of a SlamSystem goes across as a plain dict
(`host_state_to_dict` / `host_state_from_dict`): the fields of MappingState
under the JAX class's attribute names, raw IMU rows as numpy, and the
TrajStore's rows and meta. A parity test sets the dict's entries on a JAX
SlamSystem and so hands one state to both systems. The loop detector's state
goes the same way (`detector_to_dict` / `detector_from_dict`: the histogram
table, the slot -> id mirror, the consistency groups, vocabulary and idf).
"""
from __future__ import annotations

import typing
from collections.abc import Mapping

import numpy as np
import torch

from mc_slam_tpu_torch.device import resolve

PACKED_FIELDS = frozenset({"desc", "kf_desc", "mp_desc"})
INDEX_FIELDS = frozenset({"cam", "pt", "i", "j", "ei", "ej"})


def _is_namedtuple_class(t):
    return isinstance(t, type) and issubclass(t, tuple) and hasattr(t, "_fields")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # a private C-ordered copy (np.ascontiguousarray would turn 0-d into 1-d)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def to_torch(cls, src, device=None):
    """Build the port NamedTuple `cls` from `src` (a dict or an object with
    the same field names), with every array field a tensor on `device`.
    Nested NamedTuple fields (MapState.kf_ns, PriorFactor.ns0, ...) convert
    recursively; int fields (Camera.width/height) stay Python ints; None
    stays None."""
    device = resolve(device)
    hints = typing.get_type_hints(cls)
    out = {}
    for f in cls._fields:
        if isinstance(src, Mapping):
            if f not in src:
                continue        # a defaulted field the source does not carry
            v = src[f]
        else:
            v = getattr(src, f)
        t = hints.get(f)
        if v is None:
            out[f] = None
        elif _is_namedtuple_class(t):
            out[f] = to_torch(t, v, device)
        elif t is int:
            out[f] = int(v)
        else:
            out[f] = _tensor(v, device)
            if f in INDEX_FIELDS:
                out[f] = out[f].to(torch.int64)
    return cls(**out)


def to_numpy(obj):
    """A port NamedTuple (or tensor) -> dict of numpy arrays, recursively;
    PACKED_FIELDS come back as uint32."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    out = {}
    for f, v in obj._asdict().items():
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            out[f] = a.view(np.uint32) if f in PACKED_FIELDS else a
        elif v is None or isinstance(v, (int, float)):
            out[f] = v
        else:
            out[f] = to_numpy(v)
    return out


# MappingState field -> the JAX SlamSystem attribute that holds the same thing
HOST_FIELDS = {
    "kf_slots": "kf_slots", "free_slots": "free_slots",
    "next_fresh_slot": "next_fresh_slot", "last_kf_slot": "last_kf_slot",
    "last_kf_frame": "last_kf_frame", "n_kf": "n_kf", "first_kf_time": "first_kf_time",
    "vi_inited": "vi_inited", "kf_time_host": "kf_time_host", "kf_id_host": "kf_id_host",
    "broken_chain_slots": "broken_chain_slots", "loop_edges": "loop_edges",
    "chain_break_pending": "_chain_break_pending", "ref_tracked": "_ref_tracked_cache",
    "n_loops_closed": "n_loops_closed", "last_loop_nkf": "_last_loop_nkf",
    "sensor_depth": "sensor_depth"}


def host_state_to_dict(st, traj=None):
    """The MappingState `st` (and the TrajStore `traj`) as a dict of Python
    and numpy values keyed by the JAX SlamSystem's attribute names, plus
    "kf_imu_raw" (slot -> (T, 7) numpy), "covis_row" (numpy or None; the JAX
    class keeps it as `_covis_row_cache = (slot, row)`), and, with `traj`,
    "traj_rows" (four stacked numpy arrays or None) and "traj_meta"."""
    import copy
    out = {jax_name: copy.deepcopy(getattr(st, f)) for f, jax_name in HOST_FIELDS.items()}
    out["kf_imu_raw"] = {k: v.detach().cpu().numpy() for k, v in st.kf_imu_raw.items()}
    out["covis_row"] = None if st.covis_row is None else np.array(st.covis_row)
    if traj is not None:
        blk = traj._stack()
        out["traj_rows"] = None if blk is None else [b.detach().cpu().numpy() for b in blk]
        out["traj_meta"] = list(traj.meta)
    return out


def host_state_from_dict(d, device=None):
    """The inverse: (MappingState, TrajStore) on `device` from such a dict
    (made here, or read off a JAX SlamSystem by the caller)."""
    from mc_slam_tpu_torch.pipeline.mapping_ctl import MappingState
    from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
    device = resolve(device)
    st = MappingState(**{f: d[jax_name] for f, jax_name in HOST_FIELDS.items()
                         if jax_name in d})
    st.kf_slots, st.free_slots = list(st.kf_slots), list(st.free_slots)
    st.broken_chain_slots = set(st.broken_chain_slots)
    st.kf_imu_raw = {int(k): _tensor(np.asarray(v, np.float32), device)
                     for k, v in d["kf_imu_raw"].items()}
    st.covis_row = None if d.get("covis_row") is None else np.array(d["covis_row"], np.float32)
    traj = TrajStore()
    if d.get("traj_rows") is not None:
        traj.block = [_tensor(a, device) for a in d["traj_rows"]]
        traj.meta = [tuple(x) for x in d["traj_meta"]]
    return st, traj


def detector_to_dict(det):
    """The state of a `LoopDetector` as numpy and Python values, under the
    JAX class's attribute names: hists (K, W), hist_ids, consistent_groups,
    min_consistency, vocab (W, 256) int8, idf (W,) or None."""
    import copy
    return dict(hists=det.hists.detach().cpu().numpy(), hist_ids=dict(det.hist_ids),
                consistent_groups=copy.deepcopy(det.consistent_groups),
                min_consistency=det.min_consistency,
                vocab=det.vocab.detach().cpu().numpy(),
                idf=None if det.idf is None else det.idf.detach().cpu().numpy())


def detector_from_dict(d, device=None):
    """The inverse: a `LoopDetector` on `device` (from a dict made here, or
    read off a JAX detector by the caller with `np.asarray`)."""
    from mc_slam_tpu_torch.pipeline.loopclosing import LoopDetector
    device = resolve(device)
    hists = np.asarray(d["hists"], np.float32)
    det = LoopDetector(_tensor(np.asarray(d["vocab"], np.int8), device), hists.shape[0],
                       min_consistency=int(d.get("min_consistency", 3)),
                       idf=None if d.get("idf") is None
                       else _tensor(np.asarray(d["idf"], np.float32), device))
    det.hists = _tensor(hists, device)
    det.hist_ids = {int(k): int(v) for k, v in d["hist_ids"].items()}
    det.consistent_groups = [(frozenset(int(x) for x in g), int(c))
                             for g, c in d["consistent_groups"]]
    return det
