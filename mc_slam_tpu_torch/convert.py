"""State carried across from the JAX package: numpy <-> the port's NamedTuples.

The JAX side is handed over as dicts or NamedTuples of numpy arrays (the
caller flattens JAX arrays with `np.asarray`); this module never sees a JAX
type. Conversion is field by field, by the port class's field names and
annotations, with dtypes kept exactly (float32, int32, bool, int8). Two
changes of dtype: packed descriptor words (uint32 on the JAX side, fields in
PACKED_FIELDS) become int32 tensors holding the same bits, because
torch.uint32 has few operators, on CUDA least of all; `to_numpy` turns them
back into uint32. And the index columns of the solver tables (INDEX_FIELDS:
VisualObs.cam / pt, IMUEdges.i / j, PriorFactor.cam) become int64, what
torch gathers with.

Any NamedTuple of the port converts: MapState, Features, NavState,
PreintState, Camera, Extrinsics, PriorFactor, and the bootstrap's
TwoViewResult, VIInitResult, VisualObs and IMUEdges (nested PreintState).
"""
from __future__ import annotations

import typing
from collections.abc import Mapping

import numpy as np
import torch

from mc_slam_tpu_torch.device import resolve

PACKED_FIELDS = frozenset({"desc", "kf_desc", "mp_desc"})
INDEX_FIELDS = frozenset({"cam", "pt", "i", "j"})


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
