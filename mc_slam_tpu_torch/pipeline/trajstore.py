"""Per-frame trajectory log (port of the append / rescale / compose part of
mc_slam_tpu/pipeline/trajstore.py).

One row per tracked frame, stored RELATIVE to the reference keyframe at
track time (Tracking::mlRelativeFramePoses, src/Tracking.cpp:1123-1134) and
composed against the current keyframe poses when the trajectory is read
(System::SaveTrajectoryTUM): VI-init rescaling and BA refinements reach
every past frame through its keyframe. Rows stay device tensors, the tuples
the per-frame programs return; the host keeps only (t, anchor slot, anchor
keyframe id). Nothing is copied to the host before `compose`.
"""
from __future__ import annotations

import numpy as np
import torch


class TrajStore:
    def __init__(self):
        self.block = None       # stacked (P_rel, R_rel, P_abs, R_abs) of older rows
        self.pend = []          # rows appended since the last stack
        self.meta = []          # (t, anchor_slot, anchor_kid) per row

    def __len__(self):
        return len(self.meta)

    def append(self, row, t, anchor_slot, anchor_kid):
        """row: (P_rel, R_rel, P_abs, R_abs) tensors of one frame."""
        self.pend.append(tuple(row))
        self.meta.append((t, anchor_slot, anchor_kid))

    def _stack(self):
        if self.pend:
            new = [torch.stack([r[i] for r in self.pend]) for i in range(4)]
            self.block = new if self.block is None else [
                torch.cat([a, b]) for a, b in zip(self.block, new)]
            self.pend = []
        return self.block

    def rescale(self, s):
        """Multiply every recorded translation by s (the VI-init metric
        rescale, Map::UpdateScale for the saved-frame list). s: float or 0-d
        tensor."""
        blk = self._stack()
        if blk is not None:
            self.block = [blk[0] * s, blk[1], blk[2] * s, blk[3]]

    def compose(self, kf_P, kf_R, kf_id, kf_active):
        """[(t, P, R)] composed against the given keyframe poses (numpy or
        tensors); rows whose anchor keyframe is gone keep their track-time
        absolute pose."""
        blk = self._stack()
        if blk is None:
            return []
        prel, rrel, pabs, rabs = (b.detach().cpu().numpy() for b in blk)
        kf_P, kf_R, kf_id, kf_active = (
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in (kf_P, kf_R, kf_id, kf_active))
        out = []
        for i, (t, k, kid) in enumerate(self.meta):
            if k >= 0 and kf_active[k] and kf_id[k] == kid:
                out.append((t, kf_P[k] + kf_R[k] @ prel[i], kf_R[k] @ rrel[i]))
            else:
                out.append((t, pabs[i], rabs[i]))
        return out
