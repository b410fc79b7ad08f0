"""Per-frame trajectory log (port of mc_slam_tpu/pipeline/trajstore.py).

One row per tracked frame, stored RELATIVE to the reference keyframe at
track time (Tracking::mlRelativeFramePoses, src/Tracking.cpp:1123-1134) and
composed against the current keyframe poses when the trajectory is read
(System::SaveTrajectoryTUM): VI-init rescaling and BA refinements reach
every past frame through its keyframe. Rows stay device tensors, the tuples
the per-frame programs return; the host keeps only (t, anchor slot, anchor
keyframe id). Nothing is copied to the host before `compose`.

The JAX package keeps fixed-size device buffers written in blocks of 64 rows
and a host archive for what overflows them; here the rows are a list of
pending tuples and one stacked block that grows, so `reparent`, `truncate`,
`replace_at` and `pop_last` are a few lines each.
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

    def flush(self):
        """Stack the pending rows (the JAX package's flush of its device
        buffers); reading methods do it themselves."""
        self._stack()

    def pop_last(self):
        """Discard the most recent row (its frame turned out LOST)."""
        if self.meta:
            self.truncate(len(self.meta) - 1)

    def truncate(self, n_keep: int):
        """Drop every row at index >= n_keep (a LOST frame invalidates all
        rows recorded after it)."""
        drop = len(self.meta) - n_keep
        if drop <= 0:
            return
        n_pend = min(drop, len(self.pend))
        del self.pend[len(self.pend) - n_pend:]
        if drop > n_pend:
            self.block = [b[:n_keep] for b in self.block]
        del self.meta[n_keep:]

    def replace_at(self, i: int, row):
        """Replace row i (a fallback solved that frame again)."""
        pend_start = len(self.meta) - len(self.pend)
        if i >= pend_start:
            self.pend[i - pend_start] = tuple(row)
        else:
            self.block = [b.index_copy(0, torch.as_tensor([i], device=b.device), r[None])
                          for b, r in zip(self.block, row)]

    def replace_last(self, row):
        self.replace_at(len(self.meta) - 1, row)

    def reparent(self, slot: int, kid: int, heir: int, heir_kid: int, P_hk, R_hk):
        """Re-anchor the rows recorded against the culled keyframe
        (slot, kid) onto its heir: the stored relative pose is composed
        through the culled keyframe's pose in the heir's frame,
        P' = P_hk + R_hk P, R' = R_hk R (KeyFrame::SetBadFlag parenting).
        P_hk (3,), R_hk (3, 3): numpy."""
        hit = [i for i, (_, k, kd) in enumerate(self.meta) if k == slot and kd == kid]
        if not hit:
            return
        prel, rrel, pabs, rabs = self._stack()
        dev = prel.device
        idx = torch.as_tensor(hit, device=dev)
        P_hk = torch.as_tensor(np.asarray(P_hk, np.float32), device=dev)
        R_hk = torch.as_tensor(np.asarray(R_hk, np.float32), device=dev)
        self.block = [prel.index_copy(0, idx, P_hk + prel[idx] @ R_hk.T),
                      rrel.index_copy(0, idx, R_hk @ rrel[idx]), pabs, rabs]
        for i in hit:
            self.meta[i] = (self.meta[i][0], heir, heir_kid)

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
