"""Cross-sequence batching: track B sequences as one set of launches (port of
mc_slam_tpu/parallel/multiseq.py).

BASELINE.json config #4 ("all 11 EuRoC sequences batched on one host,
keyframe blocks sharded across chips"): every per-frame program is
fixed-shape, so a batch of per-sequence MapStates is a leading dim. The JAX
package gets the batch from `jax.vmap`; here the functions on the path take
the leading dim themselves (`extractor.extract` on (B, H, W) images,
`tracking.track_frame_visual` on a stacked MapState), so a step launches
about the kernels of ONE sequence, and the projection-search kernel and the
pose LM kernel each run the B problems in one launch a round (a batch axis
in the search's grid, a block a problem in the LM's).

One divergence: the JAX step hands the raw keypoints to tracking as ideal
pixels, which is right only for a camera without distortion (its test's).
The port's step undistorts them first (`camera.undistort_points`, as the
frame pipeline does); on an undistorted camera that moves them by float32
rounding only.

Scale-out is the "seq" mesh (`make_seq_mesh`): the batch is split evenly over
the mesh's shards, each shard runs one batched step on its device (pure data
parallelism, no cross-device traffic in the step), and the results come back
in sequence order on the mesh's first device.
"""
from __future__ import annotations

import torch

from mc_slam_tpu_torch.camera import undistort_points
from mc_slam_tpu_torch.frontend import extractor
from mc_slam_tpu_torch.parallel.dist_ba import Mesh, make_mesh, to_device
from mc_slam_tpu_torch.pipeline import tracking
from mc_slam_tpu_torch.utils.metrics import span


def stack_maps(maps):
    """List of per-sequence MapState -> batched MapState (B, ...)."""
    return _stack(maps)


def _stack(items):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    vals = [_stack(list(parts)) for parts in zip(*items)]
    return type(first)(*vals)


def batch_rows(x, sl):
    """The batch rows `sl` of a tensor or of every leaf of a NamedTuple."""
    if isinstance(x, torch.Tensor):
        return x[sl]
    return type(x)(*[batch_rows(v, sl) for v in x])


def make_batched_step(cam, ext, n_features=1024, n_levels=8, iters=10,
                      mesh: Mesh | None = None):
    """Build a batched extract + track step:
    step(ms, imgs, P0s, R0s) -> (P (B, 3), R (B, 3, 3), feat_mp (B, F),
    n_inliers (B,)) for a stacked map `ms`, images (B, H, W) and predicted
    poses P0s (B, 3), R0s (B, 3, 3). The features' undistorted pixels are
    the tracking pixels.

    With a mesh (`make_seq_mesh`), the sequence dim is split evenly over its
    shards (B must divide by the mesh size, as NamedSharding requires); each
    shard runs one batched step on its own device."""

    def step(ms, imgs, P0s, R0s):
        with span("multiseq.step"):
            f = extractor.extract(imgs, n_features=n_features, n_levels=n_levels)
            r = tracking.track_frame_visual(ms, f, undistort_points(cam, f.xy), cam, ext,
                                            P0s, R0s, iters=iters)
            return r.P, r.R, r.feat_mp, r.n_inliers

    if mesh is None:
        return step

    n = mesh.size
    cams = [to_device(cam, d) for d in mesh.devices]
    exts = [to_device(ext, d) for d in mesh.devices]

    def sharded_step(ms, imgs, P0s, R0s):
        B = imgs.shape[0]
        if B % n:
            raise ValueError(f"{B} sequences do not divide over {n} shards")
        per = B // n
        outs = []
        for k, dev in enumerate(mesh.devices):
            sl = slice(k * per, (k + 1) * per)
            with span("multiseq.step"):
                f = extractor.extract(imgs[sl].to(dev), n_features=n_features,
                                      n_levels=n_levels)
                r = tracking.track_frame_visual(
                    to_device(batch_rows(ms, sl), dev), f, undistort_points(cams[k], f.xy),
                    cams[k], exts[k], P0s[sl].to(dev), R0s[sl].to(dev), iters=iters)
                outs.append((r.P, r.R, r.feat_mp, r.n_inliers))
        dev0 = mesh.devices[0]
        return tuple(torch.cat([o[i].to(dev0) for o in outs]) for i in range(4))

    return sharded_step


def make_seq_mesh(n_devices=None, devices=None):
    """A "seq" mesh over `devices` (torch devices or their names; a device may
    appear more than once) or over the first `n_devices` visible GPUs."""
    return make_mesh(n_devices, axis="seq", devices=devices)
