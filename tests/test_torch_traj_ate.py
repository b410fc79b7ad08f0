"""The small host-side pieces of the bootstrap slice against the JAX
package: the trajectory log (append / rescale / compose, and reparent /
truncate / replace_at / replace_last / pop_last before and after a rescale;
composed poses to 1e-5), the ATE module (a
numpy copy: identical results), the batched preintegration (equal to one
sequence at a time, to float32 rounding), and conversion of the bootstrap's
result tuples field by field."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.eval import ate as jate
from mc_slam_tpu.geometry.init2view import TwoViewResult as JTwoView
from mc_slam_tpu.pipeline.trajstore import TrajStore as JTrajStore
from mc_slam_tpu.pipeline.viinit import VIInitResult as JVIInit
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.eval import ate as tate
from mc_slam_tpu_torch.geometry.init2view import TwoViewResult
from mc_slam_tpu_torch.imu.preintegration import (euroc_noise, preintegrate,
                                                  preintegrate_batch)
from mc_slam_tpu_torch.pipeline.trajstore import TrajStore
from mc_slam_tpu_torch.pipeline.viinit import VIInitResult
from mc_slam_tpu_torch.solver.ba import VisualObs

torch.set_num_threads(2)


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def test_trajstore_matches_jax(rng):
    """Rows anchored on three keyframes, one of them gone at read time; a
    rescale between two blocks of appends."""
    js, ts = JTrajStore(cap=64), TrajStore()
    K = 4
    kf_P = rng.normal(size=(K, 3)).astype(np.float32)
    kf_R = np.stack([_rot(rng) for _ in range(K)])
    kf_id = np.array([0, 7, 19, -1], np.int32)
    kf_active = np.array([True, True, False, False])
    rows = []
    for i in range(30):
        row = (rng.normal(size=3).astype(np.float32), _rot(rng),
               rng.normal(size=3).astype(np.float32), _rot(rng))
        k = i % 3
        meta = (0.05 * i, k, int(kf_id[k]) if i != 13 else 99)    # row 13: a recycled slot
        rows.append((row, meta))
    for n, (row, meta) in enumerate(rows):
        js.append(tuple(jnp.asarray(a) for a in row), *meta)
        ts.append(tuple(torch.from_numpy(a) for a in row), *meta)
        if n == 17:
            js.rescale(3.5)
            ts.rescale(torch.tensor(3.5))
    assert len(ts) == len(js) == 30
    ref = js.compose(kf_P, kf_R, kf_id, kf_active)
    got = ts.compose(torch.from_numpy(kf_P), torch.from_numpy(kf_R), torch.from_numpy(kf_id),
                     torch.from_numpy(kf_active))
    assert len(got) == len(ref) == 30
    for (t0, P0, R0), (t1, P1, R1) in zip(ref, got):
        assert t0 == t1
        np.testing.assert_allclose(P1, P0, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(R1, R0, rtol=1e-5, atol=1e-5)
    assert TrajStore().compose(kf_P, kf_R, kf_id, kf_active) == []

def _row(rng):
    return (rng.normal(size=3).astype(np.float32), _rot(rng),
            rng.normal(size=3).astype(np.float32), _rot(rng))


def _assert_same_traj(js, ts, kf, msg):
    kf_P, kf_R, kf_id, kf_active = kf
    ref = js.compose(kf_P, kf_R, kf_id, kf_active)
    got = ts.compose(*[torch.from_numpy(a) for a in kf])
    assert len(got) == len(ref) == len(ts) == len(js), msg
    assert [m[1:] for m in ts.meta] == [m[1:] for m in js.meta], msg
    for (t0, P0, R0), (t1, P1, R1) in zip(ref, got):
        assert t0 == t1
        np.testing.assert_allclose(P1, P0, rtol=1e-5, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(R1, R0, rtol=1e-5, atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("op", ["reparent", "truncate", "replace_at", "pop_last"])
def test_trajstore_edits_match_jax(rng, op):
    """One editing method on the same 80 rows (64 in the JAX store's device
    buffer, 16 pending), once before a rescale and once after it."""
    js, ts = JTrajStore(cap=128), TrajStore()
    K = 4
    kf = (rng.normal(size=(K, 3)).astype(np.float32), np.stack([_rot(rng) for _ in range(K)]),
          np.array([0, 7, 19, 23], np.int32), np.array([True, True, True, True]))
    for i in range(80):
        row, k = _row(rng), i % 3
        meta = (0.05 * i, k, int(kf[2][k]) if i != 13 else 99)   # row 13: a recycled slot
        js.append(tuple(jnp.asarray(a) for a in row), *meta)
        ts.append(tuple(torch.from_numpy(a) for a in row), *meta)
        if i == 40:
            ts.flush()                  # some rows stacked, some pending, as in a run

    def edit(n):
        if op == "reparent":
            # keyframe (slot 1, id 7) is culled; slot 3 (id 23) is its heir
            P_hk, R_hk = rng.normal(size=3).astype(np.float32), _rot(rng)
            js.reparent(1, 7, 3, 23, P_hk, R_hk)
            ts.reparent(1, 7, 3, 23, P_hk, R_hk)
            assert all(m[1] != 1 or m[2] != 7 for m in ts.meta)
            assert sum(m[1:] == (3, 23) for m in ts.meta) >= 20
            js.reparent(2, 555, 0, 0, P_hk, R_hk)       # no such rows: nothing changes
            ts.reparent(2, 555, 0, 0, P_hk, R_hk)
        elif op == "truncate":
            # the JAX store drops pending rows only; its buffer rows are then
            # overwritten by position, so compare a cut inside the pending part
            keep = 70 if n == 0 else 66
            js.truncate(keep)
            ts.truncate(keep)
            ts.truncate(keep + 5)                        # nothing to drop
            assert len(ts) == keep
        elif op == "replace_at":
            for i in ((5, 75) if n == 0 else (63, 64)):  # a stacked row and a pending one
                row = _row(rng)
                js.replace_at(i, tuple(jnp.asarray(a) for a in row))
                ts.replace_at(i, tuple(torch.from_numpy(a) for a in row))
            row = _row(rng)
            js.replace_last(tuple(jnp.asarray(a) for a in row))
            ts.replace_last(tuple(torch.from_numpy(a) for a in row))
        else:
            js.pop_last()
            ts.pop_last()

    edit(0)
    _assert_same_traj(js, ts, kf, f"{op} before the rescale")
    js.rescale(3.5)
    ts.rescale(torch.tensor(3.5))
    _assert_same_traj(js, ts, kf, f"{op}, then rescale")
    if op in ("truncate", "pop_last"):
        # after the rescale the JAX store has flushed everything; append anew
        for i in range(3):
            row = _row(rng)
            js.append(tuple(jnp.asarray(a) for a in row), 9.0 + i, 0, 0)
            ts.append(tuple(torch.from_numpy(a) for a in row), 9.0 + i, 0, 0)
    edit(1)
    _assert_same_traj(js, ts, kf, f"{op} after the rescale")


def test_trajstore_truncate_into_the_stacked_rows(rng):
    """The port's rows are one block: a cut below the pending part drops
    stacked rows too, and later appends follow them."""
    ts = TrajStore()
    rows = [_row(rng) for _ in range(10)]
    for i, row in enumerate(rows[:8]):
        ts.append(tuple(torch.from_numpy(a) for a in row), float(i), 0, 0)
        if i == 5:
            ts.flush()
    ts.truncate(3)
    assert len(ts) == 3 and ts.pend == [] and ts.block[0].shape[0] == 3
    ts.append(tuple(torch.from_numpy(a) for a in rows[9]), 9.0, 0, 0)
    out = ts.compose(np.zeros((1, 3), np.float32), np.eye(3, dtype=np.float32)[None],
                     np.zeros(1, np.int32), np.ones(1, bool))
    assert [o[0] for o in out] == [0.0, 1.0, 2.0, 9.0]
    np.testing.assert_allclose(out[3][1], rows[9][0], atol=1e-6)
    np.testing.assert_allclose(out[2][1], rows[2][0], atol=1e-6)
    ts.pop_last()
    ts.pop_last()
    assert len(ts) == 2
    TrajStore().pop_last()                               # empty: nothing happens


@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_copy_is_identical(rng, with_scale):
    t = np.arange(50) * 0.05
    P_gt = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    P_est = (P_gt @ _rot(rng).T) / 3.5 + rng.normal(size=(50, 3)) * 0.01 + 2.0
    a = jate.ate_rmse(t + 0.004, P_est, t, P_gt, with_scale=with_scale)
    b = tate.ate_rmse(t + 0.004, P_est, t, P_gt, with_scale=with_scale)
    assert a == b and a["n"] == 50
    if with_scale:
        assert abs(a["scale"] - 3.5) < 0.05 and a["rmse"] < 0.1
    assert tate.associate(t, t + 0.5) == jate.associate(t, t + 0.5)
    for u, v in zip(jate.horn_align(P_est, P_gt, with_scale), tate.horn_align(P_est, P_gt, with_scale)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_preintegrate_batch_equals_one_by_one(rng):
    noise = euroc_noise(device="cpu")
    bg = torch.tensor([0.003, -0.004, 0.002])
    ba = torch.tensor([0.03, -0.02, 0.05])
    lens = [40, 7, 25]
    seqs = []
    for n in lens:
        r = np.concatenate([rng.normal(size=(n, 3)) * 0.3, rng.normal(size=(n, 3)) * 2 + [0, 0, 9.8],
                            np.full((n, 1), 0.005)], 1).astype(np.float32)
        seqs.append(torch.from_numpy(r))
    T = max(lens)
    batch = torch.stack([torch.nn.functional.pad(s, (0, 0, 0, T - s.shape[0])) for s in seqs])
    got = preintegrate_batch(batch, bg, ba, noise)
    for b, s in enumerate(seqs):
        ref = preintegrate(s, bg, ba, noise)
        for f, a in zip(ref._fields, ref):
            g = getattr(got, f)[b]
            np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6 * max(float(a.abs().max()), 1.0), err_msg=f)
    np.testing.assert_allclose(got.dT.numpy(), np.array(lens) * 0.005, rtol=1e-6)


def test_bootstrap_results_convert_field_by_field(rng):
    N = 12
    tv = JTwoView(ok=jnp.asarray(True), used_h=jnp.asarray(False), R=jnp.eye(3),
                  t=jnp.asarray([1.0, 0, 0]), Xw=jnp.asarray(rng.normal(size=(N, 3)), jnp.float32),
                  good=jnp.asarray(rng.random(N) < 0.5), n_good=jnp.asarray(5, jnp.int32),
                  score_h=jnp.asarray(10.0), score_f=jnp.asarray(20.0))
    t = convert.to_torch(TwoViewResult, jax.tree_util.tree_map(np.asarray, tv), "cpu")
    assert t.ok.dtype == torch.bool and t.good.dtype == torch.bool and t.n_good.dtype == torch.int32
    back = convert.to_numpy(t)
    for f in JTwoView._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(tv, f)), err_msg=f)
    vi = JVIInit(bg=jnp.ones(3), ba=jnp.zeros(3), scale=jnp.asarray(3.5),
                 scale_star=jnp.asarray(3.4), gw=jnp.asarray([0, 0, -9.81]), Rwi=jnp.eye(3),
                 cond=jnp.arange(6.0)[::-1])
    t = convert.to_torch(VIInitResult, jax.tree_util.tree_map(np.asarray, vi), "cpu")
    assert t.scale.shape == () and t.cond.shape == (6,) and t.gw.dtype == torch.float32
    obs = dict(cam=np.arange(4, dtype=np.int32), pt=np.arange(4, dtype=np.int32)[::-1],
               uv=np.zeros((4, 2), np.float32), inv_sigma2=np.ones(4, np.float32),
               valid=np.ones(4, np.float32), ur=None)
    t = convert.to_torch(VisualObs, obs, "cpu")
    assert t.cam.dtype == t.pt.dtype == torch.int64 and t.ur is None
    assert t.pt.tolist() == [3, 2, 1, 0]
