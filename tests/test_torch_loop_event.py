"""One loop event on a planted seam, against the JAX package on the converted
state: `loopclosing.sim3_ransac_batch`, `guided_match_count`, and the whole
`loopctl.try_close_loop` against `SlamSystem._try_close_loop`.

The map comes from chip_smoke.py's path 5 on the CPU
(torch_port_helpers.revisit_run: K = 16, P = 2048, F = 512; two keyframes
inserted after the relocalization) with `chip_smoke.plant_seam` applied, the
construction of chip_smoke.py's phase "loop": the keyframes inserted since
the place was first seen get their own copies of their landmarks and a drift
of 0.2 m / 3 degrees that grows along the chain. RANSAC: the JAX functions
draw their 300 x 3 samples from keys; the harness repeats the key splits
(`jax_samples`) and gives the port the same index sets.

Tolerances: candidate lists, decisions and match counts exact (guided count
within 2: a ratio test on a tie); packed Sim3 rows 1e-3; after the closure
keyframe positions 2e-3 m (1.2 mm seen: the pose graph's 40 LM iterations
stall on this stiff graph, most steps are refused, and which are is decided
at float32 rounding; the whole-map BA then holds the oldest keyframe where
the pose graph left it), without the newest keyframe, whose result the JAX
whole-map BA overwrites with a stale padded copy (13 keyframes padded to 16
with copies of the last slot)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mc_slam_tpu.pipeline import loopclosing as jlc
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch import lie as tlie
from mc_slam_tpu_torch.frontend import matching
from mc_slam_tpu_torch.pipeline import loopclosing as tlc, loopctl
from mc_slam_tpu_torch.slam_map.mapstate import covisibility_matrix

from torch_port_helpers import (REVISIT_FRAMES, REVISIT_SRC, jax_cam, jax_ext, jax_map,
                                jax_samples, jax_system_from_port, revisit_run)

torch.set_num_threads(2)


def _planted():
    """(slam copy, planted map, poses before the drift, revisit, spread)."""
    seq, cam, ext, slam0, rv, _ = revisit_run()
    slam = copy.deepcopy(slam0)
    st = slam.st
    src_end = REVISIT_SRC + REVISIT_FRAMES - 1
    revisit = rv["new_kf"]
    spread = [s for s in rv["kf_before"] if st.kf_id_host[s] > src_end]
    assert len(revisit) == 2 and len(spread) == 3
    axis = torch.tensor([0.3, 0.2, 0.93])
    R_d = tlie.so3_exp(axis / axis.norm() * float(np.radians(chip_smoke.SEAM_ROT_DEG)))
    c = slam.m.kf_ns.P[revisit[-1]]
    t_d = torch.tensor(chip_smoke.SEAM_T) + c - R_d @ c
    m1, before = chip_smoke.plant_seam(slam.m, st, revisit, spread, R_d, t_d)
    return slam, cam, m1, before, revisit, spread


def _sim3_weights(m, cur, cands):
    ks = torch.as_tensor(cands, dtype=torch.int64)
    has_c = (m.kf_mp[cur] >= 0) & m.kf_feat_valid[cur]
    has_l = (m.kf_mp[ks] >= 0) & m.kf_feat_valid[ks]
    return matching.mutual_match(m.kf_pm1[cur], has_c, m.kf_pm1[ks], has_l,
                                 max_dist=matching.TH_LOW, ratio=0.9,
                                 angle_a=m.kf_angle[cur], angle_b=m.kf_angle[ks])[2]


def _samples(keys, okm):
    return torch.from_numpy(np.stack([
        jax_samples(keys[c], jnp.asarray(okm[c].numpy(), jnp.float32), 300, 3)
        for c in range(okm.shape[0])]).astype(np.int64))


def test_plant_seam_separates_the_sides_and_keeps_the_views():
    """The construction itself: the new side shares no landmark with the
    older keyframes, every new-side keyframe still sees its landmarks where
    it saw them (copies moved rigidly with it where a revisit keyframe holds
    them), and the drift grows along the chain."""
    slam, cam, m1, before, revisit, spread = _planted()
    m0, st = slam.m, slam.st
    new = spread + revisit
    old = [s for s in st.kf_slots if s not in new]
    W0, W1 = covisibility_matrix(m0).numpy(), covisibility_matrix(m1).numpy()
    assert W0[np.ix_(revisit, old)].max() > 100 and W1[np.ix_(new, old)].max() == 0
    np.testing.assert_array_equal(W1[np.ix_(revisit, revisit)], W0[np.ix_(revisit, revisit)])
    moved = (m1.kf_ns.P - before["P"]).norm(dim=1).numpy()
    assert np.all(moved[old] == 0) and np.all(np.diff(moved[spread]) > 0)
    assert np.all(moved[revisit] > moved[spread[-1]] - 0.02)
    np.testing.assert_allclose(moved[revisit[-1]], np.linalg.norm(chip_smoke.SEAM_T), atol=1e-5)
    # a revisit keyframe's landmarks in its own body frame: unchanged
    k = revisit[0]
    held = (m0.kf_mp[k] >= 0) & m0.kf_feat_valid[k]
    body = lambda m: (m.kf_ns.R[k].T @ (m.mp_pos[m.kf_mp[k][held].long()] - m.kf_ns.P[k]).T).T
    np.testing.assert_allclose(body(m1).numpy(), body(m0).numpy(), atol=1e-4)
    assert before["n_copied"] > 300 and int(m1.mp_active.sum()) > int(m0.mp_active.sum())


def test_sim3_ransac_batch_and_guided_count_match_jax():
    slam, cam, m1, before, revisit, spread = _planted()
    cur, cands = revisit[0], [6, 5, 6]
    bars = [20, 40, 1 << 20]
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    okm = _sim3_weights(m1, cur, cands)
    assert okm.sum(dim=1).min() > 60
    got, costs = tlc.sim3_ransac_batch(
        m1, _samples(keys, okm), cur, torch.as_tensor(cands), torch.as_tensor(bars), cam,
        ext=slam.ext, fix_scale=True, curve=True)
    got = got.numpy()
    jm = jax.tree_util.tree_map(jnp.asarray, jax_map(m1))
    ref = np.asarray(jlc.sim3_ransac_batch(
        jm, keys, jnp.asarray(cur, jnp.int32), jnp.asarray(cands, jnp.int32),
        jnp.asarray(bars, jnp.int32), jax_cam(cam), ext=jax_ext(), fix_scale=True))
    assert got.shape == ref.shape == (3, 15)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    assert got[:, 0].tolist() == [1.0, 1.0, 0.0]                 # the pad bar rejects
    np.testing.assert_allclose(got[:, 1], ref[:, 1], atol=2)     # inlier counts
    np.testing.assert_array_equal(got[:, 2], 1.0)                # SE3 after VI init
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], atol=1e-3)
    assert np.all(np.diff(costs.numpy(), axis=0) <= 0)
    # the single-candidate form, and the guided verification of its result
    one = tlc.compute_sim3_for_loop(m1, _samples(keys, okm)[0], cur, 6, cam, fix_scale=True,
                                    ext=slam.ext)
    assert bool(one.ok) and int(one.n_inliers) == int(got[0, 1])
    np.testing.assert_allclose(one.t.numpy(), got[0, 12:15], atol=1e-6)
    grp = [6, 5, 7, 6, 6]
    s, R, t = got[0, 2], got[0, 3:12].reshape(3, 3), got[0, 12:15]
    n_t = int(tlc.guided_match_count(m1, cur, 6, torch.as_tensor(grp), torch.as_tensor(s),
                                     torch.from_numpy(R), torch.from_numpy(t), cam,
                                     ext=slam.ext))
    n_j = int(jlc.guided_match_count(jm, jnp.asarray(cur, jnp.int32), jnp.asarray(6, jnp.int32),
                                     jnp.asarray(grp, jnp.int32), jnp.asarray(s),
                                     jnp.asarray(R), jnp.asarray(t), jax_cam(cam),
                                     ext=jax_ext()))
    assert abs(n_t - n_j) <= 2 and n_t >= 100
    # a Sim3 that is a metre off projects the group past its matches
    n_off = int(tlc.guided_match_count(m1, cur, 6, torch.as_tensor(grp), torch.ones(()),
                                       torch.from_numpy(R), torch.from_numpy(t) + 1.0, cam,
                                       ext=slam.ext))
    assert n_off < 40


def test_try_close_loop_matches_jax(monkeypatch):
    """The whole event on both sides: the detector's candidate list, the Sim3
    batch's decisions, the guided count (within 2), the accepted candidate,
    the "loop" event, the persisted edge and the cooldown; keyframe positions
    2e-3 m (rotations 1e-3), tracking re-seated on the corrected keyframe;
    the port's seam covisibility at least 10 and its revisit keyframes back
    within 3 cm of where they stood before the drift."""
    slam, cam, m1, before, revisit, spread = _planted()
    st, ts, loop = slam.st, slam.ts, slam._loopctx
    cur = revisit[0]
    loop.detector.consistent_groups = []
    js = jax_system_from_port(monkeypatch, cam, m1, st, frame_id=slam.frame_id)
    d = convert.detector_to_dict(slam.loop)
    js.loop.hists, js.loop.hist_ids = jnp.asarray(d["hists"]), d["hist_ids"]
    js.loop.consistent_groups = []
    js.gw = jnp.asarray(ts.gw.numpy())
    # the candidates, to repeat the key splits of _try_close_loop
    probe = copy.deepcopy(loop.detector)
    cands = probe.detect(m1, cur, list(st.kf_slots), kf_ids=st.kf_id_host)
    todo = [c for c, s_ in cands if s_][:2] + [c for c, s_ in cands if not s_][:1]
    pad = (todo + [todo[0]] * 3)[:3]
    _, sub = jax.random.split(js.key)
    idx = _samples(jax.random.split(sub, 3), _sim3_weights(m1, cur, pad))

    n_ev = len(slam.events)
    m2, out = loopctl.try_close_loop(m1, st, slam.cfg, ts, loop, cur, slam.frame_id, cam,
                                     slam.ext, slam.noise, idx=idx)
    js._try_close_loop(cur)
    ev_t = {e[1]: e[2] for e in slam.events[n_ev:]}
    ev_j = {e[1]: e[2] for e in js.events}
    assert out.cands == cands and ev_t["lc_diag"] == ev_j["lc_diag"]
    assert ev_t["sim3_dispatch"] == ev_j["sim3_dispatch"]
    assert ev_t["sim3_result"]["cands"] == ev_j["sim3_result"]["cands"]
    assert ev_t["sim3_result"]["ok"] == ev_j["sim3_result"]["ok"]
    np.testing.assert_allclose(ev_t["sim3_result"]["n_in"], ev_j["sim3_result"]["n_in"], atol=2)
    assert ev_t["verify_result"]["cand"] == ev_j["verify_result"]["cand"]
    assert abs(ev_t["verify_result"]["n_guided"] - ev_j["verify_result"]["n_guided"]) <= 2
    assert ev_t["verify_result"]["n_guided"] >= loopctl.MIN_GUIDED
    lt, lj = ev_t["loop"], ev_j["loop"]
    assert (lt["cur"], lt["cand"], lt["cur_fid"], lt["cand_fid"]) == \
        (lj["cur"], lj["cand"], lj["cur_fid"], lj["cand_fid"])
    assert abs(lt["corr_m"] - lj["corr_m"]) <= 2e-3 and lt["s"] == lj["s"] == 1.0
    assert out.closed == lt and lt["cand"] not in spread + revisit
    assert st.n_loops_closed == js.n_loops_closed == 1
    assert st.loop_edges == js.loop_edges == [(lt["cand"], cur)]
    assert st.last_loop_nkf == js._last_loop_nkf == st.n_kf
    assert not loopctl.loop_gates_open(st, slam.cfg, loop)       # the 10-keyframe cooldown

    newest = st.kf_slots[-1]
    ks = [s for s in st.kf_slots if s != newest]
    np.testing.assert_allclose(m2.kf_ns.P[ks].numpy(), np.asarray(js.m.kf_ns.P)[ks], atol=2e-3)
    np.testing.assert_allclose(m2.kf_ns.R[ks].numpy(), np.asarray(js.m.kf_ns.R)[ks], atol=1e-3)
    # the fused associations: a 4 px gate on poses a millimetre apart may
    # fall either way for a few of the 6144 features
    differ = (m2.kf_mp[ks].numpy() >= 0) != (np.asarray(js.m.kf_mp)[ks] >= 0)
    assert differ.sum() <= 6
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.last_pose[0]), atol=1e-3)
    np.testing.assert_allclose(ts.ns.V.numpy(), np.asarray(js.last_ns.V), atol=5e-3)
    assert ts.prior is None and js.prior is None

    old = [s for s in st.kf_slots if s not in spread + revisit]
    W = covisibility_matrix(m2).numpy()
    assert W[np.ix_(revisit, old)].max() >= 10
    back = (m2.kf_ns.P[revisit] - before["P"][revisit]).norm(dim=1).max()
    assert float(back) < chip_smoke.SEAM_POSE_TOL
    for c in out.curves.values():
        c = np.asarray(c).reshape(len(c), -1)
        assert np.isfinite(c).all() and np.all(np.diff(c, axis=0) <= 1e-6 * np.abs(c[:-1]))
