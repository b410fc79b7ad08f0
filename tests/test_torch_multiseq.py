"""Parity of the port's batched multi-sequence step
(mc_slam_tpu_torch/parallel/multiseq.py) with the JAX package's
(mc_slam_tpu/parallel/multiseq.py), on tests/test_multiseq.py's own setup:
DotWorld maps built by its `make_seq` (JAX extraction), 480x360, 256
features, 3 levels, B = 4, 10 LM iterations. Both sides start from the same
numpy maps (the JAX maps carried across by `convert`). Each tolerance is
stated beside its assertion.

The step is held against the JAX one in its two stages (the JAX step is two
dispatches, `multiseq.py:36-48`): the batched extraction against the JAX
vmapped one, and the batched tracking on the JAX step's own features against
the JAX step's result. The whole step is not compared to 1e-3 m: the port's
extraction rounds the pyramid otherwise (tests/test_torch_frontend.py: up to
0.05 % of descriptor bits differ), and on this setup (a crude map, 20-40
inliers) such flips move a pose by centimetres on either package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_slam_tpu.frontend import extractor as jextractor
from mc_slam_tpu.parallel import multiseq as jmultiseq
from mc_slam_tpu_torch import convert
from mc_slam_tpu_torch.camera import make_camera
from mc_slam_tpu_torch.frontend import extractor
from mc_slam_tpu_torch.frontend.extractor import Features
from mc_slam_tpu_torch.parallel import multiseq
from mc_slam_tpu_torch.pipeline import tracking
from mc_slam_tpu_torch.slam_map.mapstate import MapState
from mc_slam_tpu_torch.solver import factors
from test_multiseq import CAM as J_CAM, EXT as J_EXT, make_seq

torch.set_num_threads(2)

B = 4
CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360, device="cpu")
EXT = factors.identity_extrinsics(device="cpu")
_np = lambda x: jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def case():
    """The JAX maps and frames of test_batched_equals_individual, the JAX
    batched step's result, and the port's maps built from the same numpy."""
    jmaps, imgs = [], []
    for b in range(B):
        m, img = make_seq(None, b)
        jmaps.append(m)
        imgs.append(np.asarray(img))
    jstep = jmultiseq.make_batched_step(J_CAM, J_EXT, n_features=256, n_levels=3)
    jms = jmultiseq.stack_maps(jmaps)
    jimgs = jnp.stack([jnp.asarray(i) for i in imgs])
    jout = jstep(jms, jimgs, jnp.zeros((B, 3)), jnp.broadcast_to(jnp.eye(3), (B, 3, 3)))
    # the step's first dispatch, as the step builds it
    jfeat = jax.jit(jax.vmap(lambda img: jextractor.extract(img, n_features=256,
                                                             n_levels=3)))(jimgs)
    maps = [convert.to_torch(MapState, _np(m)._asdict(), "cpu") for m in jmaps]
    return dict(jout=[np.asarray(x) for x in jout], jms=_np(jms), maps=maps,
                jfeat=_np(jfeat), imgs=torch.from_numpy(np.stack(imgs)))


def _pose0():
    return torch.zeros(B, 3), torch.eye(3).expand(B, 3, 3).contiguous()


@pytest.fixture(scope="module")
def port_step(case):
    step = multiseq.make_batched_step(CAM, EXT, n_features=256, n_levels=3)
    ms = multiseq.stack_maps(case["maps"])
    return step, ms, step(ms, case["imgs"], *_pose0())


def test_batched_extract_matches_jax(case):
    """Stage 1: the batched extraction against the JAX vmapped one: level and
    valid exact, xy within 1e-4 px, score within 2e-3, angle within 1e-4 rad
    (tests/test_torch_frontend.py's tolerances). Descriptor bits: DotWorld
    frames are flat between the dots, so many BRIEF tests compare two equal
    blurred pixels and the port's pyramid rounding flips them (the unbatched
    port extraction differs from the JAX one in ~1.2 % of the bits on these
    frames, measured; the JAX vmapped extraction equals the JAX single one).
    The batch adds none: per image, the batched port bits differ from the
    JAX ones exactly where the unbatched port bits do; under 2 % in all."""
    fb = extractor.extract(case["imgs"], n_features=256, n_levels=3)
    ft = convert.to_numpy(fb)
    fj = case["jfeat"]._asdict()
    assert ft["xy"].shape == (B, 256, 2)
    for k in ("level", "valid"):
        np.testing.assert_array_equal(fj[k], ft[k])
    np.testing.assert_allclose(fj["xy"], ft["xy"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(fj["score"], ft["score"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(fj["angle"], ft["angle"], rtol=0, atol=1e-4)
    for b in range(B):
        single = extractor.extract(case["imgs"][b], n_features=256, n_levels=3)
        np.testing.assert_array_equal(fj["desc_pm1"][b] != ft["desc_pm1"][b],
                                      fj["desc_pm1"][b] != single.desc_pm1.numpy())
    n_bits_differ = int((fj["desc_pm1"] != ft["desc_pm1"]).sum())
    assert n_bits_differ <= 0.02 * fj["desc_pm1"].size, n_bits_differ


def test_batched_track_matches_jax_step(case):
    """Stage 2: the port's batched tracking on the JAX step's features
    (carried across) against the JAX batched step: positions within 1e-3 m
    and inliers within 2 (tests/test_multiseq.py's own tolerances for vmap
    against per-sequence), each sequence above 15 inliers."""
    ms = multiseq.stack_maps(case["maps"])
    f = convert.to_torch(Features, case["jfeat"]._asdict(), "cpu")
    r = tracking.track_frame_visual(ms, f, f.xy, CAM, EXT, *_pose0(), iters=10)
    jP, jR, jfmp, jn = case["jout"]
    assert r.P.shape == (B, 3) and r.R.shape == (B, 3, 3) and r.feat_mp.shape == (B, 256)
    np.testing.assert_allclose(r.P.numpy(), jP, atol=1e-3)
    np.testing.assert_allclose(r.R.numpy(), jR, atol=1e-3)
    assert np.abs(r.n_inliers.numpy().astype(int) - jn.astype(int)).max() <= 2
    assert (r.n_inliers.numpy() > 15).all() and (jn > 15).all()


def test_batched_step_tracks_every_sequence(port_step):
    """The whole port step: every sequence tracked (above 15 inliers, as
    tests/test_multiseq.py asks of the JAX step), finite poses, every
    association a map slot or -1."""
    step, ms, (P, R, fmp, n_in) = port_step
    assert torch.isfinite(P).all() and torch.isfinite(R).all()
    assert (n_in > 15).all()
    assert ((fmp >= -1) & (fmp < ms.P)).all()


def test_batched_equals_per_sequence(case, port_step):
    """Per sequence, the batched step against the port's own unbatched
    extract + track_frame_visual. Feature tables exact but the IC angle: a
    batch stacks its patch moments into one (B*K, 961) product, which rounds
    some rows otherwise (angles within 1e-4 rad; the descriptor bits, which
    read the angle's bin, stay exact). Matches and inliers exact; positions
    within 1e-4 m: the second round's 10 LM iterations carry the first
    round's ~1e-7 m product rounding to up to ~7e-5 m (measured on this
    setup; the unbatched solver moves as much from a 1e-7 m change of its
    start)."""
    step, ms, (P, R, fmp, n_in) = port_step
    fb = extractor.extract(case["imgs"], n_features=256, n_levels=3)
    for b in range(B):
        f = extractor.extract(case["imgs"][b], n_features=256, n_levels=3)
        for name in f._fields:
            got = getattr(fb, name)[b]
            if name == "angle":
                assert (got - f.angle).abs().max() < 1e-4
            else:
                assert torch.equal(got, getattr(f, name)), name
        r = tracking.track_frame_visual(case["maps"][b], f, f.xy, CAM, EXT,
                                        torch.zeros(3), torch.eye(3), iters=10)
        assert torch.equal(fmp[b], r.feat_mp)
        assert int(n_in[b]) == int(r.n_inliers)
        assert (P[b] - r.P).abs().max() < 1e-4
        assert (R[b] - r.R).abs().max() < 1e-4


def test_seq_mesh_equals_unsharded(case, port_step):
    """A 4-shard "seq" mesh on the cpu (one sequence a shard) against the
    unsharded batched step: equal to float32 rounding of the batched products
    (positions within 1e-4 m, as above), matches and inliers exact."""
    step, ms, (P, R, fmp, n_in) = port_step
    mesh = multiseq.make_seq_mesh(devices=["cpu"] * 4)
    assert mesh.axis == "seq" and mesh.size == 4
    mstep = multiseq.make_batched_step(CAM, EXT, n_features=256, n_levels=3, mesh=mesh)
    Pm, Rm, fmpm, nm = mstep(ms, case["imgs"], *_pose0())
    assert torch.equal(fmpm, fmp) and torch.equal(nm, n_in)
    assert (Pm - P).abs().max() < 1e-4 and (Rm - R).abs().max() < 1e-4
    with pytest.raises(ValueError):
        multiseq.make_batched_step(CAM, EXT, 256, 3, mesh=multiseq.make_seq_mesh(
            devices=["cpu"] * 3))(ms, case["imgs"], *_pose0())


def test_stack_maps_of_converted_jax_maps(case):
    """stack_maps of the converted JAX maps equals the JAX stack_maps carried
    across by convert, field by field, exactly; the stacked map keeps the
    per-map capacities."""
    ms = multiseq.stack_maps(case["maps"])
    ref = convert.to_torch(MapState, case["jms"]._asdict(), "cpu")
    flat = lambda m: [x for x in jax.tree_util.tree_leaves(convert.to_numpy(m))]
    for a, b in zip(flat(ms), flat(ref)):
        np.testing.assert_array_equal(a, b)
    assert (ms.K, ms.P, ms.F) == (case["maps"][0].K, case["maps"][0].P, case["maps"][0].F)
    assert ms.mp_pos.shape == (B, 512, 3)
    back = multiseq.batch_rows(ms, slice(1, 2))
    assert torch.equal(back.mp_pm1[0], case["maps"][1].mp_pm1)
