"""The port's spans (`mc_slam_tpu_torch.utils.metrics`: `tracing`, `span`,
`StageTimer`'s records): a batched step under an active timer records its
four spans with their parents; with no active timer the step is the same to
the bit and leaves nothing in a profiler; under a CPU profiler the spans
are user annotations nested as the stages; the names keep clear of the
benchmark runner's own; `SlamSystem`'s stage names stay as they were."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.trace import SPANS as RUNNER_SPANS
from mc_slam_tpu_torch.camera import make_camera, undistort_points
from mc_slam_tpu_torch.frontend import extractor
from mc_slam_tpu_torch.parallel import multiseq
from mc_slam_tpu_torch.pipeline import loopctl
from mc_slam_tpu_torch.slam_map.mapstate import empty_map
from mc_slam_tpu_torch.solver import factors
from mc_slam_tpu_torch.utils import metrics

torch.set_num_threads(2)

B, F, P = 2, 96, 128
CAM = make_camera(120.0, 120.0, 80.0, 60.0, width=160, height=120, device="cpu")
EXT = factors.identity_extrinsics(device="cpu")
STEP_SPANS = {"multiseq.step": None, "frontend.extract": "multiseq.step",
              "tracking.search": "multiseq.step", "tracking.solve": "multiseq.step"}


@pytest.fixture(scope="module")
def case():
    """Two tiny streams: smoothed noise frames and maps whose points are the
    frames' own features lifted to 2-3 m at the identity pose, so the step
    matches and solves for real."""
    g = torch.Generator().manual_seed(5)
    noise = torch.rand((B, 1, 120, 160), generator=g) * 255
    imgs = torch.nn.functional.avg_pool2d(noise, 3, 1, 1)[:, 0].to(torch.uint8)
    f = extractor.extract(imgs, n_features=F, n_levels=3)
    uv = undistort_points(CAM, f.xy)
    z = 2.0 + torch.rand((B, F), generator=g)
    X = torch.stack([(uv[..., 0] - 80.0) / 120.0 * z, (uv[..., 1] - 60.0) / 120.0 * z, z], -1)
    max_d = X.norm(dim=-1) * 1.2 ** f.level.to(torch.float32)     # predicts each level
    ms = multiseq.stack_maps([empty_map(4, P, F, device="cpu")] * B)
    pad = lambda x, v=0: torch.cat([x, x.new_full((B, P - F) + x.shape[2:], v)], 1)
    ms = ms._replace(mp_pos=pad(X), mp_desc=pad(f.desc), mp_pm1=pad(f.desc_pm1),
                     mp_normal=pad(X / X.norm(dim=-1, keepdim=True)),
                     mp_min_dist=pad(max_d / 1.2 ** 7), mp_max_dist=pad(max_d),
                     mp_angle=pad(f.angle), mp_active=pad(f.valid, False))
    step = multiseq.make_batched_step(CAM, EXT, n_features=F, n_levels=3, iters=4)
    P0 = torch.tensor([[0.01, -0.01, 0.02]]).repeat(B, 1)
    R0 = torch.eye(3).expand(B, 3, 3).contiguous()
    return step, (ms, imgs, P0, R0)


def _traced(case):
    step, args = case
    timer = metrics.StageTimer()
    with metrics.tracing(timer):
        out = step(*args)
    return out, timer


def test_a_traced_step_records_its_four_spans_with_their_parents(case):
    out, timer = _traced(case)
    names = [r.name for r in timer.records]
    assert sorted(names) == sorted(["multiseq.step", "frontend.extract", "tracking.search",
                                    "tracking.search", "tracking.solve", "tracking.solve"])
    assert all(STEP_SPANS[r.name] == r.parent for r in timer.records)
    step = next(r for r in timer.records if r.name == "multiseq.step")
    inner = sorted((r for r in timer.records if r.parent), key=lambda r: r.start_ns)
    assert [r.name for r in inner] == ["frontend.extract", "tracking.search", "tracking.solve",
                                       "tracking.search", "tracking.solve"]
    assert all(step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns for r in inner)
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert int(out[3].min()) > 10          # the step matched and solved for real
    assert timer.summary()["tracking.solve"]["n"] == 2


def test_without_an_active_timer_the_step_is_bit_identical_and_unannotated(case):
    traced_out, _ = _traced(case)
    step, args = case
    assert metrics.span("frontend.extract") is metrics.span("tracking.solve")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(*args)
    for a, b in zip(out, traced_out):
        assert torch.equal(a, b)
    events = prof.profiler.kineto_results.events()
    assert events and not [e.name() for e in events if e.is_user_annotation()]


def test_under_a_cpu_profiler_the_spans_are_nested_user_annotations(case):
    step, args = case
    timer = metrics.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof, metrics.tracing(timer):
        step(*args)
    ann = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.is_user_annotation()))
    assert sorted(n for _, _, n in ann) == sorted(r.name for r in timer.records)
    (s0, s1, top), *inner = ann
    assert top == "multiseq.step"
    assert [n for _, _, n in inner] == ["frontend.extract", "tracking.search", "tracking.solve",
                                        "tracking.search", "tracking.solve"]
    assert all(s0 <= a <= b <= s1 for a, b, _ in inner)
    # the records share the profiler's clock: each record lies within its annotation
    for (a, b, n), r in zip(ann, sorted(timer.records, key=lambda r: r.start_ns)):
        assert r.name == n and a <= r.start_ns <= r.end_ns <= b


def test_no_span_name_is_one_of_the_runners(case):
    _, timer = _traced(case)
    assert {r.name for r in timer.records} == set(STEP_SPANS)
    assert not set(STEP_SPANS) & set(RUNNER_SPANS)


def test_stage_helpers_and_nested_parents():
    t = metrics.StageTimer()
    assert metrics.stage(None, "x") is metrics.span("x")            # the shared no-op
    ctx = loopctl.LoopContext(detector=None)
    assert ctx.stage("lc_detect") is metrics.span("y")
    ctx.timers = t
    with ctx.stage("lc_detect"):
        with metrics.tracing(t):
            with metrics.span("inner"):
                pass
        with metrics.span("dropped"):          # no timer active here
            pass
    assert [(r.name, r.parent) for r in t.records] == [("inner", "lc_detect"),
                                                       ("lc_detect", None)]
    assert set(t.summary()) == {"inner", "lc_detect"}


def test_system_timers_keep_their_stage_names():
    """SlamSystem activates no timer: its first frames record its own stage
    names, none of the batched step's spans."""
    import chip_smoke
    from mc_slam_tpu_torch.pipeline.system import SlamSystem
    from torch_port_helpers import BOOT
    seq = chip_smoke.make_sequence(BOOT, seed=0)
    slam = SlamSystem(chip_smoke.profile_camera(BOOT, "cpu"), chip_smoke.slam_config(BOOT),
                      Tbc=chip_smoke.TBC, device="cpu")
    for i in range(4):
        slam.track(seq.imgs[i], seq.times[i], seq.imu[i])
    assert set(slam.timers.summary()) == {"extract", "initialize", "track"}
    assert {r.name for r in slam.timers.records} == {"extract", "initialize", "track"}
