"""The reading of the program's spans (`benchmark/metrics/_spans.py`) on
synthetic profiler events: operations put down to the spans open at their
launch (one launched outside every span), span shadows on the device left
out, the fallback to the shadows where no launch was traced, idle gaps put
down to the span of the launch that ends them; the nine readers; the
window with the spans and the cost windows on a tiny CPU cell; and, on the
card, the shared host clock and the launches of that window against a window
without spans."""
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness import program_window
from benchmark.harness.trace import Trace
from benchmark.metrics._spans import STEP, Spans
from benchmark.runners import multiseq
from benchmark.tests.tiny import tiny_spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NAMES = {STEP, "frontend.extract", "tracking.search", "tracking.solve"}


class Ev:
    """The methods of a profiler event that `_spans` reads."""

    def __init__(self, name, start, end, corr=0, dev=CPU, ann=False):
        self._n, self._s, self._d, self._c, self._dev, self._a = \
            name, start, end - start, corr, dev, ann

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


# one step, 0-1000 ns on the host: extract 10-400, solve 500-900
RECORDS = [("frontend.extract", STEP, 10, 400), ("tracking.solve", STEP, 500, 900),
           (STEP, None, 0, 1000)]
# (corr, host launch, device start, device end): before the step (the runner's
# upload), in extract, in solve, in the step alone, after the step (its readback)
OPS = [(5, -50, 50, 90), (1, 20, 100, 200), (2, 510, 600, 650), (3, 950, 960, 990),
       (4, 1100, 1200, 1210)]
SPANS = [frozenset(), {STEP, "frontend.extract"}, {STEP, "tracking.solve"}, {STEP},
         frozenset()]


def events(launches=True, shadows=True):
    ev = [Ev("Activity Buffer Request", 5, 30, corr=1)]     # shares corr 1, not a launch
    for c, t, s, e in OPS:
        if launches:
            ev.append(Ev("cudaLaunchKernel", t, t + 5, corr=c))
        ev.append(Ev(f"kernel{c}", s, e, corr=c, dev=CUDA))
    if shadows:
        ev += [Ev("frontend.extract", 100, 200, dev=CUDA, ann=True),
               Ev("tracking.solve", 600, 650, dev=CUDA, ann=True),
               Ev(STEP, 100, 990, dev=CUDA, ann=True),
               Ev(STEP, 0, 1000, ann=True)]           # the host-side annotation
    return ev


def test_operations_go_to_the_spans_open_at_their_launch():
    sp = Spans(events(), RECORDS)
    assert sp.spans == SPANS
    assert sp.per_step("frontend.extract")["launches"] == 1
    assert sp.per_step("tracking.solve")["device_ms"] == pytest.approx(50e-6)
    assert sp.per_step(STEP)["launches"] == 3 and sp.per_step()["launches"] == 5
    assert sp.per_step("tracking.search") == {"launches": 0, "device_ms": 0, "idle_ms": 0}
    assert sp.early(10_000) == 0 and sp.early(-91) == 1    # kernel1 starts 90 ns after 10


def test_span_shadows_on_the_device_are_no_operations():
    with_shadows, without = Spans(events(), RECORDS), Spans(events(shadows=False), RECORDS)
    assert len(with_shadows.ops) == len(without.ops) == 5
    assert with_shadows.per_step() == without.per_step()
    assert program_window.device_ops(events()) == 5
    assert program_window.dropped_ops(events()) == 0
    assert program_window.dropped_ops([e for e in events() if e.name() != "kernel2"]) == 1


def test_without_launches_the_shadows_attribute():
    sp = Spans(events(launches=False), RECORDS)
    assert sp.launched == [None] * 5 and sp.spans == SPANS


def test_an_idle_gap_goes_to_the_span_of_the_launch_that_ends_it():
    sp = Spans(events(), RECORDS)
    # on the device: 90-100 ended by kernel1 (extract) after the upload,
    # 200-600 by kernel2 (solve), 650-960 by kernel3 (the step); 990-1200
    # ends with the readback, launched outside the step
    assert sp.gaps == [(10, {STEP, "frontend.extract"}), (400, {STEP, "tracking.solve"}),
                       (310, {STEP})]
    assert sp.per_step("frontend.extract")["idle_ms"] == pytest.approx(10e-6)
    assert sp.per_step("tracking.solve")["idle_ms"] == pytest.approx(400e-6)
    assert sp.per_step()["idle_ms"] == pytest.approx(720e-6)
    # a device clock shifted against the host one moves no gap
    shifted = [Ev(e.name(), e.start_ns() - 300, e.start_ns() - 300 + e.duration_ns(),
                  e.correlation_id(), e.device_type(), e.is_user_annotation())
               if e.device_type() == CUDA else e for e in events()]
    assert Spans(shifted, RECORDS).gaps == sp.gaps


NINE = {f"multiseq.{k}.{m}_per_step": (span, key)
        for k, span in (("extract", "frontend.extract"), ("search", "tracking.search"),
                        ("solve", "tracking.solve"))
        for m, key in (("launches", "launches"), ("device_ms", "device_ms"),
                       ("idle_ms", "idle_ms"))}


def test_the_nine_readers_read_the_program_window():
    want = Spans(events(), RECORDS)
    tr = Trace([], 1.0, {"program": {"events": events(), "records": RECORDS}})
    for name, (span, key) in NINE.items():
        assert mf.metric_reader(name)(tr) == want.per_step(span)[key], name
        assert mf.metric_reader(name)(Trace([], 1.0, {})) is None
        cpu_only = {"events": [e for e in events() if e.device_type() == CPU],
                    "records": RECORDS}
        assert mf.metric_reader(name)(Trace([], 1.0, {"program": cpu_only})) is None


def test_the_window_with_spans_on_a_tiny_cpu_cell():
    torch.set_num_threads(2)
    cell = multiseq.Cell(tiny_spec(), 2 ** 31 + 5, torch.device("cpu"))
    outs, events_, window_s, records = program_window.traced_with_spans(
        cell.step, 2, torch.device("cpu"))
    assert len(outs) == 2 and window_s > 0
    names = sorted(r.name for r in records)
    assert names == sorted(2 * [STEP, "frontend.extract"] + 4 * ["tracking.search",
                                                                  "tracking.solve"])
    ann = sorted(e.name() for e in events_ if e.is_user_annotation() and e.name() in NAMES)
    assert ann == names
    cost = program_window.steps_per_s(cell, 0.05, 2)
    assert set(cost) == {"off", "on", "on_over_off", "span_us"} and len(cost["on"]["runs"]) == 2
    assert 0 < cost["span_us"]["off"] < cost["span_us"]["on"]


@pytest.mark.card
def test_on_the_card_the_spans_share_the_host_clock_and_add_no_launch():
    """One tiny cell on the card. In the device-only window with the spans
    every device operation has its launch, and the host issues the launches
    that a window without the spans issues. Under a profiler of host and
    device, each stage's record lies within its user annotation, which the
    profiler stamps on its host clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mc_slam_tpu_torch.utils import metrics
    device = torch.device("cuda", 0)
    cell = multiseq.Cell(tiny_spec(), 2 ** 31 + 9, device)
    cell.step(0)
    cell.sync()
    w = program_window.read_window(cell, 1, 2, device)
    assert w["unlaunched_ops"] == 0, w
    assert w["issued_per_step"][0] == w["issued_per_step"][1], w
    timer = metrics.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof, \
            metrics.tracing(timer):
        cell.step(5)
    ann = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation() and e.device_type() == CPU and e.name() in NAMES)
    rec = sorted(timer.records, key=lambda r: r.start_ns)
    assert [n for _, _, n in ann] == [r.name for r in rec] and len(rec) == 6
    assert all(a <= r.start_ns <= r.end_ns <= b for (a, b, _), r in zip(ann, rec))
