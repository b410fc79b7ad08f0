"""The reading of a SlamSystem window's spans (`benchmark/metrics/_slam_spans.py`)
on synthetic profiler events: operations put down to the spans open at their
launch, a frame's operations less its keyframe event's, idle gaps put down
to the span of the launch that ends them, per frame and per event; and the
seven readers, which read None without the program's window, without
device work, and (the per-event ones) without an event."""
import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.trace import Trace
from benchmark.metrics._slam_spans import SlamSpans
from benchmark.tests.test_bench_spans import CPU, CUDA, Ev

# two frames on the host: 0-1000 and 2000-3000 ns; the second holds an event
# (2400-2900) with its window BA (2500-2700); each frame preintegrates and solves
RECORDS = [("imu.preintegrate", "track", 10, 100), ("tracking.solve", "track", 200, 400),
           ("track", None, 0, 1000),
           ("imu.preintegrate", "track", 2010, 2100), ("tracking.solve", "track", 2200, 2350),
           ("mapping.vi_ba", "lm_ba", 2500, 2700), ("mapping.event", "track", 2400, 2900),
           ("track", None, 2000, 3000)]
# (corr, host launch, device start, device end)
OPS = [(1, 20, 150, 160), (2, 250, 300, 340), (3, 500, 600, 620), (4, 1500, 1600, 1610),
       (5, 2050, 2100, 2110), (6, 2300, 2400, 2450), (7, 2600, 2700, 2800), (8, 2800, 2950, 2960)]


def events():
    ev = []
    for c, t, s, e in OPS:
        ev += [Ev("cudaLaunchKernel", t, t + 5, corr=c), Ev(f"k{c}", s, e, corr=c, dev=CUDA)]
    ev += [Ev("track", 150, 620, dev=CUDA, ann=True), Ev("track", 0, 1000, ann=True)]
    return ev


def test_operations_go_to_the_spans_open_at_their_launch():
    sp = SlamSpans(events(), RECORDS)
    assert sp.frames == 2 and sp.events == 1 and len(sp.start) == 8
    assert sp.read("track", "launches", "frame") == 7 / 2          # op 4 is outside
    assert sp.read("track", "launches", "frame", without="mapping.event") == 5 / 2
    assert sp.read("mapping.event", "launches", "event") == 2
    assert sp.read("imu.preintegrate", "launches", "frame") == 2 / 2
    assert sp.read("tracking.solve", "device_ms", "frame") == pytest.approx((40 + 50) / 2 * 1e-6)
    assert sp.read("mapping.vi_ba", "device_ms", "event") == pytest.approx(100e-6)


def test_an_idle_gap_goes_to_the_spans_of_the_launch_that_ends_it():
    sp = SlamSpans(events(), RECORDS)
    # gaps ended by ops 2, 3 (frame 1), 4 (outside every frame: not counted),
    # 5, 6 (frame 2) and 7, 8 (frame 2's event)
    assert sp.read("track", "idle_ms", "frame", without="mapping.event") \
        == pytest.approx((140 + 260 + 490 + 290) / 2 * 1e-6)
    assert sp.read("track", "idle_ms", "frame") == pytest.approx((140 + 260 + 490 + 290 + 250
                                                                  + 150) / 2 * 1e-6)
    assert sp.read("mapping.event", "idle_ms", "event") == pytest.approx(400e-6)


NAMES = ["slam.frame.launches_per_frame", "slam.frame.idle_ms_per_frame",
         "slam.solve.launches_per_frame", "slam.solve.device_ms_per_frame",
         "slam.preint.launches_per_frame", "slam.event.launches_per_event",
         "slam.vi_ba.device_ms_per_event"]


def test_the_seven_readers():
    m = {p["name"]: p for p in mf.load_manifest()["per_layer"]}
    assert all(m[n]["workloads"] == ["mono-vi.stream"] for n in NAMES)
    tr = Trace([], 1.0, {"program": {"events": events(), "records": RECORDS}})
    got = {n: mf.metric_reader(n)(tr) for n in NAMES}
    assert got == pytest.approx({
        NAMES[0]: 5 / 2, NAMES[1]: 1180 / 2 * 1e-6, NAMES[2]: 2 / 2, NAMES[3]: 90 / 2 * 1e-6,
        NAMES[4]: 1.0, NAMES[5]: 2.0, NAMES[6]: 100e-6})
    no_event = [r for r in RECORDS if r[0] not in ("mapping.event", "mapping.vi_ba")]
    tr2 = Trace([], 1.0, {"program": {"events": events(), "records": no_event}})
    assert mf.metric_reader(NAMES[5])(tr2) is None and mf.metric_reader(NAMES[6])(tr2) is None
    assert mf.metric_reader(NAMES[0])(tr2) == 7 / 2
    host_only = [e for e in events() if e.device_type() == CPU]
    for n in NAMES:
        assert mf.metric_reader(n)(Trace([], 1.0, {})) is None
        assert mf.metric_reader(n)(Trace([], 1.0, {"program": {
            "events": host_only, "records": RECORDS}})) is None
    # the parent's window: library spans only, no frame record
    lib = [r for r in RECORDS if r[0] != "track"]
    assert all(mf.metric_reader(n)(Trace([], 1.0, {"program": {
        "events": events(), "records": lib}})) is None for n in NAMES[:5])
