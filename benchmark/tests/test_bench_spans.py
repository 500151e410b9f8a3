"""The readers of the program's stage spans (lib/spans.py and the five
metrics that use it): launches go to the innermost span around their
start, the transfer spans are cut to the calls, the run's host events
are found beside the readers' context and kept to the frame loop's
thread, and a CPU --trace 1 run reports the two time metrics, positive,
and leaves the launch metrics out."""

from types import SimpleNamespace

import pytest

from benchmark.lib import harness, spans, spec

SMALL = {"height": 72, "width": 96, "channels": 3}
LAUNCH_METRICS = ("loop.flow_launches_per_frame",
                  "loop.filter_launches_per_frame",
                  "loop.lifecycle_launches_per_frame")

# one call (0-100 us): a flow stage with a nested fetch, a filter stage,
# an upload; launches inside each, one under the call alone, one outside
EVENTS = [("kh.call", 0.0, 100.0), ("kh.upload", 1.0, 5.0),
          ("kh.flow", 10.0, 40.0), ("kh.fetch", 20.0, 30.0),
          ("kh.filter", 50.0, 70.0),
          ("cudaLaunchKernel", 12.0, 13.0), ("cudaMemsetAsync", 15.0, 16.0),
          ("cudaLaunchKernel", 25.0, 26.0),
          ("cudaLaunchKernelExC", 55.0, 56.0),
          ("cudaLaunchKernel", 80.0, 81.0), ("cudaLaunchKernel", 150.0, 151.0),
          ("cudaMemcpyAsync", 60.0, 61.0), ("aten::add", 11.0, 14.0)]


def test_launches_go_to_the_innermost_span():
    assert spans.launches_by_span(EVENTS) == {
        "kh.flow": 2, "kh.fetch": 1, "kh.filter": 1, "kh.call": 1, None: 1}


def test_call_and_io_cut_to_the_calls():
    ctx = SimpleNamespace(host=EVENTS + [("kh.rows.wait", 95.0, 120.0)],
                          steps=2)
    call_us, io_us = spans.call_and_io_us(ctx)
    assert call_us == 100.0 and io_us == 4.0 + 10.0 + 5.0
    issue = spec.reader("loop.issue_ms_per_frame")(ctx)
    io = spec.reader("io.host_ms_per_frame")(ctx)
    assert issue == pytest.approx((100.0 - 19.0) / 1e3 / 2)
    assert io == pytest.approx(19.0 / 1e3 / 2)
    assert spec.reader("loop.flow_launches_per_frame")(ctx) == 1.0
    assert spec.reader("loop.lifecycle_launches_per_frame")(ctx) == 0.0


def test_absent_spans_read_none():
    """A program without spans (one from before they were added) and a run
    without launches leave every one of the five metrics out."""
    bare = SimpleNamespace(host=[(n, a, b) for n, a, b in EVENTS
                                 if not n.startswith("kh.")], steps=2)
    cpu = SimpleNamespace(host=[(n, a, b) for n, a, b in EVENTS
                                if n.startswith("kh.")], steps=2)
    for name in LAUNCH_METRICS + ("loop.issue_ms_per_frame",
                                  "io.host_ms_per_frame"):
        assert spec.reader(name)(bare) is None
    for name in LAUNCH_METRICS:
        assert spec.reader(name)(cpu) is None


def _event(name, a, b, thread):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, thread=thread,
                           time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CPU)


def test_host_events_found_beside_the_context():
    """Without ctx.host, the events are the host events of the profiler
    `prof` beside `ctx` in the calling frame, as in harness.run, kept to
    the frame loop's thread."""
    evs = [_event(n, a, b, 1) for n, a, b in EVENTS] \
        + [_event("cudaLaunchKernel", 12.5, 13.0, 2)]
    prof = SimpleNamespace(events=lambda: evs)  # noqa: F841 (read there)
    ctx = SimpleNamespace(steps=1)
    assert spans.host(ctx) == EVENTS
    assert spans.host(SimpleNamespace(steps=1)) == []


def test_only_the_loop_threads_launches_count():
    """A launch from another thread (the prefetch worker's) counts under
    no span, though the loop has a span open at its start; events
    without threads are kept as they are."""
    worker = [("kh.call", 200.0, 300.0, 9),
              ("cudaLaunchKernel", 12.5, 13.0, 9),
              ("cudaMemsetAsync", 55.5, 56.0, 9)]
    threaded = [e + (1,) for e in EVENTS] + [
        ("kh.call", 400.0, 500.0, 1)] + worker
    loop = spans.on_loop_thread(threaded)
    assert ("cudaLaunchKernel", 12.5, 13.0) not in loop
    assert len(loop) == len(EVENTS) + 1
    assert spans.launches_by_span(loop) == spans.launches_by_span(EVENTS)
    ctx = SimpleNamespace(host=threaded, steps=1)
    assert spec.reader("loop.flow_launches_per_frame")(ctx) == 2.0
    assert spec.reader("loop.filter_launches_per_frame")(ctx) == 1.0
    assert spans.on_loop_thread(EVENTS) is EVENTS


@pytest.mark.parametrize("workload", [w["name"] for w
                                      in spec.load()["workloads"]])
def test_traced_run_reads_the_spans_on_the_cpu(workload):
    """A --trace 1 run at a small size on the CPU: the host's issue time
    and the transfers' host time are reported and positive; the launch
    metrics, with no card, are left out."""
    res, log = harness.run(workload, 2 ** 33 + 11, 0.3, True, device="cpu",
                           frame=SMALL)
    assert res["correct"], log
    for name in ("loop.issue_ms_per_frame", "io.host_ms_per_frame"):
        assert res["metrics"][name]["value"] > 0, name
    assert not set(LAUNCH_METRICS) & set(res["metrics"])
