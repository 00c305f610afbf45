"""The trace reduction: the device's busy time is the union of its
operations' intervals, and idle gaps are labelled by the host."""
import pytest

from perfbench import trace


class Ev:
    """A profiler event as the card's PyTorch gives it: a device type and
    an annotation flag, no activity kind."""

    def __init__(self, name, kind, start, end, tid=1):
        self._v = (name, kind, start, end, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] in (
            "kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation") \
            else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[1].endswith("user_annotation")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def start_thread_id(self):
        return self._v[4]


def test_union_not_sum():
    assert trace.union([(0, 10), (5, 12), (20, 30), (30, 31)]) == \
        [(0, 12), (20, 31)]


def test_reduce_events():
    events = [
        Ev(trace.SEGMENT, "user_annotation", 0, 1000),
        Ev("perfbench.execute", "user_annotation", 0, 900),
        Ev("aten::copy_", "cpu_op", 100, 300),
        Ev("aten::sort", "cpu_op", 600, 700),
        Ev("other_thread_op", "cpu_op", 0, 1000, tid=2),
        Ev("void k3<int>(int*)", "kernel", 300, 500),
        Ev("k3_b", "kernel", 400, 550),          # overlaps: counted once
        Ev("Memcpy HtoD", "gpu_memcpy", 800, 900),
        Ev("gpu annotation", "gpu_user_annotation", 0, 1000),
        Ev("late kernel", "kernel", 990, 1100),  # clipped to the segment
    ]
    got = trace.reduce_events(events)
    busy = (550 - 300) + (900 - 800) + (1000 - 990)
    assert got["busy_s"] == pytest.approx(busy / 1e9)
    assert got["window_s"] == pytest.approx(1e-6)
    gaps = dict(got["idle_gaps"])
    # [0, 300): middle 150 inside aten::copy_; [550, 800): middle 675 in
    # aten::sort; [900, 990): middle 945 outside every host op
    assert gaps["aten::copy_"] == pytest.approx(300e-9)
    assert gaps["aten::sort"] == pytest.approx(250e-9)
    assert gaps["host (no operation)"] == pytest.approx(90e-9)
    ops = dict(got["device_ops"])
    assert ops["k3"] == pytest.approx(200e-9)
    assert sum(ops.values()) == pytest.approx((200 + 150 + 100 + 10) / 1e9)


def test_no_device_operation_reads_nothing():
    assert trace.reduce_events(
        [Ev(trace.SEGMENT, "user_annotation", 0, 10)]) is None
    assert trace.reduce_events([Ev("k", "kernel", 0, 10)]) is None


def test_kinds():
    for k in ("kernel", "cpu_op", "user_annotation", "gpu_user_annotation"):
        assert trace.kind(Ev("x", k, 0, 1)) == k
    assert trace.kind(Ev("perfbench.plan", "kernel", 0, 1)) == \
        "gpu_user_annotation"
    assert trace.kind(Ev("perfbench.plan", "cpu_op", 0, 1)) == \
        "user_annotation"
    for k in ("gpu_memcpy", "gpu_memset"):
        assert trace.kind(Ev("Memcpy HtoD", k, 0, 1)) == "kernel"
