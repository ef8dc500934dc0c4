"""The trace reader on a hand-made timeline: the busy union, kernel names,
the call ranges' device annotations left out, and each idle gap charged to
what the host was doing."""

from types import SimpleNamespace

import pytest

from perfbench.trace import HOST_OUTSIDE, short_name, summarize


class Ev:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._a


def prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_summary_of_a_hand_made_window():
    k = "void (anonymous namespace)::scan_kernel<float, 128>(CUtensorMap)"
    events = [
        Ev("perfbench.call", "CPU", 0, 100),
        Ev("perfbench.call", "CPU", 120, 80),
        Ev("perfbench.call", "CUDA", 0, 200, annotation=True),
        Ev("aten::mm", "CPU", 5, 10),
        Ev("cudaMemcpyAsync", "CPU", 60, 30),
        Ev(k, "CUDA", 20, 30),           # busy 20-50
        Ev(k, "CUDA", 40, 20),           # overlaps: busy 20-60
        Ev("Memcpy DtoH", "CUDA", 130, 40),  # busy 130-170
    ]
    s = summarize(prof(events))
    assert s.window_s == pytest.approx(200e-9)
    assert s.busy_s == pytest.approx(80e-9)
    assert s.device_s["scan_kernel"] == pytest.approx(50e-9)
    assert s.launches("scan_kernel") == 2
    assert "perfbench.call" not in s.device_s
    # gaps 0-20 (mid 10, inside aten::mm), 60-130 (mid 95, in call 1
    # after its copy), 170-200 (mid 185, call 2 before any op)
    assert s.idle_by_host == {
        "aten::mm": pytest.approx(20e-9),
        "python after cudaMemcpyAsync": pytest.approx(70e-9),
        "python in a call": pytest.approx(30e-9)}


def test_gap_outside_every_call():
    events = [Ev("perfbench.call", "CPU", 0, 10),
              Ev("perfbench.call", "CPU", 90, 10),
              Ev("k", "CUDA", 0, 10), Ev("k", "CUDA", 90, 10)]
    assert summarize(prof(events)).idle_by_host == {
        HOST_OUTSIDE: pytest.approx(80e-9)}


def test_gap_inside_a_call_between_ops():
    events = [
        Ev("perfbench.call", "CPU", 0, 100),
        Ev("aten::topk", "CPU", 0, 10),
        Ev("k", "CUDA", 0, 40),
        Ev("k", "CUDA", 80, 20),
    ]
    s = summarize(prof(events))
    assert s.idle_by_host == {"python after aten::topk": pytest.approx(40e-9)}


def test_short_names():
    assert short_name("(anonymous namespace)::merge_splits_kernel(float "
                      "const*, int)") == "merge_splits_kernel"
    assert short_name("void hop::prep_queries_kernel<float>(float const*)"
                      ) == "prep_queries_kernel"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
