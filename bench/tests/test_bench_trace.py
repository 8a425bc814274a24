"""The trace reader on a recorded synthetic session."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench.yardstick import trace


def _ev(name, start, end, dev=DeviceType.CUDA, card=0):
    return SimpleNamespace(name=name, device_type=dev, device_index=card,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_read_clips_to_the_window_and_labels_gaps():
    cpu = DeviceType.CPU
    prof = _Prof([
        _ev(trace.WINDOW, 0, 100, cpu), _ev(trace.WINDOW, 0, 100),
        _ev("cudaGraphLaunch", 5, 12, cpu), _ev("aten::item", 40, 60, cpu),
        _ev("void region_dwell_kernel<0, 16>(int*, int const*)", 10, 30),
        _ev("void fill_kernel<4>(int*)", 20, 40),
        _ev("Memcpy DtoD (Device -> Device)", 60, 70),
        _ev("void fill_kernel<4>(int*)", 150, 160),  # outside the window
        _ev("warm_kernel", -50, -40),
    ])
    tr = trace.read(prof)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.span_s == pytest.approx(100e-6)
    assert tr.device_s == pytest.approx({
        "region_dwell_kernel": 20e-6, "fill_kernel": 20e-6,
        "Memcpy DtoD (Device -> Device)": 10e-6})
    assert tr.counts["fill_kernel"] == 1
    assert tr.idle_by_host == pytest.approx(
        {"cudaGraphLaunch": 10e-6, "aten::item": 20e-6, "python": 30e-6})
    assert trace.top(tr.idle_by_host, 1) == [["python", pytest.approx(30e-6)]]


def test_read_needs_the_window():
    with pytest.raises(RuntimeError):
        trace.read(_Prof([_ev("k", 0, 1)]))


def test_short_names():
    assert trace.short_name("void perimeter_query_pooled_kernel<0, 16>"
                            "(int const*)") == "perimeter_query_pooled_kernel"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel"
                            "<4, at::native::FillFunctor<int> >(int)") == \
        "vectorized_elementwise_kernel"
    assert trace.short_name("Memset (Device)") == "Memset (Device)"


def test_busy_is_averaged_over_the_cards():
    cpu = DeviceType.CPU
    events = [_ev(trace.WINDOW, 0, 100, cpu), _ev("k", 0, 50),
              _ev("k", 10, 90, card=1)]
    assert trace.read(_Prof(events), chips=2).busy_s == \
        pytest.approx((50 + 80) / 2 * 1e-6)
    assert trace.read(_Prof(events), chips=4).busy_s == \
        pytest.approx((50 + 80) / 4 * 1e-6)
