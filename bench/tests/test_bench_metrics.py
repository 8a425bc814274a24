"""Each per-layer reader on a synthetic trace, and silent where it finds
nothing to read."""

import json
from types import SimpleNamespace

import pytest

from bench.yardstick import harness, trace

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _ctx(device_s=None, work=None, frames=10, chunks=(), window_s=2.0,
         busy_s=1.5):
    tr = trace.Trace(device_s or {}, {}, busy_s, window_s, {})
    return harness.Context(tr, work or {}, frames, list(chunks), window_s)


WORK = dict(leaf_flops=67e9, leaf_bytes=0.0, query_flops=6.7e9,
            query_bytes=0.0)


@pytest.mark.parametrize("name,kernel,want", [
    ("roofline_pct.region_dwell", "region_dwell_kernel", 50.0),
    ("roofline_pct.region_dwell_pooled", "region_dwell_pooled_kernel", 50.0),
    ("roofline_pct.perimeter_query", "perimeter_query_kernel", 5.0),
    ("roofline_pct.perimeter_query_pooled", "perimeter_query_pooled_kernel",
     5.0),
])
def test_rooflines(name, kernel, want):
    read = harness.reader(name)
    assert read(_ctx({kernel: 0.002}, WORK)) == pytest.approx(want)
    assert read(_ctx({"other_kernel": 0.002}, WORK)) is None


def test_clone_and_idle():
    copy = "Memcpy DtoD (Device -> Device)"
    assert harness.reader("clone_ms.frame")(_ctx({copy: 0.0072})) == \
        pytest.approx(0.72)
    assert harness.reader("clone_ms.frame")(_ctx({})) is None
    assert harness.reader("device_idle_pct")(_ctx()) == pytest.approx(25.0)
    assert harness.reader("device_idle_pct")(_ctx(busy_s=0.0)) is None


def test_service_readers():
    chunks = [SimpleNamespace(dispatch_s=0.010, retries=0),
              SimpleNamespace(dispatch_s=0.020, retries=2)]
    assert harness.reader("dispatch_ms.chunk")(_ctx(chunks=chunks)) == \
        pytest.approx(15.0)
    assert harness.reader("retries_per_chunk")(_ctx(chunks=chunks)) == 1.0
    assert harness.reader("dispatch_ms.chunk")(_ctx()) is None
    assert harness.reader("retries_per_chunk")(_ctx()) is None


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
