"""The result's line, the command's refusals, and the import rules."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from bench.yardstick import harness, imports

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_line_shape_on_the_cpu():
    cell = harness.load_cell("mandelbrot-16k.frame-zoom")
    cell = cell._replace(config=dict(cell.config, n=256, B=16, max_dwell=128),
                         mix=dict(cell.mix, warm_rounds=1))
    res = harness.run(cell, 7, 1.0, False, device="cpu",
                      process_start=time.time(), log=lambda m: None)
    assert list(res)[:5] == KEYS
    assert set(res["metrics"]) == {"mpix_per_s", "request_ms_p95", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def _command(root):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "mandelbrot-16k.frame-zoom", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_forbidden_imports():
    assert imports.violations(ROOT / "bench") == []
    assert imports.forbidden_loaded() == []


def test_import_rules_compare_whole_top_level_names(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text(
        "import repro_torch.workloads\nfrom jax import numpy\n")
    (tmp_path / "reference" / "b.py").write_text("import repro_torch\n")
    assert imports.violations(tmp_path) == [("a.py", "jax"),
                                           ("reference/b.py", "repro_torch")]
    assert imports.top_level("repro_torch.kernels") == "repro_torch"


def test_every_name_finds_its_file():
    """A cell's configuration, kind, mix, entry and metrics are files found
    by name; an unknown name is refused."""
    from bench.reference import escape
    from bench.yardstick import entries
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert escape.arithmetic(cell.config["workload"]).STEP_FLOPS > 0
        assert entries.load(cell.mix["entry"]).spelling in ("static",
                                                             "traced")
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
    with pytest.raises(KeyError):
        escape.arithmetic("no_such_kind")
    with pytest.raises(KeyError):
        entries.load("no_such_entry")
