"""The port's tuned tier (``repro_torch.kernels.autotune``) against the JAX
package's, on the CPU.

Mirrors the autotune half of tests/test_tuned.py. The cache keys of every
(kernel, signature) that ``tune_problem`` visits equal JAX's letter for
letter on the CPU (``plat=cpu``), and the two ``tune_problem`` runs write
the same set of keys (JAX's timed on no-op runners: only its keys are
compared). The JSON cache round-trips, a wrong version is refused, a cold
cache gives the heuristics, a warm one wins over them, overrides beat it,
and an entry whose key names a card and whose impl is the plain version
raises. The card's heuristics and candidates are read with the card
stubbed (``_build.on_card`` and ``autotune.platform``): they are never the
plain version. Exact comparisons throughout.
"""

import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.workloads import FrameProblem as JFrameProblem
from repro_torch.kernels import _build, autotune, ops
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.workloads import FrameProblem, get_workload

torch.set_num_threads(1)

TUNE = dict(n=256, g=4, r=2, B=16, max_dwell=64)


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.clear_memo()
    jat.clear_memo()
    yield
    autotune.clear_memo()
    jat.clear_memo()


def _jax_visits(monkeypatch, workload, **kw):
    """JAX's tune_problem at ``TUNE`` with no-op runners: (its cache's
    keys, the (kernel, sig) of each tune call)."""
    visits = []
    real = jat.tune

    def tune(kernel, **k):
        visits.append((kernel, {s: v for s, v in k.items()
                                if s not in ("workload", "cache", "reps",
                                             "tiny", "interpret")}))
        return real(kernel, **k)

    monkeypatch.setattr(jat, "_build_runner", lambda *a, **k: (lambda: None))
    monkeypatch.setattr(jat, "_best_us", lambda fn, reps=3: 1.0)
    monkeypatch.setattr(jat, "tune", tune)
    cache = jat.tune_problem(JFrameProblem(**TUNE, workload=workload,
                                           backend="jnp"), **kw)
    return set(cache.entries), visits


@pytest.mark.parametrize("workload", ["mandelbrot", "julia"])
def test_cache_keys_equal_jax_for_every_visited_signature(monkeypatch, workload):
    """tiny=True, pooled_frames=2 at n=256, g=4, r=2, B=16, max_dwell=64:
    the port's key of each signature JAX's tune_problem visits equals JAX's,
    and the port's tune_problem (run for real, on the plain versions)
    writes the same set of keys."""
    from repro.workloads import get_workload as jget
    want_keys, visits = _jax_visits(monkeypatch, workload, tiny=True,
                                    pooled_frames=2)
    jw, tw = jget(workload), get_workload(workload)
    assert {v[0] for v in visits} == {"dwell", "perimeter_query",
                                      "region_dwell", "olt_compact",
                                      "region_fill_pooled",
                                      "region_dwell_pooled"}
    for kernel, sig in visits:
        assert autotune.cache_key(kernel, workload=tw, device="cpu", **sig) == \
            jat.cache_key(kernel, workload=jw, **sig)
    report = {}
    cache = autotune.tune_problem(
        FrameProblem(**TUNE, workload=workload, device="cpu"), reps=1,
        tiny=True, pooled_frames=2, report=report)
    assert set(cache.entries) == want_keys == set(report)
    for key, choice in cache.entries.items():
        assert "|plat=cpu|" in key
        assert choice.impl == "torch" and choice.source == "measured"
        assert choice.us > 0
        assert [c["params"] for c in report[key]["candidates"]] == [{}]


def test_cache_keys_equal_jax_on_the_full_sweep(monkeypatch):
    """Without ``tiny`` and with the pooled tier: the same key sets (the
    port's visits counted without timing them)."""
    want_keys, _ = _jax_visits(monkeypatch, "mandelbrot", pooled_frames=3)
    monkeypatch.setattr(autotune, "tune", lambda kernel, *, workload, cache,
                        device, **kw: cache.put(autotune.cache_key(
                            kernel, workload=workload, device=device,
                            **{k: v for k, v in kw.items()
                               if k not in ("reps", "tiny", "report")}),
                            autotune.Choice("torch")))
    cache = autotune.tune_problem(FrameProblem(**TUNE, device="cpu"),
                                  pooled_frames=3)
    assert set(cache.entries) == want_keys


def test_cache_key_format_and_platforms(monkeypatch):
    key = autotune.cache_key("dwell", n=256, max_dwell=64, device="cpu")
    assert key == "dwell|wl=mandelbrot|dtype=int32|plat=cpu|max_dwell=64|n=256"
    assert key == jat.cache_key("dwell", n=256, max_dwell=64)
    assert autotune.cache_key("dwell", workload="julia", dtype="float32",
                              device="cpu", block=(8, 32)) == \
        jat.cache_key("dwell", workload="julia", dtype="float32", block=(8, 32))
    # on a card the platform names its capability
    monkeypatch.setattr(_build, "on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device: (9, 0))
    assert autotune.platform("cuda") == "cuda-sm_90"
    assert autotune.cache_key("dwell", n=256, max_dwell=64) == \
        "dwell|wl=mandelbrot|dtype=int32|plat=cuda-sm_90|max_dwell=64|n=256"


def test_tuning_cache_json_round_trip(tmp_path):
    cache = autotune.TuningCache()
    key = autotune.cache_key("dwell", n=256, max_dwell=128, device="cpu")
    cache.put(key, autotune.Choice("cuda", (("block", (8, 32)), ("unroll", 4)),
                                   source="measured", us=123.5))
    path = tmp_path / "tc.json"
    cache.save(str(path))
    back = autotune.TuningCache.load(str(path))
    assert back.entries == cache.entries
    got = back.get(key)
    assert got.impl == "cuda" and got.us == 123.5
    assert got.param_dict() == {"block": (8, 32), "unroll": 4}
    # JAX's format: the same document but for the impl's name
    jcache = jat.TuningCache()
    jcache.put(key, jat.Choice("pallas", (("block", (8, 32)), ("unroll", 4)),
                               source="measured", us=123.5))
    mine, theirs = json.loads(cache.to_json()), json.loads(jcache.to_json())
    assert mine["version"] == theirs["version"] == autotune.CACHE_VERSION == 1
    theirs["entries"][key]["impl"] = "cuda"
    assert mine == theirs


def test_tuning_cache_rejects_wrong_version():
    with pytest.raises(ValueError, match="version"):
        autotune.TuningCache.from_json('{"version": 999, "entries": {}}')
    with pytest.raises(ValueError, match="impl"):
        autotune.Choice("pallas")


def test_cold_cache_falls_back_to_heuristic(tmp_path):
    missing = tmp_path / "nope.json"
    choice = autotune.choose("dwell", cache=str(missing), n=64, max_dwell=32,
                             device="cpu")
    assert choice.source == "heuristic" and choice.impl == "torch"
    broken = tmp_path / "broken.json"
    broken.write_text('{"version": 7}')
    assert autotune.choose("dwell", cache=str(broken), n=64, max_dwell=32,
                           device="cpu").source == "heuristic"


def test_warm_cache_wins_over_heuristic(tmp_path):
    cache = autotune.TuningCache()
    key = autotune.cache_key("dwell", n=64, max_dwell=32, device="cpu")
    cache.put(key, autotune.Choice("cuda", (("block", (4, 32)), ("unroll", 16)),
                                   source="measured", us=1.0))
    path = tmp_path / "tc.json"
    cache.save(str(path))
    choice = autotune.choose("dwell", cache=str(path), n=64, max_dwell=32,
                             device="cpu")
    assert choice.source == "cache"
    assert choice.param_dict() == {"block": (4, 32), "unroll": 16}
    # memoised: the same object on the next call
    assert autotune.choose("dwell", cache=str(path), n=64, max_dwell=32,
                           device="cpu") is choice
    other = autotune.choose("dwell", cache=str(path), n=128, max_dwell=32,
                            device="cpu")
    assert other.source == "heuristic"
    # and the route hands the schedule to the wrapper (the plain version on
    # the CPU, which no schedule changes)
    pol = KernelPolicy(backend="tuned", tuning_cache=str(path))
    assert ops._route(pol, "dwell", device="cpu", n=64, max_dwell=32) == (
        "cuda", {"block": (4, 32), "unroll": 16})
    assert torch.equal(ops.mandelbrot(64, max_dwell=32, device="cpu", policy=pol),
                       ops.mandelbrot(64, max_dwell=32, device="cpu"))


def test_overrides_beat_the_cache(tmp_path):
    cache = autotune.TuningCache()
    cache.put(autotune.cache_key("perimeter_query", side=16, n=64, max_dwell=32,
                                 device="cpu"),
              autotune.Choice("cuda", (("unroll", 4),)))
    path = tmp_path / "tc.json"
    cache.save(str(path))
    pol = KernelPolicy(backend="tuned", tuning_cache=str(path),
                       overrides={"perimeter_query": {"unroll": 8}})
    assert ops._route(pol, "perimeter_query", device="cpu", side=16, n=64,
                      max_dwell=32) == ("cuda", {"unroll": 8})


def test_card_key_naming_the_plain_version_raises(tmp_path, monkeypatch):
    """On a card the tuned tier runs only CUDA schedules: a cache entry
    keyed for a card with impl ``torch`` is refused, when it is put and
    when it is read."""
    card_key = ("dwell|wl=mandelbrot|dtype=int32|plat=cuda-sm_90|"
                "max_dwell=32|n=64")
    with pytest.raises(ValueError, match="CUDA kernels"):
        autotune.TuningCache().put(card_key, autotune.Choice("torch"))
    path = tmp_path / "tc.json"
    path.write_text(json.dumps({"version": 1, "entries": {card_key: {
        "impl": "torch", "params": {}, "source": "measured", "us": 1.0}}}))
    monkeypatch.setattr(autotune, "platform", lambda device: "cuda-sm_90")
    with pytest.raises(ValueError, match="CUDA kernels"):
        autotune.choose("dwell", cache=str(path), n=64, max_dwell=32,
                        device="cuda")
    # a CPU key may name either
    cpu_key = card_key.replace("cuda-sm_90", "cpu")
    autotune.TuningCache().put(cpu_key, autotune.Choice("torch"))


@pytest.mark.parametrize("kernel", ["dwell", "perimeter_query", "region_dwell",
                                    "region_dwell_pooled", "region_fill",
                                    "region_fill_pooled", "olt_compact",
                                    "batched_ranks"])
def test_card_heuristics_are_todays_schedules(kernel, monkeypatch):
    """The card's heuristic is each kernel's default schedule, a CUDA one;
    the CPU's and a grid workload's are the plain version, as JAX's are
    jnp there."""
    assert autotune.heuristic(kernel, device="cpu") == autotune.Choice("torch")
    monkeypatch.setattr(_build, "on_card", lambda device: True)
    got = autotune.heuristic(kernel, device="cuda")
    assert got.impl == "cuda" and got.source == "heuristic"
    assert got.param_dict() == autotune.DEFAULT_SCHEDULES.get(kernel, {})
    ssd = get_workload("ssd_synth")
    assert autotune.heuristic(kernel, workload=ssd, device="cuda").impl == "torch"
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.heuristic("warp", device="cuda")


def test_default_schedules_name_the_sources_kunroll():
    """DEFAULT_SCHEDULES equals each .cu's kUnroll line (the default the
    launch functions take for unroll 0) and Ex's kBlock."""
    import re
    want = {"dwell": "mandelbrot_dwell", "perimeter_query": "perimeter_query",
            "region_dwell": "region_dwell",
            "region_dwell_pooled": "region_dwell_pooled"}
    for kernel, lib in want.items():
        text = (_build.CSRC / f"{lib}.cu").read_text()
        (u,) = re.findall(r"constexpr int kUnroll = (\d+);", text)
        assert autotune.DEFAULT_SCHEDULES[kernel]["unroll"] == int(u)
    (b,) = re.findall(r"constexpr int kBlock = (\d+);",
                      (_build.CSRC / "mandelbrot_dwell.cu").read_text())
    assert autotune.DEFAULT_SCHEDULES["dwell"]["block"] == (int(b), int(b))
    assert autotune.DEFAULT_SCHEDULES["dwell"]["block"] == _build.EX_BLOCKS[0]


def test_card_candidates_are_cuda_schedules(monkeypatch):
    monkeypatch.setattr(_build, "on_card", lambda device: True)
    dwell = list(autotune._candidates("dwell", n=256, max_dwell=64))
    assert len(dwell) == 9 and {c[0] for c in dwell} == {"cuda"}
    assert {(c[1]["unroll"], c[1]["block"]) for c in dwell} == {
        (u, b) for u in (4, 8, 16) for b in ((16, 16), (8, 32), (4, 32))}
    tiny = list(autotune._candidates("dwell", tiny=True, n=256, max_dwell=64))
    assert tiny == [("cuda", {"block": (16, 16), "unroll": 4}),
                    ("cuda", {"block": (16, 16), "unroll": 16})]
    for kernel in ("perimeter_query", "region_dwell", "region_dwell_pooled"):
        assert list(autotune._candidates(kernel, side=16, n=256)) == [
            ("cuda", {"unroll": u}) for u in (4, 8, 16)]
    for kernel in ("olt_compact", "region_fill_pooled"):
        assert list(autotune._candidates(kernel, n=256)) == [("cuda", {})]
    ssd = get_workload("ssd_synth")
    assert list(autotune._candidates("dwell", workload=ssd, n=256)) == [
        ("torch", {})]
    monkeypatch.undo()
    assert list(autotune._candidates("dwell", n=256, max_dwell=64,
                                     device="cpu")) == [("torch", {})]


def test_tune_measures_and_records(tmp_path):
    cache = autotune.TuningCache()
    best = autotune.tune("olt_compact", cache=cache, reps=1, tiny=True, n=32,
                         device="cpu")
    assert best.source == "measured" and best.us > 0
    key = autotune.cache_key("olt_compact", n=32, device="cpu")
    assert cache.get(key) == best
    path = tmp_path / "tc.json"
    cache.save(str(path))
    assert autotune.choose("olt_compact", cache=str(path), n=32,
                           device="cpu").source == "cache"


def test_runner_inputs_are_jaxs_draws():
    """The runners time what JAX's time: the same numpy draws."""
    x = autotune._inputs("perimeter_query", device="cpu", side=16, n=256)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x["coords"].numpy(),
                                  rng.integers(0, 16, size=(64, 2)))
    assert int(x["count"]) == 64
    x = autotune._inputs("region_fill_pooled", device="cpu", side=64, n=256, F=2)
    rng = np.random.default_rng(0)
    rows = np.stack([rng.integers(0, 2, size=32), rng.integers(0, 4, size=32),
                     rng.integers(0, 4, size=32)], axis=1)
    np.testing.assert_array_equal(x["rows"].numpy(), rows)
    np.testing.assert_array_equal(x["values"].numpy(),
                                  rng.integers(0, 256, size=32))
    assert x["canvas"].shape == (512, 256)
    with pytest.raises(ValueError, match="no runner"):
        autotune._build_runner("region_fill", "torch", {}, device="cpu",
                               side=16, n=64)


@pytest.mark.parametrize("kernel,sig", [
    ("dwell", dict(n=64, max_dwell=32)),
    ("perimeter_query", dict(side=16, n=64, max_dwell=32)),
    ("region_dwell", dict(side=16, n=64, max_dwell=32)),
    ("olt_compact", dict(n=100)),
    ("region_fill_pooled", dict(side=16, n=64, F=2)),
    ("region_dwell_pooled", dict(side=16, n=64, F=2, max_dwell=32))])
def test_runners_compute_what_jax_computes(kernel, sig):
    """Each runner's output on the CPU equals the plain version on the
    same inputs (the candidate check of ``tune`` compares these)."""
    from repro_torch.kernels import ref
    x = autotune._inputs(kernel, device="cpu", **sig)
    out = autotune._build_runner(kernel, "torch", {}, device="cpu", inputs=x,
                                 **sig)()
    out_cuda = autotune._snapshot(autotune._build_runner(
        kernel, "cuda", {}, device="cpu", inputs=x, **sig)())
    for a, b in zip(autotune._snapshot(out), out_cuda):
        assert torch.equal(a, b)
    if kernel == "olt_compact":
        ranks, count = ref.compact_ranks_ref(x["flags"])
        assert torch.equal(out[0], ranks) and int(out[1]) == int(count)


def test_cli_writes_a_cache(tmp_path, capsys):
    out = tmp_path / "sub" / "tc.json"
    assert autotune.main(["--tiny", "--n", "128", "--max-dwell", "32",
                          "--out", str(out), "--device", "cpu",
                          "--reps", "1"]) == 0
    cache = autotune.TuningCache.load(str(out))
    assert cache.entries and all("|plat=cpu|" in k for k in cache.entries)
    assert "platform=cpu" in capsys.readouterr().out
