"""The port's checkpointer and train CLI on the CPU.

JAX's five ``tests/test_checkpoint.py`` cases mirrored for the port (atomic
round trip, a corrupt or manifest-less checkpoint skipped, retention, a
shape mismatch raising), plus a missing leaf, a bf16 round trip bit for
bit (numpy has no bfloat16: the raw 16 bits with "bfloat16" in the
manifest), a whole train state restored into a ``meta`` structure, and
``python -m repro_torch.launch.train --device cpu --reduced`` in
subprocesses: crashed at step 3, resumed from its checkpoint, its losses
equal to an uninterrupted run's. ``--mesh`` must name as many ranks as
``WORLD_SIZE`` (the sharded CLI runs under torchrun:
``test_torch_sharded_cli.py``); the default device raises on a machine
without a card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.steps import StepOptions

SRC = Path(__file__).resolve().parent.parent / "src"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,))},
            "opt": {"m": torch.ones((4, 8)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=v.dtype,
                                                                 device="meta")
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(10, tree, extra={"arch": "x"})
    assert ck.latest_step() == 10
    out = ck.restore(10, _like(tree))
    for a, b in zip(_leaves(tree), _leaves(out), strict=True):
        assert b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(a, b)
    assert ck.manifest_extra(10)["arch"] == "x"
    assert not list(tmp_path.glob(".tmp-*"))  # the temp directory was renamed


def test_corrupt_checkpoint_skipped(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    step_dir = tmp_path / "step_0000000002"
    victim = next(p for p in step_dir.iterdir() if p.suffix == ".npy")
    victim.write_bytes(b"garbage")
    assert ck.latest_step() == 1  # falls back to newest *consistent*
    with pytest.raises(FileNotFoundError):
        ck.restore(2, _like(_tree()))


def test_missing_manifest_skipped(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _tree())
    (tmp_path / "step_0000000005" / "manifest.json").unlink()
    assert ck.latest_step() is None


def test_retention_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.steps() == [3, 4]


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.empty((5,), device="meta")})


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(KeyError, match="missing leaf v"):
        ck.restore(1, {"w": torch.empty((4,)), "v": torch.empty((4,))})


def test_bf16_round_trip_bit_for_bit(tmp_path):
    """Every bit pattern of a bf16 leaf (NaNs, infinities, subnormals,
    -0) comes back; the manifest says "bfloat16"; a bf16 module restored
    onto ``meta`` is allocated and filled."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    leaf = bits.view(torch.bfloat16).reshape(256, 256)
    model = torch.nn.Linear(3, 5).to(torch.bfloat16)
    ck = Checkpointer(tmp_path)
    path = ck.save(3, {"x": leaf, "model": model})
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["leaves"]["x"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["x"]["shape"] == [256, 256]
    assert manifest["leaves"]["model/weight"]["dtype"] == "bfloat16"
    like_model = torch.nn.Linear(3, 5, device="meta").to(torch.bfloat16)
    out = ck.restore(3, {"x": torch.empty_like(leaf, device="meta"),
                         "model": like_model})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), bits.reshape(256, 256))
    assert out["model"] is like_model and like_model.weight.device.type == "cpu"
    for a, b in zip(model.parameters(), like_model.parameters(), strict=True):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_round_trip(tmp_path, compress):
    """``launch.train.build``'s state (the model, AdamW's dicts, the step,
    the residual) saved and restored into ``init_state(device="meta")``:
    every parameter and state tensor equal, the model's still requiring
    grad."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    _, init_state = train.build(cfg, StepOptions(compress_grads=compress),
                                device="cpu")
    state = init_state(5)
    state["opt"]["step"] += 3
    for t in state["opt"]["m"].values():
        t.normal_()
    Checkpointer(tmp_path).save(3, state)
    out = Checkpointer(tmp_path).restore(3, init_state(5, "meta"), device="cpu")
    assert sorted(out) == sorted(state)
    for (n, a), (m, b) in zip(state["params"].named_parameters(),
                              out["params"].named_parameters(), strict=True):
        assert n == m and torch.equal(a, b) and b.requires_grad
    for k in ("master", "m", "v"):
        assert list(out["opt"][k]) == list(state["opt"][k])
        assert all(torch.equal(out["opt"][k][n], t) for n, t in state["opt"][k].items())
    assert int(out["opt"]["step"]) == 3 and out["opt"]["step"].dtype == torch.int32
    if compress:
        assert list(out["residual"]) == list(state["residual"])


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
         "--reduced", "--device", "cpu", "--steps", "6", "--seq-len", "32",
         "--global-batch", "4", "--log-every", "1", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cli_crash_resume_matches_uninterrupted(tmp_path):
    """A run that crashes at step 3 (its last checkpoint at step 2) and is
    started again resumes at step 2 and logs steps 2..5 with the losses of
    an uninterrupted run, bit for bit (the CPU path is deterministic)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ref = _cli(tmp_path / "a")
    assert ref.returncode == 0, ref.stderr
    want = json.loads((tmp_path / "a" / "experiments" /
                       "train_qwen3-4b-reduced.json").read_text())
    assert [r["step"] for r in want] == list(range(6))
    ck = ["--ckpt-dir", str(tmp_path / "b" / "ckpt"), "--ckpt-every", "2"]
    crashed = _cli(tmp_path / "b", *ck, "--crash-at-step", "3")
    assert crashed.returncode != 0 and "injected crash at step 3" in crashed.stderr
    assert Checkpointer(tmp_path / "b" / "ckpt").steps() == [2]
    resumed = _cli(tmp_path / "b", *ck)
    assert resumed.returncode == 0, resumed.stderr
    assert "[resume] restoring step 2" in resumed.stdout
    got = json.loads((tmp_path / "b" / "experiments" /
                      "train_qwen3-4b-reduced.json").read_text())
    assert [r["step"] for r in got] == [2, 3, 4, 5]
    assert [r["loss"] for r in got] == [r["loss"] for r in want[2:]]
    assert np.isfinite([r["loss"] for r in want]).all()
    assert Checkpointer(tmp_path / "b" / "ckpt").latest_step() == 6


def test_cli_mesh_must_match_world_size(monkeypatch):
    """``--mesh 3x1`` is 3 ranks: with ``WORLD_SIZE`` 1 (or none) the CLI
    raises before it brings up any process group."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="--mesh 3x1 needs 3 ranks, and WORLD_SIZE is 1"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                    "--mesh", "3x1"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                    "--mesh", "2x1"])
    assert not torch.distributed.is_initialized()


def test_cli_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
