"""The sharded train CLI under ``torchrun``: the counterparts of JAX's
``test_train_crash_resume_and_elastic_mesh`` and
``test_grad_compression_trains`` (``tests/test_distributed.py``, which
fail on jax 0.9.0: R1).

``torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train
--device cpu --mesh DxM ...``: 8 gloo ranks on the CPU, rendezvous on a
port torchrun picks; reduced qwen3-4b, batch 4 x 32, seed 1, a time
limit on every run.
- Elastic: a run on 2x4 crashes at step 5 (checkpoints at steps 2 and
  4), the next on 4x2 prints ``[resume] restoring step 4 (elastic onto
  mesh 4x2)`` and finishes with ``final loss``; its losses equal those of
  an uninterrupted 4x2 run within LOSS_TOL (the state at step 4 was
  reduced over 2 data ranks in one run and 4 in the other: the sums'
  order differs, not the values they stand for). Rank 0 alone prints
  and writes the log.
- Compression: 2x4 with ``--compress-grads --microbatch 2`` trains 4
  steps to a finite ``final loss``, each loss within LOSS_TOL of the same
  CLI's in one process without a mesh.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from torch_ranks import SRC

LOSS_TOL = 1e-5  # the losses of two runs whose reductions differ in order


def _train(cwd: Path, *args, nproc=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
           "--reduced", "--device", "cpu", "--seq-len", "32", "--global-batch",
           "4", "--log-every", "1", *args]
    if nproc:
        cmd[1:3] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train"]
    cwd.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=env)


def _losses(cwd: Path) -> dict:
    log = json.loads((cwd / "experiments" / "train_qwen3-4b-reduced.json").read_text())
    return {r["step"]: r["loss"] for r in log}


def test_train_crash_resume_and_elastic_mesh(tmp_path):
    ck = ["--steps", "8", "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2",
          "--seed", "1"]
    r = _train(tmp_path / "a", *ck, "--mesh", "2x4", "--crash-at-step", "5", nproc=8)
    assert r.returncode != 0 and "injected crash" in (r.stderr + r.stdout)
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == [
        "step_0000000002", "step_0000000004"]
    r = _train(tmp_path / "b", *ck, "--mesh", "4x2", nproc=8)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "[resume] restoring step 4 (elastic onto mesh 4x2)" in r.stdout, r.stdout
    assert r.stdout.count("[resume]") == 1  # rank 0 alone prints
    assert "final loss" in r.stdout
    resumed = _losses(tmp_path / "b")
    assert sorted(resumed) == [4, 5, 6, 7]
    r = _train(tmp_path / "c", "--steps", "8", "--seed", "1", "--mesh", "4x2", nproc=8)
    assert r.returncode == 0, r.stderr[-4000:]
    whole = _losses(tmp_path / "c")
    assert sorted(whole) == list(range(8))
    for s, loss in resumed.items():
        assert abs(loss - whole[s]) <= LOSS_TOL, (s, loss, whole[s])


def test_grad_compression_trains(tmp_path):
    args = ["--steps", "4", "--compress-grads", "--microbatch", "2"]
    r = _train(tmp_path / "mesh", *args, "--mesh", "2x4", nproc=8)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("final loss") == 1
    got = _losses(tmp_path / "mesh")
    one = _train(tmp_path / "one", *args)
    assert one.returncode == 0, one.stderr[-4000:]
    want = _losses(tmp_path / "one")
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert np.isfinite(list(got.values())).all()
    for s in got:
        assert abs(got[s] - want[s]) <= LOSS_TOL, (s, got[s], want[s])
