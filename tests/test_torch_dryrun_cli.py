"""The port's dry-run CLI at full size, and the argument bytes of every
full-size cell against JAX's specs.

``python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k
--mesh single`` traces the cell on the fake group of 256 ranks (the CLI
brings it up) and writes one record with status "ok", printing JAX's
per-cell line and ``done:`` line; its argument bytes are the sum, over
the parameters, the cache and the batch, of JAX's shard shapes on an
``AbstractMesh((16, 16))``. The same spec-only sum (no trace) holds for
all ten full-size configs x train_4k / prefill_32k / decode_32k on the
single-pod (16, 16) and multi-pod (2, 16, 16) meshes.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.configs import get_config as jax_config
from repro.configs import shapes as jshapes
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro_torch.configs import get_config, registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import sharding as sh
from repro_torch.launch.dryrun import cell_specs, spec_bytes
from repro_torch.launch.mesh import AbstractMesh, production_mesh_shape

ROOT = Path(__file__).resolve().parent.parent
ARCHS = list(registry())
CELL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@functools.lru_cache(maxsize=None)
def jax_argument_bytes(arch: str, shape: str, multi: bool) -> int:
    """The bytes of JAX's shard shapes of the cell's step inputs (state or
    params, cache, batch) on an AbstractMesh of the production mesh."""
    cfg, case = jax_config(arch), jshapes.SHAPES[shape]
    jm = JaxAbstractMesh(*production_mesh_shape(multi_pod=multi))
    pol = jsh.ShardingPolicy.for_arch(cfg, jm)
    bsds = jshapes.batch_specs(cfg, case, dtype=cfg.cdtype)
    trees = [(bsds, jsh.batch_shardings(cfg, jm, pol, bsds))]
    if case.kind == "train":
        trees.append(jsteps.train_state_specs(cfg, jm, pol))
    else:
        psds = jshapes.param_specs(cfg)
        trees.append((psds, jsh.params_shardings(cfg, jm, pol, psds)))
    if case.kind == "decode":
        csds = jshapes.cache_specs(cfg, case)
        trees.append((csds, jsh.cache_shardings(cfg, jm, pol, csds)))
    total = 0
    for sds, shd in trees:
        for leaf, s in zip(jax.tree_util.tree_leaves(sds), jax.tree_util.tree_leaves(
                shd, is_leaf=lambda x: isinstance(x, JaxNamedSharding))):
            total += math.prod(s.shard_shape(leaf.shape)) * leaf.dtype.itemsize
    return total


def port_argument_bytes(arch: str, shape: str, multi: bool, **change) -> int:
    cfg, case = get_config(arch), dataclasses.replace(SHAPES[shape], **change)
    mesh = AbstractMesh(*production_mesh_shape(multi_pod=multi))
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    return sum(spec_bytes(*part) for part in cell_specs(cfg, case, mesh, pol).values())


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", CELL_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_specs(arch, shape, multi):
    assert port_argument_bytes(arch, shape, multi) == jax_argument_bytes(arch, shape,
                                                                         multi)


def run_cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out", str(tmp_path / "out")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


def test_cli_one_full_size_cell(tmp_path):
    r = run_cli(tmp_path, "--arch", "qwen3-4b", "--shape", "decode_32k",
                "--mesh", "single")
    files = list((tmp_path / "out").iterdir())
    assert [f.name for f in files] == ["baseline--qwen3-4b--decode_32k--single.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == {"shape": [16, 16], "axes": ["data", "model"]}
    assert rec["mesh_name"] == "single" and rec["tag"] == "baseline"
    assert rec["memory"]["argument_bytes"] == jax_argument_bytes(
        "qwen3-4b", "decode_32k", False)
    lines = r.stdout.splitlines()
    assert any(line.startswith("[ok     ] qwen3-4b") and "decode_32k" in line
               and "peak/dev=" in line for line in lines), r.stdout
    assert lines[-1] == "done: ok=1 failed=0 skipped=0"


def test_cli_seq_len_names_and_traces_the_shorter_cell(tmp_path):
    """``--seq-len 64``: the cell is named ``prefill_32k@seq_len=64``, its
    record lists the length, and its argument bytes are those of the
    prompt of 64 (not of 32768)."""
    r = run_cli(tmp_path, "--arch", "qwen3-4b", "--shape", "prefill_32k",
                "--mesh", "single", "--seq-len", "64")
    name = "prefill_32k@seq_len=64"
    files = list((tmp_path / "out").iterdir())
    assert [f.name for f in files] == [f"baseline--qwen3-4b--{name}--single.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["shape"] == name and rec["config_overrides"]["seq_len"] == 64
    short = port_argument_bytes("qwen3-4b", "prefill_32k", False, seq_len=64)
    assert rec["memory"]["argument_bytes"] == short
    assert short < port_argument_bytes("qwen3-4b", "prefill_32k", False)
    assert any(line.startswith("[ok     ] qwen3-4b") and name in line
               for line in r.stdout.splitlines()), r.stdout
