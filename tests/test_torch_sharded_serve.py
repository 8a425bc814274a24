"""Serving over a mesh: the port's ``generate`` on 4 gloo ranks against
JAX's serving loop, and ``serve --mesh 2x2`` under ``torchrun`` against
the same CLI without a mesh.

R4: JAX's serve CLI fails with a mesh (its ``ep_axis="model"`` reaches
``with_sharding_constraint`` on jax 0.9.0), so the port's sharded serving
is held against JAX's loop without one (``test_torch_models.
_jax_generate``: jitted prefill and serve steps). As JAX's CLI does on a
mesh, the port sets ``ep_axis="model"`` for a MoE config and places
nothing else: every rank runs the whole batch, each model rank computes
its experts, and the partial outputs are summed over the model axis.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from test_torch_models import _jax_generate, _pair, _tokens
from torch_ranks import SRC, run_ranks, save_tree

torch.set_num_threads(1)

MOE = "moonshot-v1-16b-a3b"


def test_serve_on_a_mesh_equals_jax_unsharded(tmp_path):
    """Reduced moonshot on (2, 2), experts split over the model axis: every
    rank's greedy tokens are JAX's serving loop's without a mesh (R4)."""
    from test_torch_models import _pair, _tokens
    jc, tc, params, _ = _pair(MOE)
    save_tree(tmp_path / "params.npz", jax.tree_util.tree_map(np.asarray, params))
    toks = _tokens(jc, 2, 16, seed=5)
    np.save(tmp_path / "tokens.npy", toks)
    want = _jax_generate(jc, params, toks, 6)
    outs = run_ranks("serve", tmp_path, 4, mesh=[2, 2], axes=["data", "model"],
                     arch=MOE, params="params.npz", tokens="tokens.npy", gen=6)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tokens"].numpy(), want, err_msg=f"rank {r}")


def _serve_cli(cwd: Path, *args, nproc=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", MOE,
           "--reduced", "--device", "cpu", "--batch", "4", "--prompt-len", "16",
           "--gen", "8", *args]
    if nproc:
        cmd[1:3] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.serve"]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=env)


def test_serve_cli_mesh_2x2_equals_no_mesh(tmp_path):
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve
    --mesh 2x2`` prints (rank 0 only) the same sample ids as the CLI in
    one process without a mesh."""
    plain = _serve_cli(tmp_path)
    assert plain.returncode == 0, plain.stderr
    sharded = _serve_cli(tmp_path, "--mesh", "2x2", nproc=4)
    assert sharded.returncode == 0, sharded.stderr[-4000:]
    ids = [line for line in plain.stdout.splitlines() if "sample generated ids" in line]
    got = [line for line in sharded.stdout.splitlines() if "sample generated ids" in line]
    assert len(ids) == 1 and got == ids, (ids, got)
    assert "mesh=2x2" in sharded.stdout and "mesh=1x1" in plain.stdout
