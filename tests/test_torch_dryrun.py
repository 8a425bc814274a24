"""The port's dry-run (``repro_torch.launch.dryrun.run_cell``) against the
JAX package's, cell by cell.

JAX's ``run_cell`` runs in one subprocess a file, with 8 placeholder CPU
devices, on meshes built with Auto axes (R1: ``launch/mesh.py``'s
``jax.make_mesh`` defaults to Explicit axes, on which JAX's steps fail);
the port's runs in this process on the fake process group of 8 ranks.
Reduced configs with 8 heads, 4 KV heads and the vocabulary padded to 64
(JAX's ``test_small_mesh_dryrun_train_and_decode``), a train (8 x 32), a
prefill (8 x 32) and a decode (8 rows, cache 64) cell each on (2, 4),
and on the split mesh (2, 2, 2) (``data``, ``model_a``, ``model_b``)
whisper with 6 heads (JAX's ``test_split_model_mesh_2d_tp``: its heads
split over ``model_a``, ``model_b`` left over), qwen3 and moonshot.

Per cell: both "ok"; the port's keys are JAX's with ``trace_s`` for
``lower_compile_s``, ``comm_ops`` for ``hlo_ops`` and no ``loops``;
``params``, ``active_params``, ``fsdp``, ``auto_overrides``,
``config_overrides`` and ``mesh`` equal; the argument and aliased
bytes exactly equal (the rank's blocks of the inputs; the state or the
cache updated in place, JAX's donation); the output bytes at most 1%
under JAX's, never over (XLA's output adds its tuple tables); and the
port's peak is argument + output + temp - alias. This file: the dense and
MoE decoders and the split mesh; ``test_torch_dryrun_hybrid.py`` the
other families.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCase
from repro_torch.launch import sharding as sh
from repro_torch.launch.dryrun import init_fake_group, run_cell
from repro_torch.launch.mesh import make_mesh

ROOT = Path(__file__).resolve().parent.parent
AXES = {2: ("data", "model"), 3: ("data", "model_a", "model_b")}
SMALL = {"num_heads": 8, "num_kv_heads": 4, "vocab_pad_multiple": 64}
WHISPER6 = {"num_heads": 6, "num_kv_heads": 6, "vocab_pad_multiple": 64}
KINDS = {"train": ("t", "train", 32, 8), "prefill": ("p", "prefill", 32, 8),
         "decode": ("d", "decode", 64, 8)}
SUBSTITUTED = {"lower_compile_s": "trace_s", "hlo_ops": "comm_ops", "loops": None}


def cells_of(archs, kinds=tuple(KINDS), mesh=(2, 4), change=SMALL) -> dict:
    return {f"{arch}-{kind}-{'x'.join(map(str, mesh))}":
            dict(arch=arch, change=change, case=KINDS[kind], mesh=list(mesh))
            for arch in archs for kind in kinds}


CELLS = {
    **cells_of(["qwen3-4b", "chatglm3-6b", "command-r-plus-104b", "granite-34b",
                "moonshot-v1-16b-a3b"]),
    **cells_of(["qwen3-4b", "moonshot-v1-16b-a3b"], ("train", "decode"), (2, 2, 2)),
    **cells_of(["whisper-large-v3"], ("train", "decode"), (2, 2, 2), WHISPER6),
}

JAX_CELLS = """
    import dataclasses, json, sys
    import jax
    from jax.sharding import AxisType
    assert len(jax.devices()) == 8  # before the dry-run module sets its flag
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCase
    from repro.launch.dryrun import run_cell
    AXES = {2: ("data", "model"), 3: ("data", "model_a", "model_b")}
    for cid, c in json.loads(sys.argv[1]).items():
        shape = tuple(c["mesh"])
        mesh = jax.make_mesh(shape, AXES[len(shape)],
                             axis_types=(AxisType.Auto,) * len(shape))
        cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["change"])
        rec = run_cell(cfg, ShapeCase(*c["case"]), mesh)
        print("REC " + json.dumps([cid, rec]), flush=True)
"""


def start_jax(cells: dict) -> subprocess.Popen:
    """JAX's run_cell over ``cells`` in a subprocess with 8 CPU devices."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_CELLS),
                             json.dumps(cells)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def jax_records(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-4000:]
    return dict(json.loads(line[4:]) for line in out.splitlines()
                if line.startswith("REC "))


def port_records(cells: dict) -> dict:
    """The port's run_cell over ``cells`` on the fake group of 8 ranks
    (brought up here and taken down after)."""
    assert not dist.is_initialized()
    init_fake_group(8)
    try:
        meshes, out = {}, {}
        for cid, c in cells.items():
            shape = tuple(c["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, AXES[len(shape)], device="cpu")
            cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["change"])
            mesh = meshes[shape]
            rec = run_cell(cfg, ShapeCase(*c["case"]), mesh)
            out[cid] = json.loads(json.dumps(rec))  # tuples as JAX's JSON has them
        return out
    finally:
        dist.destroy_process_group()


def records(cells: dict) -> tuple:
    """(JAX's records, the port's): JAX's subprocess runs while the port
    traces."""
    proc = start_jax(cells)
    try:
        port = port_records(cells)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return jax_records(proc), port


def check_cell(jrec: dict, prec: dict) -> None:
    assert jrec["status"] == "ok", jrec.get("error")
    assert prec["status"] == "ok", prec.get("traceback")
    want = {SUBSTITUTED.get(k, k) for k in jrec} - {None}
    assert set(prec) == want, set(prec) ^ want
    for k in ("params", "active_params", "fsdp", "auto_overrides",
              "config_overrides", "mesh", "arch", "shape", "kind"):
        assert prec[k] == jrec[k], k
    jm, pm = jrec["memory"], prec["memory"]
    assert set(pm) == set(jm)
    assert pm["argument_bytes"] == jm["argument_bytes"]
    assert pm["alias_bytes"] == jm["alias_bytes"]
    assert 0 <= jm["output_bytes"] - pm["output_bytes"] <= 0.01 * jm["output_bytes"], (
        jm["output_bytes"], pm["output_bytes"])
    assert pm["peak_per_device_bytes"] == (pm["argument_bytes"] + pm["output_bytes"]
                                           + pm["temp_bytes"] - pm["alias_bytes"])
    assert pm["temp_bytes"] >= 0
    assert set(prec["comm_ops"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                     "all-to-all", "collective-permute"}
    assert prec["collectives"]["unresolved_loops"] == 0
    assert prec["collectives"]["op_count"] == sum(prec["comm_ops"].values())
    assert prec["cost"]["flops"] > 0 and prec["cost"]["bytes_accessed"] > 0


@pytest.fixture(scope="module")
def recs():
    return records(CELLS)


@pytest.mark.parametrize("cid", list(CELLS))
def test_run_cell_matches_jax(recs, cid):
    jrecs, precs = recs
    check_cell(jrecs[cid], precs[cid])


def test_split_mesh_policy_is_jax_2d_tp():
    """Whisper with 6 heads on (2, 2, 2): the model axes are both, the
    heads split over ``model_a`` and ``model_b`` left over (the
    dry-run's EP and 2-D TP axes)."""
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((2, 2, 2), AXES[3])
    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(), **WHISPER6)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    assert pol.model == ("model_a", "model_b")
    assert pol.heads_split(mesh, 6) == (("model_a",), ("model_b",))


def test_run_cell_refuses_without_the_fake_group(tmp_path):
    """No group up, or a real one: run_cell raises before it traces."""
    from repro_torch.launch.mesh import AbstractMesh
    cfg = get_config("qwen3-4b").reduced()
    case = ShapeCase(*KINDS["decode"])
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        run_cell(cfg, case, AbstractMesh((1, 1), AXES[2]))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), AXES[2], device="cpu")
        with pytest.raises(RuntimeError, match="not the fake one"):
            run_cell(cfg, case, mesh)
    finally:
        dist.destroy_process_group()
