#!/usr/bin/env python3
"""Tabulate the dry-run's records of one mesh, one row an arch.

    PYTHONPATH=src python3 tools/dryrun_table.py DIR [--mesh single] [--tag baseline]

DIR holds the records ``python -m repro_torch.launch.dryrun`` writes
(``{tag}--{arch}--{shape}--{mesh}.json``). Each cell gives: the rank's
argument GiB as the dry-run counted it (the inputs the step read), in
brackets the spec-only sum (``dryrun.cell_specs``/``spec_bytes``, every
input: tests/test_torch_dryrun_cli.py holds it equal to JAX's shard
shapes for every full-size cell), the predicted peak GiB a rank, the
collectives' GB a step, and the trace's seconds; a skipped or failed
cell its status. The numbers are the dry-run's predictions, computed on
fake tensors on the CPU, not measurements on a card. A second table lists
the cells whose predicted peak passes ``--limit`` GiB (80 by default, an
H100's memory): the arguments, what the step adds, the weights it
binds on every rank, its microbatches and query chunk. A third lists the
decode cells: the weights bound on every rank, the all-gathers (count,
GB a step) and whether one of them gathered a cache leaf: whether an
all-gather's result has the dims, in any order, of one group of a cache
leaf that a model axis splits past the batch dim, gathered whole for the
rank's rows (``gathered_leaves``; the record's ``all_gather_shapes``).
A fourth lists every cell's bound weights beside the most bytes of them
gathered and alive at once (the record's ``gathered_weights_peak_bytes``:
the steps gather a block's weights when it runs and free them after).
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

GiB = 2 ** 30


def abstract_mesh(mesh_name: str):
    """The production mesh a record's ``mesh_name`` names, shape only."""
    from repro_torch.launch.mesh import AbstractMesh, production_mesh_shape
    split = int(mesh_name.split("split")[1]) if "split" in mesh_name else None
    return AbstractMesh(*production_mesh_shape(multi_pod=mesh_name.startswith("multi"),
                                               model_split=split))


def spec_only_bytes(arch: str, shape: str, mesh_name: str) -> int:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import cell_specs, spec_bytes
    mesh = abstract_mesh(mesh_name)
    cfg = get_config(arch)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    return sum(spec_bytes(*part)
               for part in cell_specs(cfg, SHAPES[shape], mesh, pol).values())


def bound_weight_bytes(arch: str, kind: str, mesh_name: str) -> int:
    """The bytes of the weights a sharded step binds on every rank over
    the step, a block's at a time (``launch/steps.py``'s ``_Gathered``):
    each weight whole over the data
    axes and as its tensor-parallel block over the model axes
    (``launch.tensor_parallel.plan``), a MoE's experts split over the EP
    axes (all the model axes, as the dry-run sets ``ep_axis``), no encoder
    weight in a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_shape, model_axes
    from repro_torch.launch.tensor_parallel import plan
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    mesh = abstract_mesh(mesh_name)
    shape = mesh_shape(mesh)
    model = init_params(cfg, device="meta")
    split = plan(cfg, mesh, model).split
    total = 0
    for n, p in model.named_parameters():
        if kind == "decode" and n.startswith("encoder."):
            continue
        axes = (model_axes(mesh) if cfg.moe and "experts" in n.split(".")
                else split.get(n, (0, ()))[1])
        total += p.numel() * p.element_size() // math.prod(shape[a] for a in axes)
    return total


def gathered_leaves(arch: str, shape: str, mesh_name: str) -> dict:
    """{sorted dims: leaf} of a decode cell's cache leaves that a model
    axis splits on a dim past the batch: one group's block with those dims
    whole, the shape gathering it would build."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import cell_specs
    from repro_torch.launch.mesh import mesh_shape, model_axes
    mesh = abstract_mesh(mesh_name)
    cfg = get_config(arch)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    specs, shardings = cell_specs(cfg, SHAPES[shape], mesh, pol)["cache"]
    size, model = mesh_shape(mesh), set(model_axes(mesh))
    out = {}
    for j, slot in specs.items():
        for k, t in slot.items():
            spec = shardings[j][k].spec
            block = list(sh.shard_shape(mesh, spec, t.shape))
            cut = False
            for d, entry in enumerate(tuple(spec)[2:], start=2):
                names = (entry,) if isinstance(entry, str) else tuple(entry or ())
                for a in names:
                    if a in model and size[a] > 1:
                        block[d] *= size[a]
                        cut = True
            if cut:
                out[tuple(sorted(block[1:]))] = f"{j}.{k}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", type=Path)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--limit", type=float, default=80.0)
    args = ap.parse_args(argv)
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    recs = {}
    for f in sorted(args.dir.glob(f"{args.tag}--*--{args.mesh}.json")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    over = []
    for arch in registry():
        cells = []
        for shape in SHAPES:
            r = recs.get((arch, shape))
            if r is None:
                cells.append("not run")
                continue
            if r["status"] != "ok":
                cells.append(r["status"])
                continue
            m = r["memory"]
            spec = spec_only_bytes(arch, shape, args.mesh)
            arg = f"{m['argument_bytes'] / GiB:.2f}"
            if spec != m["argument_bytes"]:
                arg += f" [{spec / GiB:.2f}]"
            peak = m["peak_per_device_bytes"] / GiB
            cells.append(f"{arg} / {peak:.1f} / "
                         f"{r['collectives']['total_bytes'] / 1e9:.2f} / {r['trace_s']}")
            if peak > args.limit:
                over.append((arch, shape, r))
        print(f"| {arch} | " + " | ".join(cells) + " |")
    if over:
        print()
        print("| cell | peak GiB | arguments GiB | step's own (temp) GiB | "
              "bound weights GiB | microbatch | q_chunk |")
        print("| --- | --- | --- | --- | --- | --- | --- |")
        for arch, shape, r in over:
            m = r["memory"]
            weights = bound_weight_bytes(arch, r["kind"], args.mesh)
            print(f"| {arch} {shape} | {m['peak_per_device_bytes'] / GiB:.1f} | "
                  f"{m['argument_bytes'] / GiB:.1f} | {m['temp_bytes'] / GiB:.1f} | "
                  f"{weights / GiB:.1f} | "
                  f"{r['config_overrides'].get('microbatch')} | "
                  f"{r.get('auto_overrides', {}).get('q_chunk')} |")
    decode = [(a, sh_, r) for (a, sh_), r in recs.items()
              if r["status"] == "ok" and r["kind"] == "decode"]
    if decode:
        print()
        print("| decode cell | bound weights GiB | all-gathers | all-gather GB "
              "| cache leaves split | a cache leaf gathered |")
        print("| --- | --- | --- | --- | --- | --- |")
        for arch, shape, r in sorted(decode):
            ag = r["collectives"]["by_kind"].get("all-gather", 0.0)
            leaves = gathered_leaves(arch, shape, args.mesh)
            shapes = r["collectives"].get("all_gather_shapes")
            hit = ("not recorded" if shapes is None else
                   ", ".join(sorted({leaves[d] for s in shapes
                                     if (d := tuple(sorted(s))) in leaves}))
                   or "none")
            print(f"| {arch} {shape} | "
                  f"{bound_weight_bytes(arch, 'decode', args.mesh) / GiB:.2f} | "
                  f"{r['comm_ops']['all-gather']} | {ag / 1e9:.3f} | "
                  f"{len(leaves)} | {hit} |")
    done = [(a, sh_, r) for (a, sh_), r in recs.items() if r["status"] == "ok"]
    if done:
        print()
        print("| cell | bound weights GiB | gathered weights alive at once GiB "
              "| peak GiB |")
        print("| --- | --- | --- | --- |")
        for arch, shape, r in sorted(done):
            live = r["collectives"].get("gathered_weights_peak_bytes")
            live = "not recorded" if live is None else f"{live / GiB:.3f}"
            print(f"| {arch} {shape} | "
                  f"{bound_weight_bytes(arch, r['kind'], args.mesh) / GiB:.2f} | "
                  f"{live} | {r['memory']['peak_per_device_bytes'] / GiB:.1f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
