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
gathers on every rank, its microbatches and query chunk.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

GiB = 2 ** 30


def spec_only_bytes(arch: str, shape: str, mesh_name: str) -> int:
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import cell_specs, spec_bytes
    from repro_torch.launch.mesh import AbstractMesh, production_mesh_shape
    split = int(mesh_name.split("split")[1]) if "split" in mesh_name else None
    mesh = AbstractMesh(*production_mesh_shape(multi_pod=mesh_name.startswith("multi"),
                                               model_split=split))
    cfg = get_config(arch)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    return sum(spec_bytes(*part)
               for part in cell_specs(cfg, SHAPES[shape], mesh, pol).values())


def gathered_weight_bytes(arch: str, kind: str, model_ranks: int) -> int:
    """The bytes of the weights a sharded step gathers on every rank
    (``launch/steps.py``'s ``_Gathered``): every weight whole, but a MoE's
    experts split over the ``model_ranks`` of the EP axes, and no encoder
    weight in a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    total = 0
    for n, p in init_params(cfg, device="meta").named_parameters():
        if kind == "decode" and n.startswith("encoder."):
            continue
        share = model_ranks if cfg.moe and "experts" in n.split(".") else 1
        total += p.numel() * p.element_size() // share
    return total


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
                         f"{r['collectives']['total_bytes'] / 1e9:.1f} / {r['trace_s']}")
            if peak > args.limit:
                over.append((arch, shape, r))
        print(f"| {arch} | " + " | ".join(cells) + " |")
    if over:
        print()
        print("| cell | peak GiB | arguments GiB | step's own (temp) GiB | "
              "gathered weights GiB | microbatch | q_chunk |")
        print("| --- | --- | --- | --- | --- | --- | --- |")
        for arch, shape, r in over:
            m = r["memory"]
            model_ranks = math.prod(v for a, v in zip(r["mesh"]["axes"],
                                                      r["mesh"]["shape"])
                                    if a.startswith("model"))
            weights = gathered_weight_bytes(arch, r["kind"], model_ranks)
            print(f"| {arch} {shape} | {m['peak_per_device_bytes'] / GiB:.1f} | "
                  f"{m['argument_bytes'] / GiB:.1f} | {m['temp_bytes'] / GiB:.1f} | "
                  f"{weights / GiB:.1f} | "
                  f"{r['config_overrides'].get('microbatch')} | "
                  f"{r.get('auto_overrides', {}).get('q_chunk')} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
