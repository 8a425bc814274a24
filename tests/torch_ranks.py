"""Multi-process runs of the port's sharded paths on the CPU, for the tests.

``run_ranks(task, workdir, world, **args)`` starts ``world`` processes of
this file, one a rank; each brings up a gloo process group through a
``FileStore`` under ``workdir`` (no port is opened), builds the
``DeviceMesh`` that ``args["mesh"]`` and ``args["axes"]`` name, runs
``TASKS[task]`` and saves what it returns to
``workdir/<task>_out_<rank>.pt``. Inputs that come from
the JAX package (parameters, tokens, activations) are written by the test
as ``.npy``/``.npz`` files into ``workdir`` first: the ranks import torch
and the port only. Each rank runs on one thread; the whole run has a
time limit, after which every rank is killed and the test fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


# -- the launcher (test side) ---------------------------------------------------

def run_ranks(task: str, workdir: Path, world: int, timeout: float = 240, **args):
    """Run ``task`` on ``world`` ranks; returns the ranks' outputs, in rank
    order. Raises with the failing ranks' output on a non-zero exit or at
    the time limit."""
    import torch
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / f"{task}.json").write_text(json.dumps(args))
    store = workdir / f"{task}.store"
    if store.exists():
        store.unlink()
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(workdir), str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{task} on {world} ranks: over {timeout} s")
    bad = [(r, p.returncode, logs[r]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, "\n".join(f"rank {r} exit {c}:\n{log[-4000:]}" for r, c, log in bad)
    return [torch.load(workdir / f"{task}_out_{r}.pt") for r in range(world)]


def save_tree(path: Path, tree) -> None:
    """A nested dict of arrays as one ``.npz``, keys joined by "."."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, name)
            else:
                a = np.asarray(v)
                flat[name] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: Path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            node = out
            *keys, leaf = name.split(".")
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = z[name]
    return out


def mask_labels(batch: dict, vocab_size: int) -> dict:
    """The batch with labels masked unevenly over its rows: row 0's first
    five below 0, one of row 1 in the vocabulary padding (the ranks that
    hold them count fewer valid labels than the others)."""
    labels = batch["labels"].copy()
    labels[0, :5] = -1
    labels[1, 3] = vocab_size + 3
    return dict(batch, labels=labels)


# -- the ranks ------------------------------------------------------------------------

def _config(arch: str, change: dict):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    moe = change.pop("moe", None)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **change)


def train(mesh, workdir: Path, args: dict) -> list:
    """For each of ``args["cases"]`` ({arch, change, opts, params[, mask]}):
    ``args["steps"]`` sharded steps from JAX's parameters (the case's
    ``.npz``) on the synthetic batches (B x S, seed 0), the config as the
    train CLI sets it on a mesh (with ``mask``, ``mask_labels``'); per
    step the metrics; at the end the
    whole state gathered (``full_tensor``), this rank's blocks and the
    shapes of the expert weights its compute model was given."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (StepOptions, make_train_step,
                                          shard_train_state, train_state_specs)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.grad_compress import init_residual
    B, S = args["batch"]
    outs = []
    bound = _record_bound_experts()
    for case in args["cases"]:
        cfg = _config(case["arch"], dict(case.get("change", {})))
        if B % mesh.size(0) == 0:
            cfg = dataclasses.replace(cfg, act_sharding=("data",))
        if cfg.moe:  # the model axis, or the split mesh's model axes
            cfg = dataclasses.replace(
                cfg, ep_axis=sh.ShardingPolicy.for_arch(cfg, mesh).model)
        bound.clear()
        opts = StepOptions(**case["opts"])
        model = convert.params_from_jax(cfg, load_tree(workdir / case["params"]),
                                        device="cpu", requires_grad=True)
        state = {"params": model, "opt": adamw_init(model)}
        if opts.compress_grads:
            state["residual"] = init_residual(model)
        pol = sh.ShardingPolicy.for_arch(cfg, mesh)
        _, shardings = train_state_specs(cfg, mesh, pol, compress=opts.compress_grads)
        state = shard_train_state(state, shardings)
        step = make_train_step(cfg, opts, mesh=mesh)
        data = SyntheticLMData(cfg, ShapeCase("t", "train", S, B), seed=0)
        metrics = []
        for s in range(args["steps"]):
            batch = data.batch_at(s)
            if case.get("mask"):
                batch = mask_labels(batch, cfg.vocab_size)
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        full, blocks = {}, {}
        for part, tree in (("params", state["params"]),
                           ("master", state["opt"]["master"]),
                           ("m", state["opt"]["m"]), ("v", state["opt"]["v"]),
                           ("residual", state.get("residual", {}))):
            full[part] = {n: t.full_tensor() for n, t in tree.items()}
            blocks[part] = {n: t.to_local().clone() for n, t in tree.items()}
        outs.append(dict(metrics=metrics, full=full, blocks=blocks,
                         step=int(state["opt"]["step"]),
                         coord=mesh.get_coordinate(),
                         specs={n: tuple(s.spec)
                                for n, s in shardings["params"].items()},
                         bound_experts=dict(bound)))
    return outs


def _record_bound_experts() -> dict:
    """{parameter name: shape} of the expert weights that the sharded
    steps' compute model is given (``steps._Gathered.bind``), filled at
    every bind from now on in this rank."""
    from repro_torch.launch import steps
    seen: dict = {}
    bind = steps._Gathered.bind

    def recording(self, params):
        leaves = bind(self, params)
        for n, t in zip(params, leaves):
            if "experts" in n.split("."):
                seen[n] = tuple(t.shape)
        return leaves

    steps._Gathered.bind = recording
    return seen


def serve_steps(mesh, workdir: Path, args: dict) -> list:
    """For each of ``args["cases"]`` ({arch, change, params, tokens, gen[,
    media]}): the sharded prefill step and ``gen - 1`` sharded serve steps
    from JAX's parameters, laid out as the dry-run lays them out
    (``act_sharding`` the data axes when the batch divides over them,
    ``ep_axis`` the model axes); returns the prefill logits and the tokens
    gathered, the cache after the last step gathered and as this rank's
    blocks, the cache's specs (from its placements) and the rank's mesh
    coordinates."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (greedy, make_sharded_prefill_step,
                                          make_sharded_serve_step)
    from repro_torch.models import transformer as TT
    names = tuple(mesh.mesh_dim_names)
    outs = []
    bound = _record_bound_experts()
    for case in args["cases"]:
        cfg = _config(case["arch"], dict(case.get("change", {})))
        pol = sh.ShardingPolicy.for_arch(cfg, mesh)
        toks = torch.from_numpy(np.load(workdir / case["tokens"]))
        B, P = toks.shape
        dsize = int(np.prod([mesh.size(names.index(a)) for a in pol.data]))
        if B % dsize == 0:
            cfg = dataclasses.replace(cfg, act_sharding=tuple(pol.data))
        if cfg.moe:
            cfg = dataclasses.replace(cfg, ep_axis=pol.model)
        bound.clear()
        model = convert.params_from_jax(cfg, load_tree(workdir / case["params"]),
                                        device="cpu")
        psh = sh.params_shardings(cfg, mesh, pol, model)
        params = {n: sh.distribute(p, psh[n]) for n, p in model.named_parameters()}
        batch = {"tokens": toks}
        extra = {}
        if case.get("media"):
            media = torch.from_numpy(np.load(workdir / case["media"]))
            batch["media"] = media
            with torch.no_grad():
                mem = TT.make_memory(cfg, model, media)
            extra = {"memory": mem} if cfg.encoder_layers else {"media": media}
        bsh = sh.batch_shardings(cfg, mesh, pol, {**batch, **extra})
        batch = {k: sh.distribute(v, bsh[k]) for k, v in batch.items()}
        extra = {k: sh.distribute(v, bsh[k]) for k, v in extra.items()}
        gen = case["gen"]
        logits, cache = make_sharded_prefill_step(cfg, mesh, cache_len=P + gen)(
            params, batch)
        tok = DTensor.from_local(greedy(cfg, logits.to_local()), mesh,
                                 logits.placements, shape=(B, 1), stride=(1, 1))
        serve = make_sharded_serve_step(cfg, mesh)
        out = [tok.full_tensor()]
        before = {j: {k: v.to_local().data_ptr() for k, v in c.items()}
                  for j, c in cache.items()}
        for i in range(gen - 1):
            tok, cache2 = serve(params, cache, {"tokens": tok, "pos": P + i, **extra})
            assert cache2 is cache
            out.append(tok.full_tensor())
        in_place = all(cache[j][k].to_local().data_ptr() == before[j][k]
                       for j in cache for k in cache[j])

        def spec(dt):
            entries = [[] for _ in range(dt.ndim)]
            for a, pl in zip(names, dt.placements):
                if pl.is_shard():
                    entries[pl.dim].append(a)
            return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                         for e in entries)

        outs.append(dict(
            logits=logits.full_tensor(), tokens=torch.cat(out, dim=1),
            logits_spec=spec(logits), tokens_spec=spec(tok),
            cache={j: {k: v.full_tensor() for k, v in c.items()}
                   for j, c in cache.items()},
            blocks={j: {k: v.to_local().clone() for k, v in c.items()}
                    for j, c in cache.items()},
            cache_specs={j: {k: spec(v) for k, v in c.items()}
                         for j, c in cache.items()},
            in_place=in_place, coord=mesh.get_coordinate(),
            bound_experts=dict(bound)))
    return outs


def serve(mesh, workdir: Path, args: dict) -> dict:
    """``generate`` on the mesh from JAX's parameters, with ``ep_axis`` as
    the serve CLI sets it."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.launch.serve import generate
    cfg = _config(args["arch"], dict(args.get("change", {})))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, ep_axis="model")
    model = convert.params_from_jax(cfg, load_tree(workdir / args["params"]),
                                    device="cpu")
    toks = torch.from_numpy(np.load(workdir / args["tokens"])).long()
    res = generate(cfg, model, toks, args["gen"], mesh=mesh)
    return dict(tokens=res.tokens)


def pipeline(mesh, workdir: Path, args: dict) -> dict:
    """``pipeline_forward`` of JAX's embedded activations through the
    groups of JAX's parameters."""
    import torch

    from repro_torch import convert
    from repro_torch.launch.pipeline import pipeline_forward
    cfg = _config(args["arch"], dict(args.get("change", {})))
    model = convert.params_from_jax(cfg, load_tree(workdir / args["params"]),
                                    device="cpu")
    h = torch.from_numpy(np.load(workdir / args["h"]))
    with torch.no_grad():
        out = pipeline_forward(cfg, model.groups, h, mesh,
                               microbatches=args["microbatches"])
    return dict(out=out, transfers=pipeline_forward.transfers)


TASKS = {"train": train, "serve": serve, "pipeline": pipeline,
         "serve_steps": serve_steps}


def _rank_main(task: str, workdir: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    workdir = Path(workdir)
    args = json.loads((workdir / f"{task}.json").read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(workdir / f"{task}.store"), world),
        rank=rank, world_size=world)
    try:
        mesh = make_mesh(args["mesh"], args["axes"], device="cpu")
        out = TASKS[task](mesh, workdir, args)
        torch.save(out, workdir / f"{task}_out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
