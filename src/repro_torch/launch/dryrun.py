"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

Counterpart of ``repro/launch/dryrun.py``. JAX lowers and compiles each
cell's sharded step for placeholder devices and reads XLA's memory and
cost analyses; the port runs the sharded step itself, once, for rank 0,
under ``FakeTensorMode`` on the fake process group: every tensor is a
shape and a dtype, no storage is allocated and no kernel runs, and each
collective is a no-op that returns a tensor of the right shape. So the
CPU path is what is traced, with the plain ``batched_ranks`` (JAX too
lowers on placeholder CPU devices). Rank 0 stands for every rank: every
spec is divisibility-guarded, so all ranks' blocks have one shape.

For each cell the dry-run:
  1. builds the step's inputs as fake DTensors, each rank's block of its
     spec (``configs/shapes.py``' specs, ``launch/sharding.py``'s rules),
  2. runs the sharded step (``launch/steps.py``: train, prefill, decode)
     on them under ``launch/step_analysis.py``'s counters,
  3. records the rank's memory (JAX's five fields: the arguments' and
     outputs' blocks, the inputs updated in place as the aliased bytes,
     the largest live storage during the step as the peak), the cost
     (flops, bytes accessed), the collectives' bytes and counts into a
     JSON record with JAX's keys, but ``trace_s`` for ``lower_compile_s``,
     ``comm_ops`` for ``hlo_ops`` and no ``loops`` (eager mode has no
     while loops).

``run_cell`` needs the fake process group of the mesh's size to be the
default group (it raises with none, or with another); ``main`` brings one
up itself (256 ranks, 512 with ``--mesh multi``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
Failures (a sharding mismatch, a shape error) are bugs; the harness
records them rather than crashing the sweep, and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

__all__ = ["run_cell", "apply_overrides", "main", "init_fake_group",
           "cell_specs", "spec_bytes", "alias_bytes"]


def init_fake_group(world_size: int) -> None:
    """Bring up the fake process group of ``world_size`` ranks as the
    default group, this process rank 0 (no process is started, nothing is
    sent)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _check_group(mesh) -> None:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("run_cell: no process group is up; the dry-run "
                           "runs on the fake one (init_fake_group)")
    if dist.get_backend() != "fake":
        raise RuntimeError(f"run_cell: the default process group is "
                           f"{dist.get_backend()!r}, not the fake one: the "
                           "dry-run would send and allocate")
    if dist.get_world_size() != mesh.size():
        raise ValueError(f"run_cell: the fake group has {dist.get_world_size()} "
                         f"ranks, the mesh {mesh.size()}")


def _fake_input(spec: torch.Tensor, sharding):
    """A fake DTensor: the rank's block of ``spec`` (a ``meta`` tensor)
    under ``sharding`` (must run under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as sh
    mesh = sharding.mesh
    block = torch.empty(sh.shard_shape(mesh, sharding.spec, spec.shape),
                        dtype=spec.dtype)
    return DTensor.from_local(block, mesh, sh.placements(mesh, sharding.spec),
                              shape=spec.shape, stride=spec.stride())


def _fake_tree(specs: dict, shardings: dict) -> dict:
    return {k: (_fake_tree(v, shardings[k]) if isinstance(v, dict)
                else _fake_input(v, shardings[k]))
            for k, v in specs.items()}


def cell_specs(cfg, case, mesh, pol, *, compress: bool = False) -> dict:
    """The inputs of a cell's step as ``meta`` tensors and their
    NamedShardings: {"state" (train) or "params", "batch"[, "cache"
    (decode)]: (specs, shardings)}, each a dict in the step's layout (the
    batch's ``pos`` a 0-dim int32). ``mesh`` may be an ``AbstractMesh``."""
    from repro_torch.configs.shapes import batch_specs, cache_specs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import train_state_specs
    from repro_torch.models.transformer import init_params
    bsds = batch_specs(cfg, case, dtype=cfg.cdtype)
    out = {"batch": (bsds, sh.batch_shardings(cfg, mesh, pol, bsds))}
    if case.kind == "train":
        out["state"] = train_state_specs(cfg, mesh, pol, compress=compress)
        return out
    psds = {n: p.detach() for n, p in
            init_params(cfg, device="meta").named_parameters()}
    out["params"] = (psds, sh.params_shardings(cfg, mesh, pol, psds))
    if case.kind == "decode":
        csds = cache_specs(cfg, case)
        out["cache"] = (csds, sh.cache_shardings(cfg, mesh, pol, csds))
    return out


def spec_bytes(specs: dict, shardings: dict, inputs=None, read=None) -> int:
    """The bytes of the rank's blocks of the ``meta`` tensors in ``specs``;
    with ``inputs`` (the step's inputs in the same layout) and ``read`` (a
    ``StepTrace.read``), of those whose input the step read only (JAX's
    compiled step drops the arguments it does not use: whisper's encoder
    in a decode step)."""
    from repro_torch.launch import sharding as sh
    total = 0
    for k, v in specs.items():
        if isinstance(v, dict):
            total += spec_bytes(v, shardings[k], None if inputs is None
                                else inputs[k], read)
        elif inputs is None or (k in inputs and read(inputs[k])):
            s = shardings[k]
            total += math.prod(sh.shard_shape(s.mesh, s.spec, v.shape)) \
                * v.element_size()
    return total


def alias_bytes(inputs, outputs) -> int:
    """The bytes of the inputs' storages that an output holds: the inputs
    the step updated in place (JAX's donated and aliased buffers)."""
    from repro_torch.launch.step_analysis import _tensors
    held = {id(t.untyped_storage()) for t in _tensors(outputs)}
    seen, total = set(), 0
    for t in _tensors(inputs):
        st = t.untyped_storage()
        if id(st) in held and id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def run_cell(cfg, case, mesh, *, opts=None, fsdp=None, extra=None):
    """Trace one (arch, shape, mesh) cell; return the record dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import applicable
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.step_analysis import StepTrace, tensor_bytes
    from repro_torch.launch.steps import (StepOptions, make_sharded_prefill_step,
                                          make_sharded_serve_step, make_train_step)
    from repro_torch.models.transformer import reads_pos

    _check_group(mesh)
    shape = mesh_shape(mesh)
    skip = applicable(cfg, case)
    rec = {
        "arch": cfg.name, "shape": case.name, "kind": case.kind,
        "mesh": {"shape": tuple(int(v) for v in shape.values()),
                 "axes": tuple(shape)},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "config_overrides": extra or {},
    }
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    opts = opts or StepOptions()
    pol = sh.ShardingPolicy.for_arch(cfg, mesh, fsdp=fsdp)
    rec["fsdp"] = pol.fsdp
    # anchor activation batch sharding when the (micro)batch divides
    dsize = 1
    for a in pol.data:
        dsize *= shape[a]
    eff_batch = case.global_batch // max(opts.microbatch, 1)
    batch_divides = eff_batch % dsize == 0
    updates = {"ep_axis": pol.model} if cfg.moe else {}
    if batch_divides:
        updates["act_sharding"] = tuple(pol.data)
    # auto q-chunk: cap the per-device f32 score matrix near 2 GiB (JAX's
    # rule, heads split over the model axis as JAX's GSPMD splits them)
    if case.kind in ("train", "prefill") and cfg.q_chunk is None:
        per_dev_b = max(eff_batch // (dsize if batch_divides else 1), 1)
        msize = sh._axis_size(mesh, pol.model)
        h_dev = cfg.num_heads // msize if cfg.num_heads % msize == 0 \
            else cfg.num_heads
        score_bytes = per_dev_b * h_dev * case.seq_len ** 2 * 4
        cap = 2 << 30
        if score_bytes > cap:
            div = 1 << math.ceil(math.log2(score_bytes / cap))
            qc = max(256, case.seq_len // div)
            updates["q_chunk"] = int(qc)
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
        rec["auto_overrides"] = {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in updates.items()}
    t0 = time.time()
    try:
        parts = cell_specs(cfg, case, mesh, pol, compress=opts.compress_grads)
        with FakeTensorMode():
            bsds, bsh = parts["batch"]
            pos = bsds.pop("pos", None)  # decode: a Python int, JAX's int32
            if case.kind == "train":
                state = _fake_tree(*parts["state"])
                state["opt"]["step"] = torch.zeros((), dtype=torch.int32)
                batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                         for k, v in bsds.items()}  # the step keeps its rows
                args = (state, batch)
                inputs = {"state": state, "batch": batch}
                fn = make_train_step(cfg, opts, mesh=mesh)
            else:
                inputs = {"params": _fake_tree(*parts["params"]),
                          "batch": _fake_tree(bsds, bsh)}
                if case.kind == "prefill":
                    args = (inputs["params"], inputs["batch"])
                    fn = make_sharded_prefill_step(cfg, mesh)
                else:
                    inputs["cache"] = _fake_tree(*parts["cache"])
                    inputs["batch"]["pos"] = case.seq_len - 1
                    args = (inputs["params"], inputs["cache"], inputs["batch"])
                    fn = make_sharded_serve_step(cfg, mesh)
            fc = FlopCounterMode(display=False)
            trace = StepTrace()
            trace.track(args)
            with fc, trace:
                out = fn(*args)
            arg_bytes = sum(spec_bytes(*parts[k], inputs[k], trace.read)
                            for k in inputs)
            if pos is not None and reads_pos(cfg):  # JAX drops an unused operand
                arg_bytes += pos.element_size()
            out_bytes = tensor_bytes(out)
            alias = alias_bytes(args, out)
            peak = trace.peak_bytes
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["memory"] = {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(peak - arg_bytes - out_bytes + alias),
            "alias_bytes": int(alias),
            "peak_per_device_bytes": int(peak),
        }
        rec["cost"] = {"flops": float(fc.get_total_flops()),
                       "bytes_accessed": float(trace.bytes_accessed)}
        rec["collectives"] = trace.report.as_dict()
        rec["comm_ops"] = trace.comm_ops
        rec["status"] = "ok"
    except Exception as e:  # record, don't crash the sweep
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=6)
    return rec


def apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, **overrides)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--model-split", type=int, default=None,
                    help="factor the model axis: (model_a=s, model_b=16/s) "
                         "2-D TP for head-misaligned archs (whisper)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="grad-accum chunks; 0 = auto (fit remat carries)")
    ap.add_argument("--fsdp", choices=("auto", "on", "off"), default="auto")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--remat", choices=("on", "off"), default="on")
    ap.add_argument("--remat-policy", choices=("full", "dots"), default=None)
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"), default=None)
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--moe-cf", type=float, default=None)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config, registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
    from repro_torch.launch.steps import StepOptions, auto_microbatch

    regs = registry()
    archs = list(regs) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_ok = n_fail = n_skip = 0
    for multi in meshes:
        mshape, _ = production_mesh_shape(multi_pod=multi,
                                          model_split=args.model_split)
        init_fake_group(math.prod(mshape))
        try:
            mesh = make_production_mesh(multi_pod=multi,
                                        model_split=args.model_split, device="cpu")
            mesh_name = "multi" if multi else "single"
            if args.model_split:
                mesh_name += f"-split{args.model_split}"
            for arch in archs:
                cfg = regs[arch] if arch in regs else get_config(arch)
                overrides = {}
                extra_rec = {}  # JSON-able record of what was overridden
                if args.q_chunk:
                    overrides["q_chunk"] = extra_rec["q_chunk"] = args.q_chunk
                if args.remat == "off":
                    overrides["remat"] = extra_rec["remat"] = False
                if args.remat_policy:
                    overrides["remat_policy"] = args.remat_policy
                    extra_rec["remat_policy"] = args.remat_policy
                if args.kv_dtype:
                    overrides["kv_cache_dtype"] = args.kv_dtype
                    extra_rec["kv_cache_dtype"] = args.kv_dtype
                if (args.moe_group or args.moe_cf) and cfg.moe:
                    overrides["moe"] = dataclasses.replace(
                        cfg.moe,
                        group_size=args.moe_group or cfg.moe.group_size,
                        capacity_factor=args.moe_cf or cfg.moe.capacity_factor)
                    extra_rec["moe_group"] = overrides["moe"].group_size
                    extra_rec["moe_cf"] = overrides["moe"].capacity_factor
                cfg_run = apply_overrides(cfg, overrides)
                for shape in shapes:
                    fname = outdir / f"{args.tag}--{cfg.name}--{shape}--{mesh_name}.json"
                    if args.skip_existing and fname.exists():
                        print(f"[skip-existing] {fname.name}")
                        continue
                    case = SHAPES[shape]
                    mb = args.microbatch or auto_microbatch(cfg_run, case, mesh)
                    opts = StepOptions(microbatch=mb,
                                       compress_grads=args.compress_grads)
                    rec = run_cell(cfg_run, case, mesh, opts=opts, fsdp=fsdp,
                                   extra={**extra_rec, "microbatch": mb})
                    rec["mesh_name"] = mesh_name
                    rec["tag"] = args.tag
                    fname.write_text(json.dumps(rec, indent=1))
                    st = rec["status"]
                    n_ok += st == "ok"
                    n_fail += st == "failed"
                    n_skip += st == "skipped"
                    msg = rec.get("error", rec.get("reason", ""))
                    if st == "ok":
                        mem = rec["memory"]["peak_per_device_bytes"] / 2**30
                        msg = (f"peak/dev={mem:.2f}GiB flops={rec['cost']['flops']:.3g} "
                               f"coll={rec['collectives']['total_bytes']:.3g}B "
                               f"t={rec['trace_s']}s")
                    print(f"[{st:7s}] {cfg.name:24s} {shape:12s} {mesh_name:6s} {msg}",
                          flush=True)
        finally:
            dist.destroy_process_group()
    print(f"done: ok={n_ok} failed={n_fail} skipped={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
