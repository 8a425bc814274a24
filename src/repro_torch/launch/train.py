"""The trainer: resumable, elastic, straggler-aware.

Counterpart of ``repro/launch/train.py``::

    python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 20 \\
        --device cpu [--ckpt-dir DIR --ckpt-every 5 --microbatch 2 ...]
    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch qwen3-4b --reduced --mesh 2x4 --device cpu ...

trains a model with random initial parameters (from ``--seed``) on the
synthetic stream (``data.SyntheticLMData``), on the card unless
``--device cpu`` (with no card the default raises). Its behaviours:
  * auto-resume: on start, restore the newest checkpoint that verifies
    (the data stream is a pure function of the step, so resume is exact);
  * periodic checkpoints every ``--ckpt-every`` steps and a final one
    (atomic, with a manifest: ``checkpoint/``);
  * straggler watchdog: an EWMA of the step's wall time; a step slower
    than ``--straggler-factor`` x the EWMA is logged with its index;
  * ``--crash-at-step N`` raises at step N, to prove that restart works;
  * the losses are written as JSON to ``experiments/train_<arch>.json``;
  * ``--mesh DxM``: the sharded step (``launch/steps.py``) on a (data=D,
    model=M) mesh, one process a rank under ``torchrun`` (``RANK``,
    ``WORLD_SIZE``: it raises unless ``WORLD_SIZE`` is D*M), NCCL on the
    card, gloo with ``--device cpu``. As in JAX, the batch rows go on the
    data axis when the global batch divides by D (``act_sharding``), and
    MoE configs split their experts over the model axis (``ep_axis``);
  * elastic restart: the checkpoint stores unsharded leaves, and resuming
    places each onto the current mesh, so ``--mesh`` may change between
    runs.
Without ``torchrun``'s environment, ``--mesh 1x1`` runs in one process,
unsharded. Rank 0 prints and writes the log.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import torch

__all__ = ["build", "main", "cli_mesh", "local_device"]


def build(cfg, opts, *, device="cuda", mesh=None, fsdp=None):
    """(step_fn, init_state). ``init_state(seed, device=device)`` makes
    the train state {"params": the model (random, requiring grad), "opt":
    ``adamw_init``'s[, "residual"]}; on ``device="meta"`` it allocates
    nothing, the structure to restore a checkpoint into. With a ``mesh``,
    the sharded step, and ``init_state(seed)`` makes each rank's blocks of
    that state and nothing more (``steps.init_train_state``: a leaf at a
    time, the same values as without a mesh); ``init_state(seed,
    "meta")`` gives ``train_state_specs``' structure, and
    ``init_state.shardings`` its NamedShardings (None without a mesh),
    what ``Checkpointer.restore`` places the leaves by. ``fsdp``: JAX's
    switch (``ShardingPolicy.for_arch``; None: by the parameter count)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          train_state_specs)
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.grad_compress import init_residual

    dev = resolve_device(device)
    step_fn = make_train_step(cfg, opts, mesh=mesh)
    specs = None
    if mesh is not None:
        specs = train_state_specs(cfg, mesh,
                                  sh.ShardingPolicy.for_arch(cfg, mesh, fsdp),
                                  compress=opts.compress_grads)

    def init_state(seed: int = 0, device=dev):
        if specs is not None and torch.device(device).type == "meta":
            return specs[0]
        if specs is not None:
            return init_train_state(cfg, specs[1], seed, device,
                                    compress=opts.compress_grads)
        model = init_params(cfg, seed, device, requires_grad=True)
        state = {"params": model, "opt": adamw_init(model)}
        if opts.compress_grads:
            state["residual"] = init_residual(model)
        return state

    init_state.shardings = specs[1] if specs else None
    return step_fn, init_state


def cli_mesh(text: str, device):
    """The CLIs' ``--mesh``: None (one process, no mesh) for ``1x1``
    without ``torchrun``'s environment; else the (data, model)
    DeviceMesh of the process group, brought up from that environment if
    none is up. Raises when ``WORLD_SIZE`` is not D*M. Returns (mesh,
    whether this call brought the group up)."""
    from repro_torch.launch.mesh import init_distributed, make_mesh
    d, m = (int(x) for x in text.split("x"))
    if "WORLD_SIZE" not in os.environ and (d, m) == (1, 1):
        return None, False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != d * m:
        raise ValueError(f"--mesh {text} needs {d * m} ranks, and WORLD_SIZE "
                         f"is {world} (run it under torchrun --nproc-per-node "
                         f"{d * m})")
    owned = init_distributed(device)
    return make_mesh((d, m), ("data", "model"), device=device.type), owned


def local_device(device):
    """This rank's device: ``device``, on the card the ``LOCAL_RANK``-th."""
    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x4")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--crash-at-step", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = local_device(args.device)
    mesh, owned = cli_mesh(args.mesh, device)
    try:
        return _train(args, cfg, device, mesh)
    finally:
        if owned:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device, mesh) -> int:
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.data import SyntheticLMData, make_pipeline
    from repro_torch.launch.steps import StepOptions

    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        d = mesh.size(0)
        if args.global_batch % d == 0:
            cfg = dataclasses.replace(cfg, act_sharding=("data",))
        if cfg.moe:
            cfg = dataclasses.replace(cfg, ep_axis="model")
    case = ShapeCase("custom", "train", args.seq_len, args.global_batch)
    opts = StepOptions(microbatch=args.microbatch,
                       compress_grads=args.compress_grads)
    step_fn, init_state = build(cfg, opts, device=device, mesh=mesh)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    data = SyntheticLMData(cfg, case, seed=args.seed)
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        where = f" (elastic onto mesh {args.mesh})" if mesh is not None else ""
        say(f"[resume] restoring step {start}{where}", flush=True)
        state = ckpt.restore(start, init_state(args.seed, "meta"), device=device,
                             shardings=init_state.shardings)
    else:
        state = init_state(args.seed)

    ewma = None
    log = []
    for step, batch in make_pipeline(data, start, stop_step=args.steps):
        if args.crash_at_step is not None and step == args.crash_at_step:
            raise RuntimeError(f"injected crash at step {step}")
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step > start + 2:
            say(f"[straggler] step {step}: {dt:.3f}s vs ewma "
                f"{ewma:.3f}s", flush=True)
        if step % args.log_every == 0:
            say(f"step {step:6d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} "
                f"{dt*1e3:.0f}ms", flush=True)
        log.append({"step": step, "loss": metrics["loss"], "wall_s": dt})
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"arch": cfg.name})
            say(f"[ckpt] step {step + 1}", flush=True)
    if ckpt:
        ckpt.save(args.steps, state, extra={"arch": cfg.name})
    out = Path("experiments") / f"train_{cfg.name}.json"
    if lead:
        out.parent.mkdir(exist_ok=True)
        out.write_text(json.dumps(log))
    say(f"final loss {log[-1]['loss']:.4f} ({len(log)} steps) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
