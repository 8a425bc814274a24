"""The trainer: resumable, straggler-aware, on one device.

Counterpart of ``repro/launch/train.py``::

    python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 20 \\
        --device cpu [--ckpt-dir DIR --ckpt-every 5 --microbatch 2 ...]

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
  * the losses are written as JSON to ``experiments/train_<arch>.json``.

One device: ``--mesh`` accepts only ``1x1``, and the port sets neither
``act_sharding`` nor ``ep_axis``, which JAX's CLI sets for its mesh; the
sharded, elastic layout is ROADMAP queue 1 slice 14.8.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

__all__ = ["build", "main"]


def build(cfg, opts, *, device="cuda"):
    """(step_fn, init_state). ``init_state(seed, device=device)`` makes
    the train state {"params": the model (random, requiring grad), "opt":
    ``adamw_init``'s[, "residual"]}; on ``device="meta"`` it allocates
    nothing, the structure to restore a checkpoint into."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.grad_compress import init_residual

    dev = resolve_device(device)
    step_fn = make_train_step(cfg, opts)

    def init_state(seed: int = 0, device=dev):
        model = init_params(cfg, seed, device, requires_grad=True)
        state = {"params": model, "opt": adamw_init(model)}
        if opts.compress_grads:
            state["residual"] = init_residual(model)
        return state

    return step_fn, init_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL: only 1x1")
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

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.data import SyntheticLMData, make_pipeline
    from repro_torch.launch.steps import StepOptions
    from repro_torch.models.common import resolve_device
    from repro_torch.models.moe import SHARDING_SLICE

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise NotImplementedError(f"--mesh {args.mesh}: {SHARDING_SLICE}")
    device = resolve_device(args.device)
    case = ShapeCase("custom", "train", args.seq_len, args.global_batch)
    opts = StepOptions(microbatch=args.microbatch,
                       compress_grads=args.compress_grads)
    step_fn, init_state = build(cfg, opts, device=device)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    data = SyntheticLMData(cfg, case, seed=args.seed)
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        print(f"[resume] restoring step {start}", flush=True)
        state = ckpt.restore(start, init_state(args.seed, "meta"), device=device)
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
            print(f"[straggler] step {step}: {dt:.3f}s vs ewma "
                  f"{ewma:.3f}s", flush=True)
        if step % args.log_every == 0:
            print(f"step {step:6d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"{dt*1e3:.0f}ms", flush=True)
        log.append({"step": step, "loss": metrics["loss"], "wall_s": dt})
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra={"arch": cfg.name})
            print(f"[ckpt] step {step + 1}", flush=True)
    if ckpt:
        ckpt.save(args.steps, state, extra={"arch": cfg.name})
    out = Path("experiments") / f"train_{cfg.name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(log))
    print(f"final loss {log[-1]['loss']:.4f} ({len(log)} steps) -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
