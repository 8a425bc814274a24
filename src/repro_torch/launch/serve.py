"""Serving: batched prefill + greedy decode loop.

Counterpart of ``repro/launch/serve.py``::

    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --reduced \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu

runs a request batch end to end for any config the port builds: prefill
builds the cache (attention's KV, MLA's latent, the Mamba and xLSTM
states), then the serve step decodes one token per iteration for the whole
batch (every request shares the step). The cache is allocated once, at
prompt + generation length (JAX pads a prompt-length cache to that length;
the values are the same). Weights are random, from ``--seed``. The device is
the card unless ``--device cpu``; with no card the default raises. There
is no ``--mesh``: sharding is ROADMAP queue 1 slice 14.8.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.steps import greedy, make_prefill_step, make_serve_step

__all__ = ["Generation", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # [B, gen] int32, on the model's device
    prefill_ms: float  # prompt pass and first token, host clock
    decode_ms: float  # the gen - 1 decode steps, host clock

    @property
    def decode_ms_per_token(self) -> float:
        return self.decode_ms / max(self.tokens.shape[1] - 1, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, model, tokens: torch.Tensor, gen: int) -> Generation:
    """Greedy generation of ``gen`` tokens after the prompt ``tokens``
    [B, P]: one prefill step (its logits give the first token), then
    ``gen - 1`` serve steps. The times end in a device synchronize."""
    if gen < 1:
        raise ValueError(f"gen={gen}: generate at least one token")
    device = tokens.device
    B, P = tokens.shape
    prefill = make_prefill_step(cfg, cache_len=P + gen)
    serve = make_serve_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    tok = greedy(cfg, logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = serve(model, cache, {"tokens": tok, "pos": P + i})
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(tokens=torch.cat(out, dim=1), prefill_ms=t_prefill * 1e3,
                      decode_ms=t_decode * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = init_params(cfg, seed=args.seed, device=device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    B, P = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device=device, dtype=torch.int64)
    res = generate(cfg, model, tokens, args.gen)
    print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen} device={device}")
    print(f"prefill: {res.prefill_ms:.1f} ms  decode: {res.decode_ms:.1f} ms "
          f"({res.decode_ms_per_token:.2f} ms/tok/batch)")
    print("sample generated ids:", res.tokens[0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
