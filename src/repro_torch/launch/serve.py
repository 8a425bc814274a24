"""Serving: batched prefill + greedy decode loop.

Counterpart of ``repro/launch/serve.py``::

    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --reduced \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu

runs a request batch end to end for any config: prefill builds the cache
(attention's KV, MLA's latent, the Mamba and xLSTM states), then the serve
step decodes one token per iteration for the whole batch (every request
shares the step). Vision configs take random media [B, num_media_tokens,
D] and audio configs random frames [B, prompt_len, D] (normal x 0.02 in
the compute dtype, as JAX's CLI makes them); audio encodes the frames once
for the decode steps' memory. The cache is allocated once, at
prompt + generation length (JAX pads a prompt-length cache to that length;
the values are the same). Weights are random, from ``--seed``. The device is
the card unless ``--device cpu``; with no card the default raises.

``--mesh DxM`` (under ``torchrun``, as the train CLI's): as JAX's, it sets
``ep_axis="model"`` for MoE configs and places nothing else. Every rank
holds the whole model and runs the whole batch; each model rank computes
its share of the experts, and the partial outputs are summed over the
model axis. Rank 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.steps import greedy, make_prefill_step, make_serve_step
from repro_torch.models.transformer import make_memory

__all__ = ["Generation", "generate", "make_media", "serve", "main"]


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # [B, gen] int32, on the model's device
    prefill_ms: float  # prompt pass and first token, host clock
    decode_ms: float  # the gen - 1 decode steps, host clock
    encode_ms: float = 0.0  # audio: the decode steps' memory, host clock

    @property
    def decode_ms_per_token(self) -> float:
        return self.decode_ms / max(self.tokens.shape[1] - 1, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, model, tokens: torch.Tensor, gen: int,
             media: Optional[torch.Tensor] = None, *, mesh=None) -> Generation:
    """Greedy generation of ``gen`` tokens after the prompt ``tokens``
    [B, P]: one prefill step (its logits give the first token), then
    ``gen - 1`` serve steps. ``media``: vision's patch embeddings or
    audio's frames. The prefill step takes the media (and encodes audio's
    frames itself); every serve step takes ``make_memory``'s output, made
    once and timed apart (for audio, a second encode, as JAX's CLI does).
    The times end in a device synchronize. ``mesh``: the DeviceMesh that
    ``cfg.ep_axis`` names an axis of."""
    if gen < 1:
        raise ValueError(f"gen={gen}: generate at least one token")
    device = tokens.device
    B, P = tokens.shape
    prefill = make_prefill_step(cfg, cache_len=P + gen, mesh=mesh)
    serve = make_serve_step(cfg, mesh=mesh)
    batch = {"tokens": tokens, "media": media}

    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        memory = make_memory(cfg, model, media)
    _sync(device)
    t_encode = time.perf_counter() - t0 if cfg.encoder_layers else 0.0

    t0 = time.perf_counter()
    logits, cache = prefill(model, batch)
    tok = greedy(cfg, logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, cache = serve(model, cache, {"tokens": tok, "pos": P + i,
                                          "memory": memory})
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return Generation(tokens=torch.cat(out, dim=1), prefill_ms=t_prefill * 1e3,
                      decode_ms=t_decode * 1e3, encode_ms=t_encode * 1e3)


def make_media(cfg: ArchConfig, batch: int, frames: int,
               generator: torch.Generator, device) -> Optional[torch.Tensor]:
    """JAX's CLI media: normal x 0.02 in the compute dtype, [B,
    num_media_tokens, D] for vision, [B, frames, D] for audio (the CLI's
    frames are the prompt length, as JAX's), None otherwise."""
    if cfg.frontend == "vision":
        shape = (batch, cfg.num_media_tokens, cfg.d_model)
    elif cfg.frontend == "audio":
        shape = (batch, frames, cfg.d_model)
    else:
        return None
    return torch.randn(shape, generator=generator, device=device,
                       dtype=cfg.cdtype) * 0.02


def serve(cfg: ArchConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device="cuda", mesh=None) -> Generation:
    """What the CLI serves: a model with random parameters from ``seed``
    on ``device``, ``batch`` random prompts of ``prompt_len`` tokens (and
    the config's media), ``gen`` tokens generated. With a ``mesh``, as
    JAX's CLI on a mesh: ``ep_axis="model"`` for a MoE config, nothing
    else placed."""
    from repro_torch.models.transformer import init_params
    if mesh is not None and cfg.moe:
        cfg = dataclasses.replace(cfg, ep_axis="model")
    model = init_params(cfg, seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                           device=device, dtype=torch.int64)
    media = make_media(cfg, batch, prompt_len, g, device)
    return generate(cfg, model, tokens, gen, media, mesh=mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.launch.train import cli_mesh, local_device

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = local_device(args.device)
    mesh, owned = cli_mesh(args.mesh, device)
    try:
        res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, seed=args.seed, device=device, mesh=mesh)
        if mesh is None or torch.distributed.get_rank() == 0:
            B, P = args.batch, args.prompt_len
            print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
                  f"device={device} mesh={args.mesh}")
            enc = f"encode: {res.encode_ms:.1f} ms  " if cfg.encoder_layers else ""
            print(f"{enc}prefill: {res.prefill_ms:.1f} ms  decode: "
                  f"{res.decode_ms:.1f} ms ({res.decode_ms_per_token:.2f} "
                  "ms/tok/batch)")
            print("sample generated ids:", res.tokens[0, :12].tolist())
    finally:
        if owned:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
