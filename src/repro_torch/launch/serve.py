"""Batched serving driver: prefill a batch of prompts, then decode greedily.

    python -m repro_torch.launch.serve --arch xlstm_125m --batch 4 \
        --prompt-len 32 --max-new 16 [--full-config] [--device cpu]

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default ``cuda``, which needs a card), for every arch of
``repro_torch.configs``.  Parameters are random, drawn on the device from a ``torch.Generator`` seeded with 0;
prompts (and the encoder's frames / the vision stub's patches) are drawn
from numpy's ``default_rng(0)`` as in the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.snapshot import resolve_device
from repro_torch.models import init_params
from repro_torch.train import make_prefill, make_serve_step


class Generation(NamedTuple):
    tokens: np.ndarray        # (B, max_new) int32, the first from the prefill
    logits: torch.Tensor      # (B, vocab) fp32, the last step's
    caches: list              # the decode caches after the last step
    prefill_s: float
    decode_s: float           # the max_new - 1 decode steps together


def make_batch(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    """The reference's serving batch: random prompts (labels = tokens) and
    the stub inputs of the encoder-decoder / vision configs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32, device=device)}
    out["labels"] = out["tokens"]
    if cfg.encoder_groups is not None:
        out["frames"] = torch.as_tensor(
            rng.normal(size=(batch, 16, cfg.enc_input_dim)), dtype=torch.float32, device=device)
    if cfg.vision_tokens:
        out["patches"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.vision_tokens, cfg.vision_dim)),
            dtype=torch.float32, device=device)
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, batch, max_new: int) -> Generation:
    """Prefill ``batch`` then ``max_new - 1`` greedy decode steps."""
    device = batch["tokens"].device
    prompt_len = batch["tokens"].shape[1]
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, memory = make_prefill(cfg, prompt_len + max_new)(params, batch)
    tok = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve = make_serve_step(cfg)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        tok, logits, caches = serve(params, caches, tok, prompt_len + i, memory=memory)
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    return Generation(gen, logits, caches, t_prefill, t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else get_reduced_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch(cfg, args.batch, args.prompt_len, device)
    out = generate(cfg, params, batch, args.max_new)

    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} device={device}")
    print(f"prefill: {out.prefill_s*1e3:.0f} ms   decode: "
          f"{out.decode_s/max(args.max_new-1,1)*1e3:.1f} ms/token")
    for b in range(min(args.batch, 2)):
        print(f"  sample[{b}]: {out.tokens[b].tolist()}")
    return out.tokens


if __name__ == "__main__":
    main()
