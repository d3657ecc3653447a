"""End-to-end training driver:

    python -m repro_torch.launch.train --arch xlstm_125m --steps 100 \
        [--full-config] [--ckpt-dir DIR --ckpt-every N] [--dedup] [--device cpu]

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``, which needs a card).  Fault-tolerant loop: deterministic
data cursor (``TokenPipeline``), periodic checkpoints (atomic commit, the
reference's format), automatic resume from the latest complete
checkpoint -- a checkpoint either package wrote.  ``--dedup`` runs the
self-join near-duplicate filter (``dedup_token_dataset``, the join on the
device) on the warm-up batch.  Parameters are random, drawn on the device
from a ``torch.Generator`` seeded with 0 (not ``jax.random.key(0)``'s
numbers); the encoder's frames and the vision stub's patches come from
numpy's ``default_rng(step)``, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.snapshot import resolve_device
from repro_torch.data.dedup import dedup_token_dataset
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import init_params
from repro_torch.train import (
    OptHParams, adamw_init, make_train_step,
    restore_checkpoint, save_checkpoint, latest_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--dedup", action="store_true",
                    help="run the self-join near-dup filter on the warmup batch "
                         "(the paper's technique in the input pipeline)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else get_reduced_config(args.arch)
    hp = OptHParams(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq)

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = adamw_init(params, cfg.opt_state_dtype)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        tree, step, extra = restore_checkpoint(args.ckpt_dir, {"params": params, "opt": opt}, device=device)
        params, opt = tree["params"], tree["opt"]
        start = int(extra.get("data_cursor", step))
        print(f"resumed from step {step} (data cursor {start})")

    if args.dedup:
        warm = pipe.batch_at(start)["tokens"]
        kept = dedup_token_dataset(warm, eps=0.05, device=device)
        print(f"dedup: kept {kept.shape[0]}/{warm.shape[0]} examples")

    step_fn = make_train_step(cfg, hp)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in pipe.batch_at(step).items()}
        if cfg.encoder_groups is not None:
            rng = np.random.default_rng(step)
            batch["frames"] = torch.as_tensor(
                rng.normal(size=(args.batch, 16, cfg.enc_input_dim)).astype(np.float32), device=device)
        if cfg.vision_tokens:
            rng = np.random.default_rng(step)
            batch["patches"] = torch.as_tensor(
                rng.normal(size=(args.batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32),
                device=device)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt},
                            extra={"data_cursor": step + 1})
    print("done.")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
