"""The serve steps, PyTorch port of the serve half of ``repro.train.steps``.

``make_prefill``: the context pass that builds the decode caches.
``make_serve_step``: one greedy decode token against the caches (written
in place, ``models.decode_step``).  The train step, the optimizer and the
checkpoint are ROADMAP item 13c.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, prefill


def make_prefill(cfg, cache_len: int):
    def prefill_step(params, batch):
        logits, caches, memory = prefill(params, batch, cfg, cache_len)
        return logits, caches, memory

    return prefill_step


def make_serve_step(cfg, *, greedy: bool = True):
    def serve_step(params, caches, token, pos, memory=None):
        logits, caches = decode_step(params, caches, token, pos, cfg, memory=memory)
        logits = logits[..., : cfg.vocab]
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches

    return serve_step
