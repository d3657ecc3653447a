"""The train, prefill and serve steps, PyTorch port of ``repro.train.steps``.

``make_train_step``: forward + streaming CE loss + backward + clipped
AdamW, the params and optimizer state updated in place (the reference
donates them).  Gradients are cast to bf16 when the config's activation
dtype is bf16 (the reference's bf16 gradient all-reduce, DESIGN.md #4)
before the global norm, which the reference takes over the bf16
gradients; the optimizer math upcasts to fp32 per leaf.  The params take
``requires_grad`` only inside the step, so serving builds no graph.
``make_prefill``: the context pass that builds the decode caches.
``make_serve_step``: one greedy decode token against the caches (written
in place, ``models.decode_step``).
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, forward_loss, prefill
from repro_torch.models import layers as L
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.train.optimizer import OptHParams, adamw_update


def _loss_and_grad_leaves(params, batch, cfg):
    """(loss, list of the gradients of ``tree_leaves(params)``); a leaf the
    loss does not reach gets a zero gradient, as in JAX."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = forward_loss(params, batch, cfg)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    for i, (g, p) in enumerate(zip(grads, leaves)):
        if g is None:
            grads[i] = torch.zeros_like(p)
    return loss.detach(), grads


def _as_tree(params, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def loss_and_grads(params, batch, cfg):
    """(loss, gradient tree) of ``forward_loss`` at ``params``: the
    reference's ``jax.value_and_grad``."""
    loss, grads = _loss_and_grad_leaves(params, batch, cfg)
    return loss, _as_tree(params, grads)


def make_train_step(cfg, hp: OptHParams):
    def train_step(params, opt_state, batch):
        loss, grads = _loss_and_grad_leaves(params, batch, cfg)
        if cfg.activation_dtype == "bfloat16":
            # bf16 gradient all-reduce (compression); fp32 again in AdamW.
            # Leaf by leaf, so each fp32 gradient is freed as its copy is made.
            for i, g in enumerate(grads):
                grads[i] = g.to(torch.bfloat16)
            del g
        params, opt_state, metrics = adamw_update(params, _as_tree(params, grads), opt_state, hp)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill(cfg, cache_len: int):
    def prefill_step(params, batch):
        logits, caches, memory = prefill(params, batch, cfg, cache_len)
        return logits, caches, memory

    return prefill_step


def make_serve_step(cfg, *, greedy: bool = True):
    def serve_step(params, caches, token, pos, memory=None):
        logits, caches = decode_step(params, caches, token, pos, cfg, memory=memory)
        logits = logits[..., : cfg.vocab]
        next_token = torch.argmax(L.unshard(logits, -1), dim=-1).to(torch.int32)
        return next_token, logits, caches

    return serve_step
