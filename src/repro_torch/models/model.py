"""The language model: layer groups over stacked parameters, PyTorch port
of ``repro.models.model``.

Each layer group is ``(pattern, repeat)``; the parameters of each pattern
position are stacked along a leading repeat axis, as in the reference,
which ``lax.scan``s over it.  The port loops over it in Python, so a
converted reference tree (``params_from_numpy``) is a leaf-for-leaf copy.
Under autograd the blocks are rematerialized as ``cfg.remat`` /
``remat_mode`` say (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``); serving runs without a graph.
Caches keep the reference's structure too: a list per group, of tuples per
pattern position, of dicts of stacked ``(repeat, ...)`` tensors.

Entry points:
  init_params / abstract_params
  forward_train(params, batch)           -> (loss, logits)
  prefill(params, batch, cache_len)      -> (last-token logits, caches, memory)
  decode_step(params, caches, token, pos) -> (logits, caches)
Encoder-decoder (seamless) and VLM (llama-3.2-vision) share these entry
points; their extra inputs (frames / patch embeddings) ride in the batch
dict.  ``init_params`` and ``init_caches`` take ``device=`` (default
``"cuda"``, which raises without a card); every other entry point runs
where its inputs lie.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.snapshot import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _adt(cfg):
    return L.dt(cfg.activation_dtype)


def _pdt(cfg):
    return L.dt(cfg.param_dtype)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _stack(trees):
    """Stack a list of same-structure trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------- init -----


def _group_init(init, cfg, pattern, repeat):
    """Stacked params: per pattern position, a dict with leading (repeat,)."""
    return [B.block_init(init.stacked(repeat), cfg, blk) for blk in pattern]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and dtypes.

    Dense weights are normal x 1/sqrt(d_in), the embedding table normal x
    0.02, norm scales ones, biases and ``xgate`` zeros, drawn from
    ``generator`` (a generator on ``device`` seeded with 0 when None).
    ``device="meta"`` allocates nothing (``abstract_params``).
    """
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
    init = L.Init(generator, dev)
    dtype = _pdt(cfg)
    params: Dict[str, Any] = {
        "embed": L.embed_init(init, cfg.vocab, cfg.d_model, dtype),
        "groups": [
            _group_init(init, cfg, pattern, repeat) for pattern, repeat in cfg.groups
        ],
        "final_norm": L.rmsnorm_init(init, cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(init, cfg.d_model, cfg.vocab, dtype)
    if cfg.encoder_groups is not None:
        params["enc_proj"] = L.dense_init(init, cfg.enc_input_dim, cfg.d_model, dtype)
        params["enc_groups"] = [
            _group_init(init, cfg, pattern, repeat)
            for pattern, repeat in cfg.encoder_groups
        ]
        params["enc_norm"] = L.rmsnorm_init(init, cfg.d_model, dtype)
    if cfg.vision_tokens:
        params["vision_proj"] = L.dense_init(init, cfg.vision_dim, cfg.d_model, dtype)
    return params


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device -- no allocation."""
    return init_params(cfg, device="meta")


def params_from_numpy(tree, device="cuda"):
    """The port's parameter (or cache) tree from the reference's, as numpy
    leaves (``jax.tree.map(np.asarray, params)``): the same structure, shapes
    and dtypes.  A bfloat16 leaf (``ml_dtypes``) goes through a uint16 view."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if not (a.flags.c_contiguous and a.flags.writeable):   # torch.from_numpy wants a
            a = np.array(a, order="C")                          # writable buffer; 0-d stays 0-d
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree_map(leaf, tree)


# ------------------------------------------------------------- forward -----


def _unstack(tree, n):
    """The ``n`` slices along the leading axis of a stacked tree, each leaf
    ``unbind``-ed once: under autograd the backward of ``unbind`` is one
    ``stack``, where ``a[r]`` for each r would write a zero-filled tensor
    the size of the whole stacked leaf per repeat."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [type(tree)(p[r] for p in parts) for r in range(n)]
    return list(tree.unbind(0))


def _checkpointed(fn):
    """``fn`` rematerialized in the backward (the reference's ``jax.checkpoint``)."""
    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _run_groups(groups_params, x, positions, cfg, group_cfgs, *, memory=None,
                want_cache=False, cache_len=0):
    """Apply all layer groups; optionally collect decode caches.

    Under autograd with ``cfg.remat``, ``remat_mode`` picks what is
    recomputed in the backward, as in the reference: "block" each block,
    "pattern" each repeat of the pattern, "double" both, nested.
    """
    remat = cfg.remat and torch.is_grad_enabled()
    per_block = remat and cfg.remat_mode in ("block", "double")
    outer = remat and cfg.remat_mode in ("pattern", "double")
    caches = []
    for gp, (pattern, repeat) in zip(groups_params, group_cfgs):

        def body(h, p_rep, pattern=pattern):
            new_caches = []
            for i, blk in enumerate(pattern):

                def one(p_i, h_i, blk=blk):
                    return B.block_seq(
                        p_i, h_i, positions, cfg, blk,
                        memory=memory, want_cache=want_cache, cache_len=cache_len,
                    )

                h, c = (_checkpointed(one) if per_block else one)(p_rep[i], h)
                new_caches.append(c)
            return h, new_caches

        body_fn = _checkpointed(body) if outer else body
        per_pos = [[] for _ in pattern]
        for p_rep in zip(*(_unstack(gp[i], repeat) for i in range(len(pattern)))):
            x, c = body_fn(x, p_rep)
            for i in range(len(pattern)):
                per_pos[i].append(c[i])
        caches.append(tuple(_stack(c) for c in per_pos) if want_cache else None)
    return x, caches


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x)
    else:
        logits = L.dense(params["unembed"], x, torch.float32)
    return L.softcap(logits, cfg.logit_softcap)


def _embed_tokens(params, cfg, tokens):
    x = L.embed(params["embed"], tokens, _adt(cfg))
    # the reference scales by sqrt(d_model) rounded to the activation dtype
    return x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype))


def _positions(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def _encode(params, cfg, frames):
    """Encoder stack (seamless): frames (B, Sa, enc_input_dim) -> memory."""
    x = L.dense(params["enc_proj"], frames.to(_adt(cfg)))
    x, _ = _run_groups(
        params["enc_groups"], x, _positions(x.shape[1], x.device), cfg, cfg.encoder_groups
    )
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _memory(params, cfg, batch):
    if cfg.encoder_groups is not None:
        return _encode(params, cfg, batch["frames"])
    if cfg.vision_tokens:
        return L.dense(params["vision_proj"], batch["patches"].to(_adt(cfg)))
    return None


def _backbone(params, batch, cfg):
    tokens = batch["tokens"]
    memory = _memory(params, cfg, batch)
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(tokens.shape[1], tokens.device)
    x, _ = _run_groups(params["groups"], x, positions, cfg, cfg.groups, memory=memory)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """batch: {"tokens": (B,S) int, "labels": (B,S) int, [frames|patches]}.

    Returns (mean CE loss, logits fp32).  Materializes logits -- use
    ``forward_loss`` for the streaming CE, which does not.
    """
    x = _backbone(params, batch, cfg)
    logits = _logits(params, cfg, x)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    # a negative label indexes from the end, as numpy / jnp indexing does;
    # the mask zeroes it
    idx = torch.where(labels >= 0, labels, labels + logits.shape[-1])
    ll = L.reduce_partial(torch.gather(logp, -1, idx[..., None]))[..., 0]
    mask = (labels >= 0).float()
    loss = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, logits


def forward_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Loss via the streaming (vocab-chunked) cross-entropy: the (B, S,
    vocab) logits are never materialized."""
    x = _backbone(params, batch, cfg)
    if cfg.ce_chunk <= 0:
        loss, _ = forward_train(params, batch, cfg)
        return loss
    if cfg.tie_embeddings:
        return L.blocked_cross_entropy(
            x, batch["labels"], table=params["embed"]["table"],
            chunk=cfg.ce_chunk, logit_softcap=cfg.logit_softcap,
        )
    return L.blocked_cross_entropy(
        x, batch["labels"], w=params["unembed"]["w"],
        bias=params["unembed"].get("b"),
        chunk=cfg.ce_chunk, logit_softcap=cfg.logit_softcap,
    )


def prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """Run the context and build decode caches.

    Returns (last-position logits (B, vocab), caches, memory).
    """
    tokens = batch["tokens"]
    memory = _memory(params, cfg, batch)
    x = _embed_tokens(params, cfg, tokens)
    x, caches = _run_groups(
        params["groups"], x, _positions(tokens.shape[1], tokens.device), cfg, cfg.groups,
        memory=memory, want_cache=True, cache_len=cache_len,
    )
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x[:, -1])
    return logits, caches, memory


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Empty caches matching prefill's structure."""
    dev = resolve_device(device)
    caches = []
    for pattern, repeat in cfg.groups:
        caches.append(tuple(
            _stack([B.block_init_cache(cfg, blk, batch, cache_len, _adt(cfg), device=dev)] * repeat)
            for blk in pattern
        ))
    return caches


def decode_step(params, caches, token, pos, cfg: ModelConfig, *, memory=None):
    """token: (B,) int; pos: int. Returns (logits, caches).

    The reference returns new caches; the port writes each layer's cache in
    place (slot ``pos`` of an attention or MLA cache, the whole of a
    recurrent state) through the views ``a[r]`` of the stacked caches and
    returns ``caches`` itself, so a caller that needs the caches as they
    were must clone them first.
    """
    x = _embed_tokens(params, cfg, token[:, None])
    for gp, gc, (pattern, repeat) in zip(params["groups"], caches, cfg.groups):
        for r in range(repeat):
            for i, blk in enumerate(pattern):
                x, _ = B.block_step(   # the cache view, written in place
                    tree_map(lambda a: a[r], gp[i]), x, tree_map(lambda a: a[r], gc[i]),
                    pos, cfg, blk, memory=memory,
                )
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, x[:, 0])
    return logits, caches


# ------------------------------------------------------------- counting ----


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count, from the tree on ``meta``.  ``active_only``
    subtracts, for MoE configs, the experts a token does not route to."""
    total = sum(x.numel() for x in tree_leaves(abstract_params(cfg)))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        moe_layers = sum(sum(1 for b in pattern if b.moe) * repeat for pattern, repeat in cfg.groups)
        per_expert = 3 * cfg.d_model * m.expert_ff
        total -= (m.num_experts - m.top_k) * per_expert * moe_layers
    return total
