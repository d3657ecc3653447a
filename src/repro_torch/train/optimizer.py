"""AdamW with global-norm clipping and configurable state dtype, PyTorch
port of ``repro.train.optimizer``.

State dtype bf16 for the >=236B configs (arctic, deepseek) so optimizer
state fits device memory (DESIGN.md #4); the update math always runs in
fp32 (m / v are upcast per leaf), so bf16 state costs precision only in the
rounding of the stored moments.

The reference's update is functional: it returns new params and state.
Here ``adamw_update`` writes the params, m, v and step in place under
``torch.no_grad()``, one leaf at a time with two leaf-sized fp32
temporaries, and returns the same trees: at full width a second copy of
params and state would not fit (recurrentgemma-2b's fp32 params, grads, m
and v are 46.3 GB).  DTensor leaves (a sharded step) are updated shard by
shard on each rank's local tensors, the gradient first placed as its
param is; ``global_norm`` sums the shards' squares across the mesh.  ``step`` and ``lr`` stay 0-d tensors on the params'
device, so a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.model import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptHParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(hp: OptHParams, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in fp32 (``step``: an int tensor)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(hp.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return hp.lr * warm * cos


def adamw_init(params, state_dtype: str = "float32"):
    """Zero moments in ``state_dtype`` beside each leaf, and step 0 (int32)."""
    dt = getattr(torch, state_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)   # a DTensor leaf's moments placed as it is

    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (a
    DTensor leaf's summed over its shards, whole on every rank)."""
    leaves = [_whole(torch.sum(torch.square(x.to(torch.float32)))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _update_leaf(p, g, m, v, scale, lr, b1c, b2c, hp: OptHParams):
    """The reference's ``upd`` on one leaf, written into p, m and v.  Each
    product and sum rounds as the reference's fp32 expression does; t1 and
    t2 are the only leaf-sized fp32 temporaries (with a bf16 p, m or v, its
    fp32 copy too)."""
    f32 = torch.float32
    placements = getattr(p, "placements", None)
    if placements is not None:
        if g.placements != placements:
            # a DTensor gradient placed otherwise (partial sums, another
            # shard): the update needs it where p is (the gradient reduction)
            g = g.redistribute(p.device_mesh, placements)
        # the update is elementwise: each rank writes its own shards of p, m
        # and v in place, and the 0-d factors are whole on every rank
        p, g, m, v = (t.to_local() for t in (p, g, m, v))
        scale, lr, b1c, b2c = (_whole(t) for t in (scale, lr, b1c, b2c))
    t1 = g.to(f32) * scale                                 # g32
    t2 = torch.mul(t1, 1 - hp.b1)
    m32 = m.to(f32).mul_(hp.b1).add_(t2)                   # b1 m + (1 - b1) g32
    torch.mul(t1, 1 - hp.b2, out=t2).mul_(t1)
    v32 = v.to(f32).mul_(hp.b2).add_(t2)                   # b2 v + (1 - b2) g32 g32
    torch.div(v32, b2c, out=t1).sqrt_().add_(hp.eps)       # sqrt(v32 / b2c) + eps
    torch.div(m32, b1c, out=t2).div_(t1)                   # update
    p32 = p.to(f32)
    torch.mul(p32, hp.weight_decay, out=t1)
    t2.add_(t1).mul_(lr)                                   # lr (update + wd p32)
    p32.sub_(t2)
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:                                 # a bf16 leaf: its fp32 copy, rounded back
            dst.copy_(src)


@torch.no_grad()
def adamw_update(params, grads, state, hp: OptHParams) -> Tuple[Any, dict, dict]:
    """One clipped AdamW step: ``params`` and ``state`` (m, v, step) are
    written in place and returned; metrics ``grad_norm`` and ``lr`` are 0-d
    fp32 tensors on the params' device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(hp.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"].add_(1)
    lr = schedule(hp, step)
    s = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(hp.b1, dtype=torch.float32, device=s.device), s)
    b2c = 1.0 - torch.pow(torch.tensor(hp.b2, dtype=torch.float32, device=s.device), s)
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
    for p, g, m, v in leaves:
        _update_leaf(p, g, m, v, scale, lr, b1c, b2c, hp)
    return params, state, {"grad_norm": gnorm, "lr": lr}
