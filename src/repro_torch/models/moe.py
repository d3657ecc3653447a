"""Mixture-of-Experts FFN with sort-based, static-capacity routing, PyTorch
port of ``repro.models.moe``.

Routing is the sorted-scatter formulation (tokens sorted by assigned expert,
positions beyond the static capacity dropped) rather than the dense
(N, E, C) one-hot dispatch.  Tokens route within ``routing_groups`` groups,
as in the reference (which ``vmap``s over them); here the groups are a
leading batch axis of every op.

The reference's choices that decide which tokens run, kept exactly:
``top_k`` breaks ties toward the lower expert (a stable descending sort),
the expert sort is stable, ``searchsorted`` is left-sided, and the
overflow row ``e * cap`` takes every dropped write and is discarded.  Each
token's k contributions are added one by one in the reference's order
(ascending expert, the order of its scatter-add over the sorted
assignments), so the bf16 sum rounds the same way on the CPU and the card
and one run repeats the next (no ``index_add_`` atomics).  The expert
products run over slices of experts, so the fp32 copies of the weights
stay bounded at full width.

Supports deepseek-v2 (shared experts + top-6 of 160 routed) and arctic
(dense residual MLP in parallel with top-2 of 128).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

EXPERT_SLICE = 1 << 28   # weight elements (of one of wg / wi / wo) upcast to fp32 at once


def moe_init(init: L.Init, cfg, dtype):
    m = cfg.moe
    d = cfg.d_model
    std = 1.0 / np.sqrt(d)
    p = {
        # the router stays fp32 whatever param_dtype is
        "router": {"w": init.normal((d, m.num_experts), std, torch.float32)},
        "wg": init.normal((m.num_experts, d, m.expert_ff), std, dtype),
        "wi": init.normal((m.num_experts, d, m.expert_ff), std, dtype),
        "wo": init.normal((m.num_experts, m.expert_ff, d), 1.0 / np.sqrt(m.expert_ff), dtype),
    }
    if m.num_shared:
        p["shared"] = L.swiglu_init(init, d, m.expert_ff * m.num_shared, dtype)
    if m.dense_residual_ff:
        p["dense"] = L.swiglu_init(init, d, m.dense_residual_ff, dtype)
    return p


def capacity(num_tokens: int, m) -> int:
    c = int(np.ceil(m.top_k * num_tokens / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def num_groups(n: int, m) -> int:
    """The routing groups of ``n`` tokens: ``routing_groups``, halved until
    it divides ``n``."""
    groups = max(1, min(m.routing_groups, n))
    while n % groups:
        groups //= 2
    return groups


def route(xg, router_w, m, cap):
    """The assignments of token groups xg (G, n, D), sorted by expert:
    token ``st``, gate ``sg``, buffer slot ``slot`` (``e * cap`` when
    dropped) and ``keep``, each (G, n*k); and ``inv``, the sorted position
    of each (token, rank) assignment."""
    g, n, _ = xg.shape
    e, k = m.num_experts, m.top_k
    logits = torch.matmul(xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the k largest, ties toward the lower index
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]            # (G, n, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    dev = xg.device
    flat_e = eidx.reshape(g, n * k)
    flat_t = torch.arange(n * k, device=dev) // k
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sg = torch.gather(gate.reshape(g, n * k), 1, order)
    starts = torch.searchsorted(se, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(n * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))   # overflow -> pad row
    inv = torch.argsort(order, dim=-1)
    return st, sg, slot, keep, inv


def _experts_on_shards(h, p, dtype):
    """``_experts`` on DTensors, run on each rank's shards: a mesh dim that
    shards the experts (expert parallelism) gives each rank its experts'
    buffers and weights; one that shards the token groups, or a data-parallel
    one ("pod", "data") that the groups divide, gives each rank its groups
    and the weights whole (an FSDP shard gathered, its gradient then a
    partial sum); anything else is replicated.  DTensor's own einsum
    over such shards views a non-contiguous local shard and fails."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = {k: p[k] for k in ("wg", "wi", "wo")}
    mesh = next(t.device_mesh for t in (h, *w.values()) if isinstance(t, DTensor))
    if not isinstance(h, DTensor):
        h = DTensor.from_local(h, mesh, [Replicate()] * mesh.ndim, run_check=False)
    e, g = p["wg"].shape[0], h.shape[0]
    names = mesh.mesh_dim_names or ()
    h_pl, w_pl, wg_pl = [], [], []
    e_split = g_split = 1
    for i in range(mesh.ndim):
        n = mesh.size(i)
        if n > 1 and any(getattr(t, "placements", (None,) * mesh.ndim)[i] == Shard(0) for t in w.values()) \
                and e % (e_split * n) == 0:
            e_split *= n
            h_pl.append(Shard(1)), w_pl.append(Shard(0)), wg_pl.append(Shard(0))
        elif n > 1 and (h.placements[i].is_shard(0) or names[i] in ("pod", "data")) \
                and g % (g_split * n) == 0:
            g_split *= n
            h_pl.append(Shard(0)), w_pl.append(Replicate()), wg_pl.append(Partial())
        else:
            h_pl.append(Replicate()), w_pl.append(Replicate()), wg_pl.append(Replicate())

    def local_w(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, w_pl).to_local(grad_placements=wg_pl)

    y = _experts(h.redistribute(mesh, h_pl).to_local(), {k: local_w(t) for k, t in w.items()}, dtype)
    return DTensor.from_local(y, mesh, h_pl, run_check=False)


def _experts(h, p, dtype):
    """The swiglu of each expert on its buffer h (G, E, cap, D), over slices
    of experts."""
    if any(hasattr(t, "placements") for t in (h, p["wg"], p["wi"], p["wo"])):
        return _experts_on_shards(h, p, dtype)
    e, d, f = p["wg"].shape
    step = max(1, EXPERT_SLICE // (d * f))
    y = h.new_empty(h.shape, dtype=dtype)
    for lo in range(0, e, step):
        es = slice(lo, lo + step)
        hs = h[:, es].float()
        g_ = torch.einsum("gecd,edf->gecf", hs, p["wg"][es].float())
        u_ = torch.einsum("gecd,edf->gecf", hs, p["wi"][es].float())
        a = (F.silu(g_) * u_).to(dtype)
        y[:, es] = torch.einsum("gecf,efd->gecd", a.float(), p["wo"][es].float()).to(dtype)
    return y


def _route_groups(xg, p, m, cap):
    """Route token groups xg (G, n, D) -> (G, n, D).  Sort-based, capacity-dropped."""
    if hasattr(xg, "placements"):
        return _route_groups_on_shards(xg, p, m, cap)
    return _route_local(xg, p["router"]["w"], lambda h: _experts(h, p, xg.dtype), m, cap)


def _route_groups_on_shards(xg, p, m, cap):
    """``_route_groups`` on a DTensor xg: each rank routes its own token
    groups (those of its data shards; replicated over the other mesh dims)
    as plain tensors, so the sort, the scatter into the expert buffers and
    the combine stay local, as the reference's grouping intends (and
    ``index_put_`` has no DTensor strategy in every torch the port runs
    on).  Only the experts run as DTensors (``_experts_on_shards``), their
    outputs gathered back whole for the combine.  The router's gradient is
    a partial sum over the group shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xg.device_mesh
    names = mesh.mesh_dim_names or ()
    rows, split = [], 1
    for i in range(mesh.ndim):
        n = mesh.size(i)
        dp = xg.placements[i].is_shard(0) or names[i] in ("pod", "data")
        if n > 1 and dp and xg.shape[0] % (split * n) == 0:
            split *= n
            rows.append(Shard(0))
        else:
            rows.append(Replicate())
    router = p["router"]["w"]
    if not isinstance(router, DTensor):
        router = DTensor.from_local(router, mesh, [Replicate()] * mesh.ndim, run_check=False)
    router = router.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if pl.is_shard(0) else pl for pl in rows])

    def experts(h):
        y = _experts(DTensor.from_local(h, mesh, rows, run_check=False), p, xg.dtype)
        return y.redistribute(mesh, rows).to_local()

    out = _route_local(xg.redistribute(mesh, rows).to_local(), router, experts, m, cap)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _route_local(xg, router_w, experts, m, cap):
    """The routing of token groups xg (G, n, D) by ``router_w``, with
    ``experts(buffers (G, E, cap, D))`` the expert products."""
    g, n, d = xg.shape
    e, k = m.num_experts, m.top_k
    st, sg, slot, keep, inv = route(xg, router_w, m, cap)
    gi = torch.arange(g, device=xg.device)[:, None]

    buf = xg.new_zeros((g, e * cap + 1, d))
    buf[gi, slot] = xg[gi, st]                           # the pad row takes every dropped write
    y = experts(buf[:, : e * cap].reshape(g, e, cap, d))

    yf = torch.cat([y.reshape(g, e * cap, d), y.new_zeros((g, 1, d))], dim=1)
    contrib = yf[gi, slot] * (sg * keep.float()).to(xg.dtype)[..., None]
    # each token's k contributions in sorted order (ascending expert), added one by one
    tok_inv = inv.reshape(g, n, k)
    tok_pos, _ = torch.sort(tok_inv, dim=-1)
    out = torch.zeros((g, n, d), dtype=xg.dtype, device=xg.device)
    for j in range(k):
        out = out + contrib[gi, tok_pos[:, :, j]]
    return out


def moe_apply(p, x, cfg):
    """Grouped routing: tokens route within ``routing_groups`` groups, as in
    the reference (there, so that the sort stays local to a data shard)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    groups = num_groups(n, m)
    ng = n // groups
    # the gradient comes back placed as the output is: DTensor cannot view a
    # gradient that arrives sharded otherwise back into the token groups
    out = L.grad_placed(_route_groups(x.reshape(groups, ng, d), p, m, capacity(ng, m)).reshape(b, s, d))
    if "shared" in p:
        out = out + L.swiglu(p["shared"], x)
    if "dense" in p:
        out = out + L.swiglu(p["dense"], x)
    return out


def dropped_assignments(p, x, cfg) -> int:
    """How many of ``moe_apply(p, x, cfg)``'s token-expert assignments fall
    past their expert's capacity (one host sync)."""
    m = cfg.moe
    b, s, d = x.shape
    groups = num_groups(b * s, m)
    ng = b * s // groups
    keep = route(x.reshape(groups, ng, d), p["router"]["w"], m, capacity(ng, m))[3]
    return int((~keep).sum())


def aux_load_balance_loss(logits, eidx, num_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (optional, returned by train)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    one_hot = F.one_hot(eidx[:, 0].long(), num_experts).float()
    ce = one_hot.mean(dim=0)
    return num_experts * torch.sum(me * ce)
