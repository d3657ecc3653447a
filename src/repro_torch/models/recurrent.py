"""Recurrent sequence mixers: RG-LRU (RecurrentGemma/Griffin) and xLSTM
cells, PyTorch port of ``repro.models.recurrent``.

All three expose a *sequence* form (train/prefill) and a *step* form
(decode; O(1) state) sharing the same state dict.  The step forms return
a new state, as the reference's do; ``blocks.block_step`` copies it into
the cache it was given.

  * RG-LRU: diagonal gated linear recurrence; the sequence form is a
    log-depth doubling scan in torch ops (the reference's
    ``jax.lax.associative_scan``; the products round in another order).
  * mLSTM: matrix-memory LSTM; sequence form is chunkwise-parallel with
    running-max stabilization of the exponential gates, a Python loop over
    the chunks (the reference's ``lax.scan``).
  * sLSTM: scalar-memory LSTM with per-head recurrent weights; inherently
    sequential, a Python loop over time.

The ``-1e30`` sentinels (padding, the initial ``m``) are the reference's:
``-inf`` would give ``-inf - (-inf) = nan``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models import layers as L

NEG = -1e30

# ======================================================= RG-LRU (Griffin) ==


def rglru_init(init: L.Init, d_rnn: int, dtype):
    return {
        "wa": L.dense_init(init, d_rnn, d_rnn, dtype),
        "wx": L.dense_init(init, d_rnn, d_rnn, dtype),
        # lambda init so decay a = exp(-8 softplus(lam) r) ~ 0.9..0.99
        "lam": init.uniform((d_rnn,), -4.6, -3.0, torch.float32),
    }


def _rglru_gates(p, x):
    r = torch.sigmoid(L.dense(p["wa"], x, torch.float32))
    i = torch.sigmoid(L.dense(p["wx"], x, torch.float32))
    log_a = -8.0 * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * x.float())
    return a, b


def _shift(t, o, fill):
    """``t`` moved ``o`` steps later along axis 1, the first ``o`` rows ``fill``."""
    return torch.cat([t.new_full((t.shape[0], o) + t.shape[2:], fill), t[:, :-o]], dim=1)


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1
    by doubling: at offsets 1, 2, 4, ... b <- b + a shift(b) and
    a <- a shift(a).  Returns (prod of a up to t, h_t)."""
    o = 1
    while o < a.shape[1]:
        b = b + a * _shift(b, o, 0.0)
        a = a * _shift(a, o, 1.0)
        o *= 2
    return a, b


def rglru_seq(p, x, h0=None):
    """x: (B, S, d_rnn) -> (y (B,S,d_rnn), h_last (B,d_rnn)).  h_t = a h + b."""
    a, b = _rglru_gates(p, x)
    a_s, h = linear_scan(a, b)
    if h0 is not None:
        h = h + a_s * h0[:, None, :].float()
    return h.to(x.dtype), h[:, -1].float()


def rglru_step(p, x1, h):
    """x1: (B, 1, d_rnn), h: (B, d_rnn) -> (y (B,1,d), h_new)."""
    a, b = _rglru_gates(p, x1)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x1.dtype)[:, None, :], h_new


def conv1d_init(init: L.Init, width: int, d: int, dtype):
    return {
        "w": init.normal((width, d), 1.0 / np.sqrt(width), dtype),
        "b": init.zeros((d,), dtype),
    }


def conv1d_seq(p, x):
    """Causal depthwise conv, width w. x: (B, S, d)."""
    w = p["w"].shape[0]
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w):
        # x moved i steps later, zeros first (a concatenation: DTensor's pad
        # then slice gives the wrong length under torch 2.11)
        k = min(i, s)
        shifted = torch.cat([x.new_zeros((x.shape[0], k) + tuple(x.shape[2:])), x[:, :s - k]], dim=1)
        out = out + shifted.float() * p["w"][w - 1 - i].float()
    return (out + p["b"].float()).to(x.dtype)


def conv1d_step(p, x1, hist):
    """x1: (B,1,d); hist: (B, w-1, d) previous inputs -> (y, new_hist)."""
    seq = torch.cat([hist, x1.to(hist.dtype)], dim=1)  # (B, w, d)
    y = torch.einsum("bwd,wd->bd", seq.float(), p["w"].float()) + p["b"].float()
    return y.to(x1.dtype)[:, None], seq[:, 1:]


def recurrent_block_init(init: L.Init, d_model: int, d_rnn: int, conv_width: int, dtype):
    return {
        "win1": L.dense_init(init, d_model, d_rnn, dtype),
        "win2": L.dense_init(init, d_model, d_rnn, dtype),
        "conv": conv1d_init(init, conv_width, d_rnn, dtype),
        "rglru": rglru_init(init, d_rnn, dtype),
        "wout": L.dense_init(init, d_rnn, d_model, dtype),
    }


def _gelu_gate(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(L.dense(p["win2"], x, torch.float32), approximate="tanh").to(x.dtype)


def recurrent_block_seq(p, x, state=None):
    """Griffin recurrent block, sequence form. x: (B,S,D).  The conv history
    kept is ``b1[:, -(w-1):]``, as in the reference: shorter than w - 1 rows
    when S < w - 1."""
    b1 = L.dense(p["win1"], x)
    gate = _gelu_gate(p, x)
    c = conv1d_seq(p["conv"], b1)
    h0 = state["h"] if state is not None else None
    y, h_last = rglru_seq(p["rglru"], c, h0)
    out = L.dense(p["wout"], y * gate)
    new_state = {
        "h": h_last,
        "conv": b1[:, -(p["conv"]["w"].shape[0] - 1):].to(x.dtype),
    }
    return out, new_state


def recurrent_block_step(p, x1, state):
    b1 = L.dense(p["win1"], x1)
    gate = _gelu_gate(p, x1)
    c, conv_hist = conv1d_step(p["conv"], b1, state["conv"])
    y, h = rglru_step(p["rglru"], c, state["h"])
    out = L.dense(p["wout"], y * gate)
    return out, {"h": h, "conv": conv_hist}


def recurrent_block_init_state(batch: int, d_rnn: int, conv_width: int, dtype, device="cuda"):
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype, device=device),
    }


# ================================================================ mLSTM ====


def mlstm_init(init: L.Init, d_model: int, num_heads: int, d_inner: int, dtype):
    return {
        "wq": L.dense_init(init, d_model, d_inner, dtype),
        "wk": L.dense_init(init, d_model, d_inner, dtype),
        "wv": L.dense_init(init, d_model, d_inner, dtype),
        "wi": L.dense_init(init, d_model, num_heads, dtype, bias=True),
        "wf": L.dense_init(init, d_model, num_heads, dtype, bias=True),
        "wog": L.dense_init(init, d_model, d_inner, dtype),
        "norm": L.rmsnorm_init(init, d_inner, dtype),
        "wout": L.dense_init(init, d_inner, d_model, dtype),
    }


def _mlstm_qkv(p, x, num_heads):
    b, s, _ = x.shape
    dh = p["wq"]["w"].shape[1] // num_heads

    def heads(name, inner=False):
        return L.split_last(L.dense(p[name], x, torch.float32), num_heads, dh, inner=inner).transpose(1, 2)

    # where the mesh does not divide the heads, v keeps its shards on the
    # value dim, and with it the state C and the products over it
    q, k, v = heads("wq"), heads("wk"), heads("wv", inner=True)
    li = L.dense(p["wi"], x, torch.float32).transpose(1, 2)            # (B,H,S) log input gate
    lf = F.logsigmoid(L.dense(p["wf"], x, torch.float32)).transpose(1, 2)
    return q, k / float(np.sqrt(dh)), v, li, lf


def _mlstm_out(p, x, h):
    og = torch.sigmoid(L.dense(p["wog"], x, torch.float32))
    y = L.rmsnorm(p["norm"], (h * og).to(x.dtype))
    return L.dense(p["wout"], y)


def mlstm_seq(p, x, num_heads: int, state=None, chunk: int = 128):
    """Chunkwise-parallel mLSTM. x: (B,S,D) -> (y, state).

    State: C (B,H,dk,dv), n (B,H,dk), m (B,H) with C, n stored descaled by
    exp(m) (running-max stabilization of the exponential gates).
    """
    b, s, _ = x.shape
    q, k, v, li, lf = _mlstm_qkv(p, x, num_heads)
    dh = q.shape[-1]
    t = min(chunk, s)
    pad = (-s) % t
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, pad), value=NEG)
        lf = F.pad(lf, (0, pad))
    nc = (s + pad) // t

    if state is None:
        state = mlstm_init_state(b, num_heads, dh, device=x.device)
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]

    tri = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    hs = []
    for ci in range(nc):
        sl = slice(ci * t, (ci + 1) * t)
        qc, kc, vc, lic, lfc = q[:, :, sl], k[:, :, sl], v[:, :, sl], li[:, :, sl], lf[:, :, sl]
        # L_t; the dim counted from the front: DTensor's scan strategy does
        # not normalize a negative dim, and scans a time-sharded dim per shard
        lcum = torch.cumsum(lfc, dim=lfc.ndim - 1)
        ltot = lcum[..., -1:]                           # L_T
        # intra-chunk log weights D_ts = L_t - L_s + i_s (s <= t)
        dmat = lcum[..., :, None] - lcum[..., None, :] + lic[..., None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, NEG))
        m_intra = dmat.amax(dim=-1)                     # (B,H,t)
        m_comb = torch.maximum(m_intra, m_prev[..., None] + lcum)
        sc = torch.einsum("bhtd,bhsd->bhts", qc, kc) * torch.exp(dmat - m_comb[..., None])
        inter_scale = torch.exp(m_prev[..., None] + lcum - m_comb)   # (B,H,t)
        num = torch.einsum("bhts,bhsd->bhtd", sc, vc) + torch.einsum(
            "bhtd,bhdv->bhtv", qc, c_prev
        ) * inter_scale[..., None]
        # q.n_t = sum_s (q.k_s) exp(D_ts - m) = row-sum of sc (k is pre-scaled)
        den = torch.abs(sc.sum(dim=-1) + torch.einsum("bhtd,bhd->bht", qc, n_prev) * inter_scale)
        hs.append(num / torch.maximum(den, torch.exp(-m_comb))[..., None])
        # state to chunk end
        a_log = ltot - lcum + lic                       # decay t..T + input gate
        m_new = torch.maximum(m_prev + ltot[..., 0], a_log.amax(dim=-1))
        w = torch.exp(a_log - m_new[..., None])         # (B,H,t)
        decay = torch.exp(m_prev + ltot[..., 0] - m_new)
        c_prev = c_prev * decay[..., None, None] + torch.einsum("bht,bhtd,bhtv->bhdv", w, kc, vc)
        n_prev = n_prev * decay[..., None] + torch.einsum("bht,bhtd->bhd", w, kc)
        m_prev = m_new
    h = torch.cat(hs, dim=2)[:, :, :s]                   # (B,H,S,dh)
    h = L.merge_last(h.transpose(1, 2), 2)
    return _mlstm_out(p, x, h), {"C": c_prev, "n": n_prev, "m": m_prev}


def mlstm_step(p, x1, state, num_heads: int):
    """One-token mLSTM. x1: (B,1,D)."""
    q, k, v, li, lf = _mlstm_qkv(p, x1, num_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]        # (B,H,dh)
    li, lf = li[:, :, 0], lf[:, :, 0]                   # (B,H)
    c, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fs = torch.exp(lf + m - m_new)
    is_ = torch.exp(li - m_new)
    c_new = c * fs[..., None, None] + is_[..., None, None] * torch.einsum("bhd,bhv->bhdv", k, v)
    n_new = n * fs[..., None] + is_[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)), torch.exp(-m_new))
    h = L.merge_last(num / den[..., None], 2)[:, None]
    return _mlstm_out(p, x1, h), {"C": c_new, "n": n_new, "m": m_new}


def mlstm_init_state(batch: int, num_heads: int, dh: int, device="cuda"):
    return {
        "C": torch.zeros((batch, num_heads, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, num_heads, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, num_heads), NEG, dtype=torch.float32, device=device),
    }


# ================================================================ sLSTM ====


def slstm_init(init: L.Init, d_model: int, num_heads: int, dtype):
    dh = d_model // num_heads
    return {
        "wzifo": L.dense_init(init, d_model, 4 * d_model, dtype, bias=True),
        # per-head recurrent weights for z,i,f,o: (4, H, dh, dh)
        "r": init.normal((4, num_heads, dh, dh), 1.0 / np.sqrt(dh), dtype),
        "norm": L.rmsnorm_init(init, d_model, dtype),
        "wout": L.dense_init(init, d_model, d_model, dtype),
    }


def _slstm_update(zt, it, ft, ot, c, n, m):
    """One sLSTM time step from the z, i, f, o pre-activations (any layout
    the state shares): (c, n, m, h) after it."""
    z = torch.tanh(zt)
    lf = F.logsigmoid(ft)                                # log forget gate; it is the log input gate
    o = torch.sigmoid(ot)
    lfm = lf + m
    m_new = torch.maximum(lfm, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(lfm - m_new)
    c = f_ * c + i_ * z
    n = f_ * n + i_
    return c, n, m_new, o * (c / torch.clamp_min(n, 1e-6))


def slstm_seq(p, x, num_heads: int, state=None):
    """Sequential sLSTM, a loop over time. x: (B,S,D).  DTensor inputs run
    the loop on local shards (``_slstm_local``)."""
    b, s, d = x.shape
    dh = d // num_heads
    pre = L.dense(p["wzifo"], x, torch.float32)          # (B,S,4D)
    if getattr(pre, "placements", None) is not None:
        y, state = _slstm_local(pre, p["r"], state, num_heads, dh)
    else:
        pre = pre.reshape(b, s, 4, num_heads, dh).permute(1, 0, 2, 3, 4)   # (S,B,4,H,dh)
        r = p["r"].float()
        if state is None:
            state = slstm_init_state(b, num_heads, dh, device=x.device)
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]   # (B,H,dh) each
        ys = []
        for xt in pre:
            rec = torch.einsum("bhd,ghde->gbhe", h, r)       # (4,B,H,dh)
            gates = xt + rec.transpose(0, 1)                 # (B,4,H,dh): z, i, f, o pre-activations
            c, n, m, h = _slstm_update(gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3], c, n, m)
            ys.append(h)
        y = torch.stack(ys, dim=1)
        state = {"c": c, "n": n, "m": m, "h": h}
    y = L.merge_last(y, 2).to(x.dtype)
    y = L.rmsnorm(p["norm"], y)
    return L.dense(p["wout"], y), state


def _slstm_local(pre, r, state, num_heads, dh):
    """The sLSTM's time loop on each rank's local tensors, for the DTensor
    pre-activations ``pre`` (B, S, 4D): DTensor would otherwise propagate
    the sharding of every op of every step.  The batch keeps its shards.
    Where one mesh dim shards the (gate, head) pairs of ``pre``'s last dim
    evenly (the "model" dim: 16 pairs of 4 gates x 4 heads, one per rank),
    each rank takes its pairs' recurrent products (its slice of ``r``,
    which the rules hold whole) and the pre-activations of all pairs are
    gathered once per step, a collective that ``opcount`` charges; the
    state update then runs whole on every rank.  Elsewhere ``pre`` is
    gathered once and every rank runs the whole loop.  On fake tensors one
    step stands for all (``_FakeSteps``; the counter's peak then holds one
    step's h where the loop keeps S).
    Returns (y (B, S, H, dh), state), DTensors with the batch's shards,
    whole on every other mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = pre.device_mesh
    b, s, _ = pre.shape
    pairs = 4 * num_heads
    split = [i for i, pl in enumerate(pre.placements) if pl.is_shard(2)]
    gi = split[0] if len(split) == 1 and pairs % mesh.size(split[0]) == 0 else None
    rows = [Shard(0) if pl.is_shard(0) else Replicate() for pl in pre.placements]
    want = [Shard(2) if i == gi else pl for i, pl in enumerate(rows)]
    pre_l = pre.redistribute(mesh, want).to_local()                  # (b, S, P * dh)
    npair = pairs // (mesh.size(gi) if gi is not None else 1)
    k0 = npair * (mesh.get_local_rank(gi) if gi is not None else 0)
    bl = pre_l.shape[0]
    pre_l = pre_l.reshape(bl, s, npair, dh).permute(1, 2, 0, 3)     # (S, P, b, dh)
    # r's gradient: each rank's pairs (and batch shard) only, summed across ranks
    r_grad = [Partial() if (i == gi or pl.is_shard(0)) else Replicate() for i, pl in enumerate(rows)]
    r_l = r.float().redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=r_grad)
    r_l = r_l.reshape(pairs, dh, dh)[k0:k0 + npair]                  # (P, dh, dh)
    if state is None:
        c, n, h = (torch.zeros((num_heads, bl, dh), dtype=torch.float32, device=pre_l.device) for _ in range(3))
        m = torch.full((num_heads, bl, dh), NEG, dtype=torch.float32, device=pre_l.device)
    else:
        c, n, m, h = (state[k].redistribute(mesh, rows).to_local().permute(1, 0, 2) for k in ("c", "n", "m", "h"))
    heads = torch.arange(k0, k0 + npair, device=pre_l.device) % num_heads

    def step(xt, r_l, c, n, m, h):
        # h is alike on every rank; its gradient through this rank's pairs is a part of the whole
        hp = _SumGrad.apply(h, mesh, gi) if gi is not None and torch.is_grad_enabled() else h
        gates = torch.baddbmm(xt, hp.index_select(0, heads), r_l)   # (P, b, dh): this rank's pairs
        if gi is not None:
            gates = _GatherPairs.apply(gates, mesh, gi)               # (4H, b, dh)
        zt, it, ft, ot = gates.view(4, num_heads, bl, dh).unbind(0)
        return _slstm_update(zt, it, ft, ot, c, n, m)

    ys = []
    for t, xt in enumerate(pre_l):
        if t == 1 and is_fake(pre_l):
            # shapes only (the dry-run): every step after the first (whose state
            # takes no gradient) is the same ops on the same shapes
            c, n, m, h = _FakeSteps.apply(s - 1, step, xt, r_l, c, n, m, h)
            ys += [h] * (s - 1)
            break
        c, n, m, h = step(xt, r_l, c, n, m, h)
        ys.append(h)

    def placed(t):
        return L._FromLocal.apply(t, mesh, rows, rows)

    y = placed(torch.stack(ys, dim=0).permute(2, 0, 1, 3))           # (B, S, H, dh)
    return y, {k: placed(v.permute(1, 0, 2)) for k, v in (("c", c), ("n", n), ("m", m), ("h", h))}


class _FakeSteps(torch.autograd.Function):
    """``n`` steps of ``step`` on fake tensors, which carry shapes only, run
    as one: each entered counter (``opcount.repeated``) charges the step
    ``n`` times, and its backward ``n`` times too.  Its outputs are the one
    step's."""

    @staticmethod
    def forward(ctx, n, step, *ins):
        from repro_torch.roofline.opcount import repeated

        leaves = [t.detach().requires_grad_(t.requires_grad) for t in ins]
        # the step's own graph, kept whole for the backward (a remat region's hooks stay out of it)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t), repeated(n):
            outs = step(*leaves)
        ctx.n, ctx.leaves, ctx.outs = n, leaves, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.roofline.opcount import repeated

        want = [t for t in ctx.leaves if t.requires_grad]
        with repeated(ctx.n):
            got = iter(torch.autograd.grad(ctx.outs, want, grads, allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in ctx.leaves))


def _group(mesh, dim):
    group = mesh.get_group(dim)
    return group.size(), group.group_name


class _SumGrad(torch.autograd.Function):
    """The identity, whose gradient is summed over mesh dim ``dim``: for a
    tensor alike on every rank there, which each rank uses in a part of
    the work (its gradient on each rank is that part's)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.group = _group(mesh, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        _, name = ctx.group
        out = torch.ops._c10d_functional.all_reduce(g.contiguous(), "sum", name)
        return torch.ops._c10d_functional.wait_tensor(out), None, None


class _GatherPairs(torch.autograd.Function):
    """All-gather of each rank's (gate, head) pairs (P, b, dh) along dim 0
    over mesh dim ``dim``.  What follows runs whole and alike on every
    rank, so each holds the whole gradient, and the backward keeps its own
    pairs' part of it."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        size, name = _group(mesh, dim)
        ctx.part = (mesh.get_local_rank(dim) * t.shape[0], t.shape[0])
        out = torch.ops._c10d_functional.all_gather_into_tensor(t.contiguous(), size, name)
        return torch.ops._c10d_functional.wait_tensor(out)

    @staticmethod
    def backward(ctx, g):
        start, size = ctx.part
        return g[start:start + size], None, None


def slstm_step(p, x1, state, num_heads: int):
    return slstm_seq(p, x1, num_heads, state)


def slstm_init_state(batch: int, num_heads: int, dh: int, device="cuda"):
    def z():
        return torch.zeros((batch, num_heads, dh), dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "m": torch.full((batch, num_heads, dh), NEG, dtype=torch.float32, device=device),
            "h": z()}
