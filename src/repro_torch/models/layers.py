"""Elementary layers, PyTorch port of ``repro.models.layers``.

Functional style: ``*_init`` returns a parameter dict, apply functions are
pure.  Numerics policy (DESIGN.md #6), as in the reference: parameters in
``cfg.param_dtype``, activations in ``cfg.activation_dtype``, norms and
softmax in fp32, and every product that the reference takes with
``preferred_element_type=float32`` is taken here on fp32 copies of both
inputs (a bf16 activation is upcast, an fp32 weight is never downcast).
fp32 products stay at torch's default full precision: no TF32.

Parameters are drawn by an ``Init`` from an explicit ``torch.Generator``:
torch cannot replay ``jax.random``, so the port draws the same
distributions, not the same numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dt(name: str) -> torch.dtype:
    return getattr(torch, name)


DRAW_SLICE = 1 << 26   # fp32 elements drawn at once for a leaf of another dtype


class Init:
    """Draws parameter leaves on ``device`` from ``generator``.

    ``lead`` is prepended to every leaf's shape: ``stacked(repeat)`` gives the
    layer groups' ``(repeat, ...)`` leaves (the reference ``vmap``s its init
    over ``repeat`` keys).  On the ``meta`` device nothing is drawn or
    allocated (``abstract_params``).
    """

    def __init__(self, generator: Optional[torch.Generator], device: torch.device,
                 lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)

    def stacked(self, repeat: int) -> "Init":
        return Init(self.generator, self.device, (repeat,) + self.lead)

    def _empty(self, shape, dtype):
        return torch.empty(self.lead + tuple(shape), dtype=dtype, device=self.device)

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        """fp32 normal draws times ``std``, cast to ``dtype``.  A leaf of
        another dtype larger than ``DRAW_SLICE`` elements is drawn in slices
        of that many, so the fp32 transient stays bounded (one of arctic's
        bf16 expert stacks is 17.8 GB in fp32)."""
        w = self._empty(shape, dtype)
        if self.device.type == "meta":
            return w
        if dtype == torch.float32:
            return w.normal_(0.0, float(std), generator=self.generator)
        flat = w.view(-1)
        for start in range(0, flat.numel(), DRAW_SLICE):
            part = flat[start:start + DRAW_SLICE]
            draw = torch.empty(part.shape, dtype=torch.float32, device=self.device)
            part.copy_(draw.normal_(0.0, float(std), generator=self.generator))
        return w

    def uniform(self, shape, low: float, high: float, dtype) -> torch.Tensor:
        """fp32 uniform draws on [low, high), cast to ``dtype``."""
        w = self._empty(shape, torch.float32)
        if self.device.type != "meta":
            w.uniform_(float(low), float(high), generator=self.generator)
        return w.to(dtype)

    def ones(self, shape, dtype) -> torch.Tensor:
        t = self._empty(shape, dtype)
        return t if self.device.type == "meta" else t.fill_(1)

    def zeros(self, shape, dtype) -> torch.Tensor:
        t = self._empty(shape, dtype)
        return t if self.device.type == "meta" else t.zero_()


def dense_init(init: Init, d_in: int, d_out: int, dtype, bias: bool = False,
               scale: Optional[float] = None):
    std = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": init.normal((d_in, d_out), std, dtype)}
    if bias:
        p["b"] = init.zeros((d_out,), dtype)
    return p


def dense(p, x, out_dtype=None):
    out_dtype = out_dtype or x.dtype
    x = matmul_layout(x, p["w"])
    x, w, dims = split_idle_dp(x, p["w"])
    y = whole_on(torch.matmul(x.float(), w.float()), dims)
    if "b" in p:
        y = y + p["b"].float()
    return grad_placed(y.to(out_dtype))


def grad_placed(y):
    """``y``; where it is a DTensor that takes a gradient, the gradient
    arrives placed as ``y`` is, with partial sums reduced.  A gradient that
    reaches a product as partial sums (the vocab-parallel CE's, for one)
    would otherwise stay partial through the product's backward, which
    DTensor then runs with the whole weight on every rank."""
    placements = getattr(y, "placements", None)
    if placements is None or not y.requires_grad:
        return y
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if pl.is_partial() else pl for pl in placements)

    def place(g):
        return g if tuple(g.placements) == want else g.redistribute(g.device_mesh, want)

    y.register_hook(place)
    return y


def _replicated(t, where):
    """The DTensor ``t`` with each placement that ``where`` picks made
    ``Replicate()``: a collective.  Its gradient comes back placed so too
    (``grad_placed``): DTensor cannot carry a partial-sum gradient back
    through the redistribution of a masked partial (an embedding's)."""
    from torch.distributed.tensor import Replicate
    return grad_placed(t.redistribute(placements=[Replicate() if where(pl) else pl for pl in t.placements]))


def matmul_layout(x, w):
    """The activation ``x`` (..., d_in) of ``x @ w`` placed as the Megatron
    layout has it, where both are DTensors; else ``x`` as it is.  Per mesh
    dim: a batch shard (dim 0) stays; where ``w`` shards its output
    features, ``x`` is whole (a column-parallel product); where ``w`` shards
    its input features, ``x`` shards its last dim (a row-parallel product,
    partial sums out); any other shard or partial sum of ``x`` is gathered
    or reduced first.  GSPMD picks these layouts itself; DTensor, given a
    row- or sequence-sharded activation, gathers the whole weight instead
    and then runs every rank's product unsharded."""
    if getattr(x, "placements", None) is None or getattr(w, "placements", None) is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    last = x.ndim - 1
    want = []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_shard(0) and last > 0:
            want.append(xp)
        elif wp.is_shard(w.ndim - 1):
            want.append(Replicate())
        elif wp.is_shard(w.ndim - 2):
            want.append(Shard(last))
        elif xp.is_partial() or (not xp.is_replicate() and not xp.is_shard(last)):
            want.append(Replicate())
        else:
            want.append(xp)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_idle_dp(x, w):
    """``x @ w``'s operands with the product also split over the
    data-parallel mesh dims that the batch cannot be split over (a batch of
    1 on "data"), as GSPMD splits it; and those dims, on which the caller
    makes the product whole again (``whole_on``).  On each such dim where
    ``x`` and ``w`` are both replicated, each rank takes a slice of ``w``
    (a local slice, no collective): of its output features where another
    dim already splits the contraction (a row-parallel product: the
    result comes out sharded there, and is gathered), else of its input
    features, ``x`` sliced alike (the result is a partial sum, all-reduced).
    Anything else, or a width those dims do not divide, is returned as it
    is, with no dims."""
    if getattr(x, "placements", None) is None or getattr(w, "placements", None) is None:
        return x, w, ()
    from torch.distributed.tensor import Shard

    from repro_torch.sharding.rules import dp_axes

    mesh = x.device_mesh
    dp = [mesh.mesh_dim_names.index(a) for a in dp_axes(mesh)]
    idle = tuple(i for i in dp if x.placements[i].is_replicate() and w.placements[i].is_replicate()
                 and x.shape[0] % mesh.size(i))
    n = int(np.prod([mesh.size(i) for i in idle]))
    last, rows, cols = x.ndim - 1, w.ndim - 2, w.ndim - 1
    if any(pl.is_shard(rows) for pl in w.placements):       # row-parallel: split the output features
        dim = cols
        ok = w.shape[cols] % n == 0 and not any(pl.is_shard(cols) for pl in w.placements)
    else:                                                   # split the contraction
        dim = rows
        ok = w.shape[rows] % n == 0 and not any(pl.is_shard(last) for pl in x.placements)
        if idle and ok:
            x = x.redistribute(mesh, [Shard(last) if i in idle else pl for i, pl in enumerate(x.placements)])
    if not idle or not ok:
        return x, w, ()
    w = w.redistribute(mesh, [Shard(dim) if i in idle else pl for i, pl in enumerate(w.placements)])
    return x, w, idle


def whole_on(y, dims):
    """The DTensor ``y`` replicated on the mesh dims ``dims`` (a gather or
    an all-reduce, which ``repro_torch.roofline.opcount`` charges); ``y``
    as it is for no dims."""
    if not dims:
        return y
    from torch.distributed.tensor import Replicate
    return y.redistribute(y.device_mesh, [Replicate() if i in dims else pl for i, pl in enumerate(y.placements)])


def batch_like(t, ref):
    """``t`` with its batch dim (0) sharded wherever the DTensor ``ref``
    shards its own and ``t`` is whole: each rank keeps its rows, no
    collective (a replicated cross-attention memory beside a batch-sharded
    query, as GSPMD shards it).  Anything else as it is."""
    placements = getattr(ref, "placements", None)
    if placements is None or getattr(t, "placements", None) is None:
        return t
    from torch.distributed.tensor import Shard
    want = [Shard(0) if (rp.is_shard(0) and tp.is_replicate()) else tp
            for rp, tp in zip(placements, t.placements)]
    if want == list(t.placements) or t.shape[0] != ref.shape[0]:
        return t
    return t.redistribute(t.device_mesh, want)


def split_last(t, *sizes, inner=False):
    """``t`` with its last dim split into ``sizes``: a plain reshape.  A
    DTensor sharded along that dim whose first size its shards do not divide
    (8 KV heads of a 1024-wide projection on a 16-wide axis) is gathered
    along it first, where GSPMD reshards in silence: DTensor cannot unflatten
    an uneven shard.  The gather is a collective like any other, which
    ``repro_torch.roofline.opcount`` charges.  With ``inner``, the gathered
    shards then move to the last of ``sizes`` where it divides them (each
    rank keeps a slice of what it holds: no collective)."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t.reshape(tuple(t.shape[:-1]) + tuple(sizes))
    last = t.ndim - 1
    split = [i for i, pl in enumerate(placements) if pl.is_shard(last)]
    shards = 1
    for i in split:
        shards *= t.device_mesh.size(i)
    if sizes[0] % shards == 0:
        return t.reshape(tuple(t.shape[:-1]) + tuple(sizes))
    t = _replicated(t, lambda pl: pl.is_shard(last))
    t = t.reshape(tuple(t.shape[:-1]) + tuple(sizes))
    if inner and sizes[-1] % shards == 0:
        from torch.distributed.tensor import Shard
        pls = list(t.placements)
        for i in split:
            pls[i] = Shard(t.ndim - 1)
        t = t.redistribute(t.device_mesh, pls)
    return t


def merge_last(t, n):
    """``t`` with its last ``n`` dims flattened into one: a plain reshape.  A
    DTensor keeps a shard of the outermost of them (past dims of size 1) and
    gathers any shard of an inner one first (head_dim under the heads):
    flattening that would need a strided shard, which DTensor does not
    carry through the ops after it.  Its gradient comes back placed as the
    result is (``grad_placed``): one sharded along the merged dim cannot be
    split back into the dims (torch 2.11)."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t.reshape(tuple(t.shape[:t.ndim - n]) + (-1,))
    dims = range(t.ndim - n, t.ndim)
    outer = next((d for d in dims if t.shape[d] > 1), dims[0])
    inner = [d for d in dims if d != outer]
    if any(pl.is_shard() and pl.dim in inner for pl in placements):
        t = _replicated(t, lambda pl: pl.is_shard() and pl.dim in inner)
    return grad_placed(t.reshape(tuple(t.shape[:t.ndim - n]) + (-1,)))


def unshard(t, dim):
    """``t`` whole along ``dim`` on every rank: a DTensor sharded along it
    is gathered (DTensor's argmax over a sharded dim computes its global
    offsets from tensors, which fake tensors cannot give); a plain tensor as
    it is."""
    placements = getattr(t, "placements", None)
    dim = dim % t.ndim
    if placements is None or not any(pl.is_shard(dim) for pl in placements):
        return t
    return _replicated(t, lambda pl: pl.is_shard(dim))


def reduce_partial(t):
    """``t`` with a DTensor's pending partial sums all-reduced now; a plain
    tensor as it is.  A gather or an embedding lookup along a vocab-sharded
    dim leaves a masked partial that DTensor can reduce once only, and only
    at the lookup's shape, so the caller reduces it before it reshapes or
    reuses it."""
    placements = getattr(t, "placements", None)
    if placements is None or not any(pl.is_partial() for pl in placements):
        return t
    return _replicated(t, lambda pl: pl.is_partial())


def rmsnorm_init(init: Init, d: int, dtype):
    return {"scale": init.ones((d,), dtype)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(init: Init, d: int, dtype):
    return {"scale": init.ones((d,), dtype), "bias": init.zeros((d,), dtype)}


def layernorm(p, x, eps: float = 1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed_init(init: Init, vocab: int, d: int, dtype):
    return {"table": init.normal((vocab, d), 0.02, dtype)}


def embed(p, ids, out_dtype):
    # ``embedding``, not ``table[ids]``: the same rows, and a vocab-sharded
    # table is looked up shard by shard (``_embed_on_shards``) where an index
    # would gather the whole table
    table = p["table"]
    if getattr(table, "placements", None) is not None:
        return _embed_on_shards(table, ids).to(out_dtype)
    return torch.nn.functional.embedding(ids, table).to(out_dtype)


def _embed_on_shards(table, ids):
    """The lookup of a DTensor ``table`` (V, D): each rank looks its ids up
    in its own vocab shard (zero rows for ids outside it) and the shards'
    rows are summed across that mesh dim (a masked partial sum, reduced
    here: the residual stream reads it twice).  The ids keep their batch
    shards; every other mesh dim holds the table whole (an FSDP shard
    gathered).  DTensor's own masked partial loses its mask when the ids
    are batch-sharded and the lookup takes a gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [i for i, pl in enumerate(table.placements) if pl.is_shard(0)]
    vi = vocab[0] if len(vocab) == 1 and table.shape[0] % mesh.size(vocab[0]) == 0 else None
    rows = [Shard(0) if (i != vi and pl.is_shard(0)) else Replicate() for i, pl in enumerate(ids.placements)]
    t_pl = [Shard(0) if i == vi else Replicate() for i in range(mesh.ndim)]
    # the table's gradient is a partial sum over the batch shards
    tl = table.redistribute(mesh, t_pl).to_local(
        grad_placements=[Partial() if pl.is_shard(0) else t_pl[i] for i, pl in enumerate(rows)])
    il = ids.redistribute(mesh, rows).to_local()
    if vi is None:
        return DTensor.from_local(torch.nn.functional.embedding(il, tl), mesh, rows, run_check=False)
    off = mesh.get_local_rank(vi) * tl.shape[0]
    local = il - off
    inside = (local >= 0) & (local < tl.shape[0])
    out = torch.nn.functional.embedding(torch.where(inside, local, torch.zeros_like(local)), tl)
    out = out * inside[..., None].to(out.dtype)
    part = [Partial() if i == vi else pl for i, pl in enumerate(rows)]
    return _replicated(_FromLocal.apply(out, mesh, part, rows), lambda pl: pl.is_partial())


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local(local, mesh, placements)`` whose gradient is
    handed back placed as ``grad_placements`` (the whole gradient for a
    partial sum's shard, where ``from_local`` itself would split it);
    ``from_local(grad_placements=)`` is not in every torch this runs on."""

    @staticmethod
    def forward(ctx, local, mesh, placements, grad_placements):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.grad_placements).to_local(), None, None, None


def unembed(p_embed, x):
    """Tied readout: x @ table^T, fp32 logits.  Under DTensor a
    column-parallel product placed here, not by DTensor (whose choice
    differs between torch versions): ``x`` whole but for its batch shards,
    the logits sharded over the vocab as the table is.  The contraction is
    not split over the data axes at batch 1, as GSPMD leaves it."""
    w = p_embed["table"].float().T
    if getattr(x, "placements", None) is not None:
        x = _replicated(x, lambda pl: not pl.is_shard(0))
    return grad_placed(torch.matmul(matmul_layout(x, w).float(), w))


# ---------------------------------------------------------------- RoPE -----


def rope_cos_sin(positions, dim: int, theta: float):
    """positions (...,) int -> (..., dim/2) cos & sin, fp32."""
    half = dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (float(theta) ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, n_heads, dh); cos/sin (..., S, dh/2) -- NeoX half split."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLPs -----


def swiglu_init(init: Init, d: int, f: int, dtype):
    return {
        "wg": dense_init(init, d, f, dtype),
        "wi": dense_init(init, d, f, dtype),
        "wo": dense_init(init, f, d, dtype),
    }


def swiglu(p, x):
    g = dense(p["wg"], x, torch.float32)
    u = dense(p["wi"], x, torch.float32)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return dense(p["wo"], h)


def gelu_mlp_init(init: Init, d: int, f: int, dtype):
    return {
        "wi": dense_init(init, d, f, dtype, bias=True),
        "wo": dense_init(init, f, d, dtype, bias=True),
    }


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.nn.functional.gelu(dense(p["wi"], x, torch.float32), approximate="tanh")
    return dense(p["wo"], h.to(x.dtype))


def softcap(x, cap: float):
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def _ce_chunks(v: int, chunk: int):
    """(chunk, [(start, valid_from)]): vocab chunks of ``chunk`` columns; a
    vocab that is not a multiple gets an overlapping last chunk whose
    already-seen columns (below ``valid_from``) are masked."""
    chunk = min(chunk, v)
    nc = -(-v // chunk)
    starts = [i * chunk for i in range(nc)]
    valid_from = list(starts)
    if starts[-1] + chunk > v:       # overlap the last chunk; mask re-seen cols
        starts[-1] = v - chunk
    return chunk, list(zip(starts, valid_from))


def _ce_logits(xf, weight, bias, tied, start, vfrom, chunk, logit_softcap):
    """One chunk's fp32 logits (B, S, chunk) after the softcap, re-seen
    columns at -inf; and the tanh of the softcap (None without one)."""
    if tied:
        lc = torch.matmul(xf, weight[start:start + chunk].float().T)
    else:
        lc = torch.matmul(xf, weight[:, start:start + chunk].float())
    if bias is not None:
        lc = lc + bias[start:start + chunk].float()
    th = None
    if logit_softcap and logit_softcap > 0:
        th = torch.tanh(lc / logit_softcap)
        lc = th * logit_softcap
    gcol = start + torch.arange(chunk, device=xf.device)
    seen = (gcol >= vfrom)[None, None, :]
    return lc.masked_fill(~seen, -torch.inf), th, seen


class _BlockedCE(torch.autograd.Function):
    """The streaming CE with a backward that walks the vocab chunks again.

    Forward keeps only the running max ``m`` and sum ``z`` (B, S) of the
    online softmax; backward recomputes each chunk's logits and takes
    d loss / d logits = (softmax - onehot) * mask / count from them, so
    what is saved for backward is x, the labels and (m, z) whatever the
    number of chunks (the reference's ``jax.checkpoint`` over its scan
    body does the same)."""

    @staticmethod
    def forward(ctx, x, weight, bias, labels, tied, chunk, logit_softcap):
        b, s, _ = x.shape
        dev = x.device
        v = weight.shape[0] if tied else weight.shape[1]
        chunk, spans = _ce_chunks(v, chunk)
        # masked (negative) labels pick index 0 -- the -inf never reaches the
        # loss because the mask zeroes those positions (avoid 0 * inf = NaN)
        lab = torch.where(labels >= 0, labels, torch.zeros_like(labels)).long()
        xf = x.float()
        m = torch.full((b, s), -torch.inf, dtype=torch.float32, device=dev)
        z = torch.zeros((b, s), dtype=torch.float32, device=dev)
        picked = torch.full((b, s), -torch.inf, dtype=torch.float32, device=dev)
        for start, vfrom in spans:
            lc, _, _ = _ce_logits(xf, weight, bias, tied, start, vfrom, chunk, logit_softcap)
            m_new = torch.maximum(m, lc.amax(dim=-1))
            z = z * torch.exp(m - m_new) + torch.exp(lc - m_new[..., None]).sum(dim=-1)
            m = m_new
            local = lab - start
            in_chunk = (local >= 0) & (local < chunk) & (lab - vfrom >= 0)
            safe = local.clamp(0, chunk - 1)
            got = reduce_partial(torch.gather(lc, -1, safe[..., None]))[..., 0]
            picked = torch.where(in_chunk & (got > -torch.inf), got, picked)
        ll = picked - m - torch.log(torch.clamp_min(z, 1e-37))
        mask = (labels >= 0).float()
        count = torch.clamp_min(mask.sum(), 1.0)
        ctx.save_for_backward(x, weight, bias, labels, m, z)
        ctx.cfg = (tied, chunk, spans, logit_softcap)
        return -(ll * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, labels, m, z = ctx.saved_tensors
        tied, chunk, spans, logit_softcap = ctx.cfg
        lab = torch.where(labels >= 0, labels, torch.zeros_like(labels)).long()
        mask = (labels >= 0).float()
        # d loss / d logit = (softmax - onehot) * w, w = g * mask / count per position
        w = (g * mask / torch.clamp_min(mask.sum(), 1.0))[..., None]
        inv_z = 1.0 / torch.clamp_min(z, 1e-37)

        def dlogits(lc, start, vfrom):
            d = torch.exp(lc - m[..., None]) * inv_z[..., None]        # softmax, 0 at re-seen columns
            return (d - _onehot(lab, start, vfrom, chunk, d.device).float()) * w

        return _ce_backward(ctx, x, weight, bias, tied, chunk, spans, logit_softcap, dlogits)


def _onehot(lab, start, vfrom, chunk, device):
    """(B, S, chunk) bool: the label's column of the chunk at ``start``
    (none for a label below ``vfrom``, which an earlier chunk saw)."""
    local = lab - start
    in_chunk = (local >= 0) & (local < chunk) & (lab - vfrom >= 0)
    col = torch.arange(chunk, device=device)
    return (col == local.clamp(0, chunk - 1)[..., None]) & in_chunk[..., None]


def _ce_backward(ctx, x, weight, bias, tied, chunk, spans, logit_softcap, dlogits):
    """The chunk walk of a streaming CE's backward: per chunk the logits
    again, ``dlogits(logits, start, vfrom)`` (d loss / d logit before the
    softcap's derivative), and its products into dx, dw and db; returns
    the backward's input gradients."""
    xf = x.float()
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dx = torch.zeros_like(xf) if need_x else None
    dws, dbs = [], []    # per chunk, the columns it sees first (no in-place slice writes: DTensor)
    for start, vfrom in spans:
        lc, th, seen = _ce_logits(xf, weight, bias, tied, start, vfrom, chunk, logit_softcap)
        d = dlogits(lc, start, vfrom)
        if th is not None:
            d = d * (1.0 - th * th)
        d = d.masked_fill(~seen, 0.0)
        if need_x:
            wc = weight[start:start + chunk].float() if tied else weight[:, start:start + chunk].float().T
            dx = dx + torch.matmul(d, wc)
        new = slice(vfrom - start, None)
        if need_w:
            if tied:
                dws.append(torch.einsum("bsc,bsd->cd", d, xf)[new].to(weight.dtype))
            else:
                dws.append(torch.einsum("bsd,bsc->dc", xf, d)[:, new].to(weight.dtype))
        if need_b:
            dbs.append(d.sum(dim=(0, 1))[new].to(bias.dtype))
    dw = torch.cat(dws, dim=0 if tied else 1) if need_w else None
    db = torch.cat(dbs) if need_b else None
    return (dx.to(x.dtype) if need_x else None), dw, db, None, None, None, None


class _BlockedLSE(torch.autograd.Function):
    """One vocab shard's part of the streaming CE: the logsumexp ``lse``
    (B, S) of this shard's logits and the label's logit ``picked`` (B, S),
    0 where the label lies in another shard.  The same chunk walk as
    ``_BlockedCE``, forward and backward (d lse / d logit = softmax of the
    shard, d picked / d logit = the one-hot)."""

    @staticmethod
    def forward(ctx, x, weight, bias, lab, tied, chunk, logit_softcap):
        b, s, _ = x.shape
        v = weight.shape[0] if tied else weight.shape[1]
        chunk, spans = _ce_chunks(v, chunk)
        xf = x.float()
        m = torch.full((b, s), -torch.inf, dtype=torch.float32, device=x.device)
        z = torch.zeros((b, s), dtype=torch.float32, device=x.device)
        picked = torch.zeros((b, s), dtype=torch.float32, device=x.device)
        for start, vfrom in spans:
            lc, _, _ = _ce_logits(xf, weight, bias, tied, start, vfrom, chunk, logit_softcap)
            m_new = torch.maximum(m, lc.amax(dim=-1))
            z = z * torch.exp(m - m_new) + torch.exp(lc - m_new[..., None]).sum(dim=-1)
            m = m_new
            local = lab - start
            in_chunk = (local >= 0) & (local < chunk) & (lab - vfrom >= 0)
            got = torch.gather(lc, -1, local.clamp(0, chunk - 1)[..., None])[..., 0]
            picked = torch.where(in_chunk, got, picked)
        lse = m + torch.log(torch.clamp_min(z, 1e-37))
        ctx.save_for_backward(x, weight, bias, lab, lse)
        ctx.cfg = (tied, chunk, spans, logit_softcap)
        return lse, picked

    @staticmethod
    def backward(ctx, g_lse, g_picked):
        x, weight, bias, lab, lse = ctx.saved_tensors
        tied, chunk, spans, logit_softcap = ctx.cfg

        def dlogits(lc, start, vfrom):
            d = torch.exp(lc - lse[..., None]) * g_lse[..., None]
            return d + _onehot(lab, start, vfrom, chunk, d.device).float() * g_picked[..., None]

        return _ce_backward(ctx, x, weight, bias, tied, chunk, spans, logit_softcap, dlogits)


def _vocab_parallel_ce(x, labels, weight, bias, tied, chunk, logit_softcap):
    """``blocked_cross_entropy`` with a DTensor ``weight``, Megatron's
    vocab-parallel CE: over the mesh dim that shards the vocab evenly (or,
    where none does, the "model" dim, each rank then slicing its part of
    the whole weight), each rank walks the chunks of its own vocab range
    (``_BlockedLSE``), and the ranges' logsumexps and label logits are
    combined across that dim.  The batch keeps its shards; every other mesh
    dim holds the weight whole.  Slicing a chunk out of the sharded weight
    would instead gather it, and every rank would then compute every
    chunk's logits.  None where no mesh dim splits the vocab."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(weight, DTensor):
        return None
    vdim = 0 if tied else 1
    v = weight.shape[vdim]
    mesh = weight.device_mesh
    names = mesh.mesh_dim_names or ()
    sharded = [i for i, pl in enumerate(weight.placements) if pl.is_shard(vdim)]
    if len(sharded) == 1 and v % mesh.size(sharded[0]) == 0:
        vi, whole = sharded[0], False
    elif not sharded and "model" in names and 1 < mesh.size(names.index("model")) <= v:
        vi, whole = names.index("model"), True
    else:
        return None
    n, c = mesh.size(vi), mesh.get_local_rank(vi)
    vl = -(-v // n)
    lo, hi = c * vl, min((c + 1) * vl, v)
    chunk = -(-(hi - lo) // -(-(hi - lo) // chunk))     # the range in equal chunks: no overlap to recompute
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    rows = [Shard(0) if (i != vi and pl.is_shard(0)) else Replicate() for i, pl in enumerate(x.placements)]
    part = [Partial() if i == vi else pl for i, pl in enumerate(rows)]
    xl = x.redistribute(mesh, rows).to_local(grad_placements=part)
    # the weight's gradient is a partial sum over the batch shards (and, held
    # whole, over the vocab ranges)
    w_pl = [Shard(vdim) if (i == vi and not whole) else Replicate() for i in range(mesh.ndim)]
    w_grad = [w_pl[i] if i == vi and not whole else (Partial() if (i == vi or pl.is_shard(0)) else pl)
              for i, pl in enumerate(rows)]
    wl = weight.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    if whole:
        wl = wl[lo:hi] if tied else wl[:, lo:hi]
    bl = None
    if bias is not None:
        bl = bias.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if (i == vi or pl.is_shard(0)) else pl for i, pl in enumerate(rows)]
        )[lo:hi]
    lab = labels.redistribute(mesh, rows).to_local()
    lab = torch.where(lab >= 0, lab, torch.zeros_like(lab)).long() - lo
    lse_l, picked_l = _BlockedLSE.apply(xl, wl, bl, lab, tied, chunk, logit_softcap)
    stacked = [Shard(0) if i == vi else (Shard(1) if pl.is_shard(0) else pl) for i, pl in enumerate(rows)]
    lse = torch.logsumexp(DTensor.from_local(lse_l[None], mesh, stacked, run_check=False), dim=0)
    # each range's label logit is a partial sum whose gradient is the whole one
    picked = _FromLocal.apply(picked_l, mesh, part, rows)
    ll = picked - lse
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def blocked_cross_entropy(
    x, labels, *, table=None, w=None, bias=None, chunk: int = 8192,
    logit_softcap: float = 0.0,
):
    """Streaming CE loss over vocab chunks -- logits are NEVER materialized.

    Computes max / logsumexp / label logit chunk by chunk (online softmax
    over the vocab axis), so peak memory is (B, S, chunk), and the backward
    recomputes each chunk's logits (``_BlockedCE``) rather than saving
    them.  A vocab that is not a multiple of ``chunk`` gets an overlapping
    last chunk whose already-seen columns are masked (first-seen masking).

    x: (B, S, D); labels: (B, S) int (negative = masked out).
    table: (V, D) tied embedding, or w: (D, V) untied unembed matrix.
    Returns mean loss over unmasked positions (fp32 scalar).
    """
    tied = table is not None
    weight = table if tied else w
    loss = _vocab_parallel_ce(x, labels, weight, bias, tied, chunk, logit_softcap)
    if loss is not None:
        return loss
    return _BlockedCE.apply(x, weight, bias, labels, tied, chunk, logit_softcap)
