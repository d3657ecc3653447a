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
    y = torch.matmul(x.float(), p["w"].float())
    if "b" in p:
        y = y + p["b"].float()
    return y.to(out_dtype)


def _replicated(t, where):
    """The DTensor ``t`` with each placement that ``where`` picks made
    ``Replicate()``: a collective."""
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=[Replicate() if where(pl) else pl for pl in t.placements])


def split_last(t, *sizes):
    """``t`` with its last dim split into ``sizes``: a plain reshape.  A
    DTensor sharded along that dim whose first size its shards do not divide
    (8 KV heads of a 1024-wide projection on a 16-wide axis) is gathered
    along it first, where GSPMD reshards in silence: DTensor cannot unflatten
    an uneven shard.  The gather is a collective like any other, which
    ``repro_torch.roofline.opcount`` charges."""
    placements = getattr(t, "placements", None)
    if placements is not None:
        last = t.ndim - 1
        shards = 1
        for i, pl in enumerate(placements):
            if pl.is_shard(last):
                shards *= t.device_mesh.size(i)
        if sizes[0] % shards:
            t = _replicated(t, lambda pl: pl.is_shard(last))
    return t.reshape(tuple(t.shape[:-1]) + tuple(sizes))


def merge_last(t, n):
    """``t`` with its last ``n`` dims flattened into one: a plain reshape.  A
    DTensor keeps a shard of the outermost of them (past dims of size 1) and
    gathers any shard of an inner one first (head_dim under the heads):
    flattening that would need a strided shard, which DTensor does not
    carry through the ops after it."""
    placements = getattr(t, "placements", None)
    if placements is not None:
        dims = range(t.ndim - n, t.ndim)
        outer = next((d for d in dims if t.shape[d] > 1), dims[0])
        inner = [d for d in dims if d != outer]
        if any(pl.is_shard() and pl.dim in inner for pl in placements):
            t = _replicated(t, lambda pl: pl.is_shard() and pl.dim in inner)
    return t.reshape(tuple(t.shape[:t.ndim - n]) + (-1,))


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
    # ``embedding``, not ``table[ids]``: the same rows, and DTensor looks a
    # vocab-sharded table up shard by shard (a masked partial sum, reduced
    # here: the residual stream reads it twice) where it would gather the
    # whole table for an index
    return reduce_partial(torch.nn.functional.embedding(ids, p["table"])).to(out_dtype)


def unembed(p_embed, x):
    """Tied readout: x @ table^T, fp32 logits."""
    return torch.matmul(x.float(), p_embed["table"].float().T)


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
        xf = x.float()
        lab = torch.where(labels >= 0, labels, torch.zeros_like(labels)).long()
        mask = (labels >= 0).float()
        # d loss / d logit = (softmax - onehot) * w, w = g * mask / count per position
        w = (g * mask / torch.clamp_min(mask.sum(), 1.0))[..., None]
        inv_z = 1.0 / torch.clamp_min(z, 1e-37)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = torch.zeros_like(xf) if need_x else None
        dws, dbs = [], []    # per chunk, the columns it sees first (no in-place slice writes: DTensor)
        for start, vfrom in spans:
            lc, th, seen = _ce_logits(xf, weight, bias, tied, start, vfrom, chunk, logit_softcap)
            d = torch.exp(lc - m[..., None]) * inv_z[..., None]        # softmax, 0 at re-seen columns
            local = lab - start
            in_chunk = (local >= 0) & (local < chunk) & (lab - vfrom >= 0)
            col = torch.arange(chunk, device=d.device)
            onehot = ((col == local.clamp(0, chunk - 1)[..., None]) & in_chunk[..., None]).float()
            d = (d - onehot) * w
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
    return _BlockedCE.apply(x, table if tied else w, bias, labels, tied, chunk, logit_softcap)
