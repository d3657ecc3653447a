"""Attention: GQA/MHA/MQA, local (sliding-window) and cross attention.

PyTorch port of ``repro.models.attention`` (MLA is ``models/mla.py``).
The training / prefill path is the reference's flash formulation in torch
ops: an online softmax over key chunks inside a loop over query chunks,
so the (Sq, Sk) score matrix is never materialized.  ``attention_plain`` is the materialized softmax with
the same masks, the yardstick the tests and ``chip_smoke.py`` hold
``_flash`` to; nothing on the model path calls it.  The decode path scores
one query against the KV cache; local attention uses a ring-buffer cache
of window size.  No kernel of ``repro_torch.kernels`` is called here, as
``repro.models`` calls none.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models import layers as L

NEG_INF = -1.0e30


class AttnDims(NamedTuple):
    heads: int
    kv_heads: int
    head_dim: int


# ------------------------------------------------------------- init --------


def attn_init(init: L.Init, d_model, dims: AttnDims, dtype, *, qkv_bias=False, qk_norm=False):
    h, kvh, dh = dims
    p = {
        "wq": L.dense_init(init, d_model, h * dh, dtype, bias=qkv_bias),
        "wk": L.dense_init(init, d_model, kvh * dh, dtype, bias=qkv_bias),
        "wv": L.dense_init(init, d_model, kvh * dh, dtype, bias=qkv_bias),
        "wo": L.dense_init(init, h * dh, d_model, dtype),
    }
    if qk_norm:
        p["qnorm"] = L.rmsnorm_init(init, dh, dtype)
        p["knorm"] = L.rmsnorm_init(init, dh, dtype)
    return p


# ------------------------------------------------------ flash attention ----


def _mask(qpos, kpos, causal: bool, window: int):
    """(Sq, Sk) bool: which keys each query may see."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _pad_seq(t, pad):
    """Pad axis 1 (the sequence) of ``t`` by ``pad`` rows of zeros."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], dim=1)


def _flash_layout(q, k, v, qpos, kpos, q_chunk, k_chunk):
    """Pad q / k / v to whole chunks: (qp, kp, vp, qpos_p, kpos_p, qc, kc).
    Padded queries sit at position -10**9 and padded keys at +10**9, as in
    the reference."""
    sq, sk = q.shape[1], k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    pad_q = (-sq) % qc
    pad_k = (-sk) % kc
    qpos_p = torch.cat([qpos, qpos.new_full((pad_q,), -(10**9))])
    kpos_p = torch.cat([kpos, kpos.new_full((pad_k,), 10**9)])
    return (_pad_seq(q, pad_q), _pad_seq(k, pad_k), _pad_seq(v, pad_k), qpos_p, kpos_p, qc, kc)


# The block products as the einsums they are, each one ``bmm`` on the
# operands laid out as ``torch.einsum`` lays them out (bit for bit the
# einsum's result): einsum's own decomposition dispatches some twenty ops
# per call, which the dry-runs' fake tensors pay for at every block.

def _qk(q, k):
    """einsum("bqkgd,bskd->bkgqs", q, k)."""
    b, qc, kv, g, d = q.shape
    kc = k.shape[1]
    return torch.bmm(q.permute(0, 2, 3, 1, 4).reshape(b * kv, g * qc, d),
                     k.permute(0, 2, 3, 1).reshape(b * kv, d, kc)).view(b, kv, g, qc, kc)


def _pv(p, v):
    """einsum("bkgqs,bskd->bkgqd", p, v)."""
    b, kv, g, qc, kc = p.shape
    return torch.bmm(p.reshape(b * kv, g * qc, kc),
                     v.permute(0, 2, 1, 3).reshape(b * kv, kc, v.shape[-1])).view(b, kv, g, qc, v.shape[-1])


def _pt_do(p, do):
    """einsum("bkgqs,bkgqd->bskd", p, do)."""
    b, kv, g, qc, kc = p.shape
    return torch.bmm(p.permute(0, 1, 4, 2, 3).reshape(b * kv, kc, g * qc),
                     do.reshape(b * kv, g * qc, do.shape[-1])).view(b, kv, kc, do.shape[-1]).permute(0, 2, 1, 3)


def _ds_q(ds, q):
    """einsum("bkgqs,bqkgd->bskd", ds, q)."""
    b, kv, g, qc, kc = ds.shape
    return torch.bmm(ds.permute(0, 1, 4, 2, 3).reshape(b * kv, kc, g * qc),
                     q.permute(0, 2, 3, 1, 4).reshape(b * kv, g * qc, q.shape[-1])
                     ).view(b, kv, kc, q.shape[-1]).permute(0, 2, 1, 3)


def _scores(qb, kb, qposb, kposb, causal, window, scale):
    """One (q chunk, k chunk) block's fp32 scores (B, KV, G, qc, kc), masked
    keys at NEG_INF, and the mask (qc, kc)."""
    mask = _mask(qposb, kposb, causal, window)
    s = _qk(qb, kb) * scale
    return s.masked_fill(~mask, NEG_INF), mask


def _flash_forward(q, k, v, qpos, kpos, causal, window, q_chunk, k_chunk, scale):
    """The online softmax over key chunks inside a loop over query chunks.
    Returns the fp32 output (B, Sq, KV, G, dv) and the final running max
    ``m`` and sum ``l`` (B, KV, G, Sq_padded)."""
    b, sq, kvh, g, _ = q.shape
    dv = v.shape[-1]            # may differ from dh (MLA)
    qp, kp, vp, qpos_p, kpos_p, qc, kc = _flash_layout(q, k, v, qpos, kpos, q_chunk, k_chunk)
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
    outs, ms, ls = [], [], []
    for qi in range(nq):
        qb = qp[:, qi * qc:(qi + 1) * qc].float()         # (B, qc, KV, G, dh)
        qposb = qpos_p[qi * qc:(qi + 1) * qc]
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, dv), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kb = kp[:, ki * kc:(ki + 1) * kc].float()     # (B, kc, KV, dh)
            vb = vp[:, ki * kc:(ki + 1) * kc].float()
            s, _ = _scores(qb, kb, qposb, kpos_p[ki * kc:(ki + 1) * kc], causal, window, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _pv(p, vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B, qc, KV, G, dv)
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1)[:, :sq], torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)


class _FlashRemat(torch.autograd.Function):
    """``_flash`` whose backward recomputes each score block instead of
    saving it (the reference's ``jax.checkpoint(kv_step)``): saved for
    backward are q, k, v, the positions, the fp32 output and the softmax's
    final (m, l) -- nothing of shape (..., qc, kc).  The backward is the
    flash-attention one: per block p = exp(s - m) / l, dV += pᵀ dO,
    dS = p (dO Vᵀ - rowsum(dO o)), zero where the mask hid the key (a masked
    score is a constant), dQ += dS K scale, dK += dSᵀ Q scale."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, q_chunk, k_chunk, scale):
        out, m, l = _flash_forward(q, k, v, qpos, kpos, causal, window, q_chunk, k_chunk, scale)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, m, l)
        ctx.cfg = (causal, window, q_chunk, k_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, out, m, l = ctx.saved_tensors
        causal, window, q_chunk, k_chunk, scale = ctx.cfg
        sq, sk = q.shape[1], k.shape[1]
        qp, kp, vp, qpos_p, kpos_p, qc, kc = _flash_layout(q, k, v, qpos, kpos, q_chunk, k_chunk)
        nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
        do_p = _pad_seq(dout.float(), qp.shape[1] - sq)          # (B, Sq_p, KV, G, dv)
        delta = _pad_seq((dout.float() * out).sum(dim=-1), qp.shape[1] - sq).permute(0, 2, 3, 1)
        inv_l = 1.0 / torch.clamp_min(l, 1e-37)                   # (B, KV, G, Sq_p)
        # per chunk accumulators, concatenated at the end: no in-place
        # slice writes, which a DTensor cannot take
        def zeros(t, n):
            return t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]), dtype=torch.float32)

        dqs = []
        dks = [zeros(kp, kc) for _ in range(nk)]
        dvs = [zeros(vp, kc) for _ in range(nk)]
        for qi in range(nq):
            qs = slice(qi * qc, (qi + 1) * qc)
            qb = qp[:, qs].float()
            dob = do_p[:, qs].permute(0, 2, 3, 1, 4)              # (B, KV, G, qc, dv)
            dq = zeros(qp, qc)
            for ki in range(nk):
                ks = slice(ki * kc, (ki + 1) * kc)
                kb, vb = kp[:, ks].float(), vp[:, ks].float()
                s, mask = _scores(qb, kb, qpos_p[qs], kpos_p[ks], causal, window, scale)
                p = torch.exp(s - m[..., qs, None]) * inv_l[..., qs, None]
                dvs[ki] = dvs[ki] + _pt_do(p, dob)
                ds = p * (_qk(dob.permute(0, 3, 1, 2, 4), vb) - delta[..., qs, None])
                ds = ds.masked_fill(~mask, 0.0) * scale
                dq = dq + _pv(ds, kb).permute(0, 3, 1, 2, 4)
                dks[ki] = dks[ki] + _ds_q(ds, qb)
            dqs.append(dq)
        dq, dk, dv = (torch.cat(parts, dim=1) for parts in (dqs, dks, dvs))
        return (dq[:, :sq].to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype),
                None, None, None, None, None, None, None)


def _flash(q, k, v, qpos, kpos, *, causal: bool, window: int,
           q_chunk: int, k_chunk: int, remat_kv: bool = True,
           scale: Optional[float] = None):
    """Online-softmax attention.

    q: (B, Sq, KV, G, dh)   k, v: (B, Sk, KV, dh)
    qpos: (Sq,) kpos: (Sk,) absolute positions (mask built on the fly).
    Returns (B, Sq, KV, G, dv) in q.dtype.  Padded queries sit at position
    -10**9 and padded keys at +10**9, as in the reference.  ``remat_kv``,
    as in the reference, decides the backward: set, no score block is
    saved and the backward recomputes each (``_FlashRemat``); unset,
    autograd saves every block's (B, KV, G, qc, kc) probabilities.  Where
    no input takes a gradient (prefill, serving), neither: the forward
    alone.
    """
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    args = (q, k, v, qpos, kpos, causal, window, q_chunk, k_chunk, float(scale))
    if remat_kv and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashRemat.apply(*args)
    else:
        out = _flash_forward(*args)[0]
    return out.to(q.dtype)


def _is_dtensor(*ts) -> bool:
    return any(hasattr(t, "placements") for t in ts)


def _local(t):
    return t.to_local() if hasattr(t, "placements") else t


def on_head_shards(fn, q, k, v, qpos=None):
    """``merge_last(fn(q, k, v, qpos), 3)`` with q (B, Sq, KV, G, dh) at
    positions ``qpos`` (Sq,), k (B, Sk, KV, dk), v (B, Sk, KV, dv) and
    ``fn``'s output (B, Sq, KV, G, dv): on plain tensors just that; on
    DTensors ``fn`` runs on each rank's shards, attention being independent
    per batch row, per head and per query.

    DTensor has no strategy for the score ``bmm`` when the batch and a head
    axis are both sharded (einsum flattens them into one strided shard),
    where GSPMD reshards without a word.  So each mesh dim gets one explicit
    placement before ``fn``.  The batch, where q, k or v shard it and the
    mesh divides it.  The heads, on the first other mesh dim that shards a
    head axis or is named "model" (a head count it does not divide leaves
    them whole there): the KV heads where it divides them, else the
    flattened KV x G heads (q, k and v held whole and each rank slicing
    out its heads and their KV heads), else the queries (``qpos`` given:
    each rank its rows of q, k and v whole).  The inputs a rank slices have
    partial-sum gradients.  Anything else is replicated.  The output is
    (B, Sq, KV x G x dv), sharded as the heads or queries were."""
    if not _is_dtensor(q, k, v):
        return L.merge_last(fn(q, k, v, qpos), 3)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    names = mesh.mesh_dim_names or ()
    b, sq, kvh, g, _ = q.shape
    h = kvh * g
    q_pl, kv_pl, q_grad, kv_grad, out_pl = [], [], [], [], []
    batch_split, heads, rows = 1, None, None      # heads: (first kv head, kv heads, first g, g) of this rank
    for i in range(mesh.ndim):
        n = mesh.size(i)
        dims = [getattr(t.placements[i], "dim", None) for t in (q, k, v) if isinstance(t, DTensor)]
        on_heads = n > 1 and heads is None and rows is None and (
            any(d is not None and d >= 2 for d in dims) or names[i:i + 1] == ("model",))
        hl = h // n
        if n > 1 and 0 in dims and b % (batch_split * n) == 0:
            batch_split *= n
            pl = (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0))
        elif on_heads and kvh % n == 0:
            heads = ()
            pl = (Shard(2), Shard(2), Shard(2), Shard(2), Shard(2))
        elif on_heads and h % n == 0 and (g % hl == 0 or hl % g == 0):
            c = mesh.get_local_rank(i)
            heads = (c * hl // g, hl // g, 0, g) if hl % g == 0 else (c * hl // g, 1, c * hl % g, hl)
            pl = (Replicate(), Replicate(), Partial(), Partial(), Shard(2))
        elif on_heads and qpos is not None and sq > 1 and sq % n == 0:
            c = mesh.get_local_rank(i)
            rows = slice(c * sq // n, (c + 1) * sq // n)
            pl = (Shard(1), Replicate(), Shard(1), Partial(), Shard(1))
        else:
            pl = (Replicate(),) * 5
        for acc, x in zip((q_pl, kv_pl, q_grad, kv_grad, out_pl), pl):
            acc.append(x)

    def local(t, placements, grad):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)

    ql, kl, vl = local(q, q_pl, q_grad), local(k, kv_pl, kv_grad), local(v, kv_pl, kv_grad)
    if heads:
        k0, nk, g0, ng = heads
        ql = ql[:, :, k0:k0 + nk, g0:g0 + ng]
        kl, vl = kl[:, :, k0:k0 + nk], vl[:, :, k0:k0 + nk]
    if rows is not None:
        qpos = qpos[rows]
    out = fn(ql, kl, vl, qpos)
    out = out.reshape(tuple(out.shape[:2]) + (-1,))
    return L.grad_placed(DTensor.from_local(out, mesh, out_pl, run_check=False))


def attention_plain(q, k, v, qpos, kpos, *, causal: bool, window: int,
                    scale: Optional[float] = None):
    """``_flash``'s function with the (Sq, Sk) scores materialized.

    The same masks, the same -1e30 fill (a query that sees no key averages
    every value, as ``_flash`` does) and fp32 scores; a yardstick only.
    """
    dh = q.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * float(scale)
    s = s.masked_fill(~_mask(qpos, kpos, causal, window), NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.to(q.dtype)


# ------------------------------------------------- train/prefill forward ---


def project_qkv(p, x, positions, cfg, block, *, memory=None, memory_pos=None):
    """The projections ``attention`` feeds ``_flash``: q (B, S, KV, G, dh),
    k, v (B, Sm, KV, dh), after qk-norm and (self-attention only) RoPE, and
    the keys' positions."""
    dims = AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    h, kvh, dh = dims
    g = h // kvh
    b, s, _ = x.shape

    q = L.split_last(L.dense(p["wq"], x), kvh, g, dh)
    src = memory if memory is not None else x
    sm = src.shape[1]
    k = L.split_last(L.dense(p["wk"], src), kvh, dh)
    v = L.split_last(L.dense(p["wv"], src), kvh, dh)

    if "qnorm" in p:
        q = L.rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["knorm"], k, cfg.norm_eps)

    if memory is None:
        cos, sin = L.rope_cos_sin(positions, dh, block.rope_theta)
        q = apply_rope_grouped(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        kpos = positions
    else:
        kpos = (
            memory_pos
            if memory_pos is not None
            else torch.arange(sm, dtype=torch.int32, device=x.device)
        )
    return q, k, v, kpos


def attention(p, x, positions, cfg, block, *, memory=None, memory_pos=None,
              causal=True, return_kv=False):
    """Self- or cross-attention over a full sequence.

    x: (B, S, D); positions: (S,) int.
    memory: (B, Sm, D_mem) for cross-attention (already projected to d_model
    by the caller if needed).
    Returns (B, S, D), and the projected (k, v) when ``return_kv`` (prefill
    cache fill).
    """
    b, s, _ = x.shape
    q, k, v, kpos = project_qkv(p, x, positions, cfg, block, memory=memory, memory_pos=memory_pos)
    cross = memory is not None
    kpos = _local(kpos)
    out = on_head_shards(lambda q_, k_, v_, qpos_: _flash(
        q_, k_, v_, qpos_, kpos,
        causal=causal and not cross, window=block.window if not cross else 0,
        q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, remat_kv=cfg.flash_remat,
    ), q, k, v, _local(positions))
    y = L.dense(p["wo"], out)
    if return_kv:
        return y, (k, v)
    return y


def apply_rope_grouped(q, cos, sin):
    """RoPE on (B, S, KV, G, dh)."""
    b, s, kvh, g, dh = q.shape
    return L.apply_rope(q.reshape(b, s, kvh * g, dh), cos, sin).reshape(q.shape)


# --------------------------------------------------------------- decode ----


def init_cache(cfg, block, batch: int, cache_len: int, dtype, device="cuda"):
    """KV cache for one attention block.

    Local attention keeps a ring buffer of ``window`` slots (constant-memory
    long-context decode); global attention keeps ``cache_len`` slots.
    ``pos`` records the absolute position stored in each slot (-1 = empty).
    """
    dims = AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    slots = min(block.window, cache_len) if block.window > 0 else cache_len
    shape = (batch, slots, dims.kv_heads, dims.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }


def attention_decode(p, x, cache, pos, cfg, block, *, memory=None):
    """One-token decode. x: (B, 1, D); pos: absolute position (int).

    Returns (out (B, 1, D), cache).  Unlike the reference, which returns a
    new cache, the slot ``pos % slots`` of ``cache`` is written in place and
    the same dict is returned.
    """
    dims = AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    h, kvh, dh = dims
    g = h // kvh

    q = L.split_last(L.dense(p["wq"], x), kvh, g, dh)
    if memory is not None:  # cross-attn: static memory, no cache update
        memory = L.batch_like(memory, x)
        k = L.split_last(L.dense(p["wk"], memory), kvh, dh)
        v = L.split_last(L.dense(p["wv"], memory), kvh, dh)
        if "qnorm" in p:
            q = L.rmsnorm(p["qnorm"], q, cfg.norm_eps)
            k = L.rmsnorm(p["knorm"], k, cfg.norm_eps)
        out = _decode_heads(lambda q_, k_, v_, _: _decode_attend(q_, k_, v_, None, dh), q, k, v)
        return L.dense(p["wo"], out.to(x.dtype)), cache

    k1 = L.split_last(L.dense(p["wk"], x), kvh, dh)
    v1 = L.split_last(L.dense(p["wv"], x), kvh, dh)
    if "qnorm" in p:
        q = L.rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k1 = L.rmsnorm(p["knorm"], k1, cfg.norm_eps)

    pos = int(pos)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    cos, sin = L.rope_cos_sin(posv, dh, block.rope_theta)
    q = apply_rope_grouped(q, cos, sin)
    k1 = L.apply_rope(k1, cos, sin)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % ck.shape[1]  # ring buffer; identity when slots == cache_len > pos
    ck[:, slot] = k1[:, 0].to(ck.dtype)
    cv[:, slot] = v1[:, 0].to(cv.dtype)
    cpos[slot].fill_(pos)   # a fill, not a copy from a host scalar (which would wait for the card)

    valid = (cpos >= 0) & (cpos <= pos)
    if block.window > 0:
        valid &= cpos > (pos - block.window)
    if _is_dtensor(q, ck) and not _is_dtensor(valid):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = next(t.device_mesh for t in (q, ck) if _is_dtensor(t))
        valid = DTensor.from_local(valid, mesh, [Replicate()] * mesh.ndim, run_check=False)
    kv_dtype = q.dtype

    def attend(q_, k_, v_, _=None):
        valid_ = valid if _is_dtensor(q_) else _local(valid)
        return _decode_attend(q_, k_.to(kv_dtype), v_.to(kv_dtype), valid_, dh)

    out = _decode_heads(attend, q, ck, cv)
    return L.dense(p["wo"], out.to(x.dtype)), cache


def _decode_attend(q, k, v, valid, dh):
    """One query per row against keys k / values v (B, Sk, KV, d): the fp32
    softmax over the keys that ``valid`` (Sk,) keeps (all where None).
    Returns (B, 1, KV, G, dv) fp32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())[:, :, :, 0] / float(np.sqrt(dh))
    if valid is not None:
        s = s.masked_fill(~valid[None, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)                       # (B, KV, G, Sk)
    return torch.einsum("bkgs,bskd->bkgd", w, v.float())[:, None]


def _decode_heads(fn, q, k, v):
    """``fn`` over the heads, merged to (B, 1, H x dv): on shards of batch
    and heads (``on_head_shards``), except where the keys shard their
    head_dim (a KV head count that the mesh does not divide, as
    ``cache_specs`` places such caches): that runs as DTensor ops, the score
    a partial sum over head_dim shards, where gathering the cache's heads
    would move the whole cache at every step."""
    placements = getattr(k, "placements", None)
    if placements is not None and any(pl.is_shard(k.ndim - 1) for pl in placements):
        return L.merge_last(fn(q, k, v, None), 3)
    return on_head_shards(fn, q, k, v)
