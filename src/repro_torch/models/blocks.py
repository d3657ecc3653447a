"""Decoder/encoder block assembly from BlockCfg, PyTorch port of
``repro.models.blocks``.

Every block kind exposes three entry points sharing one param dict:
  init   -- parameters
  seq    -- full-sequence forward (train / prefill); optionally fills a cache
  step   -- single-token decode against the cache or state, written in place
Pre-norm residual structure throughout.  Kinds: ``attn`` (GQA / MHA / MQA,
local windows, bidirectional, gated cross-attention, or MLA when
``cfg.mla`` is set), ``recurrent`` (Griffin), ``mlstm`` and ``slstm``
(xLSTM); the FFN is swiglu or, where ``blk.moe``, the MoE.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as R
from repro_torch.models.config import BlockCfg, ModelConfig


def _ffn_init(init, cfg, blk, dtype):
    if blk.moe:
        return MOE.moe_init(init, cfg, dtype)
    return L.swiglu_init(init, cfg.d_model, cfg.d_ff, dtype)


def _ffn_apply(p, x, cfg, blk):
    if blk.moe:
        return MOE.moe_apply(p, x, cfg)
    return L.swiglu(p, x)


def block_init(init: L.Init, cfg: ModelConfig, blk: BlockCfg):
    dtype = L.dt(cfg.param_dtype)
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_init(init, d, dtype)}
    if blk.kind == "attn":
        dims = A.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
        if cfg.mla is not None:
            p["attn"] = MLA.mla_init(init, cfg, dtype)
        else:
            p["attn"] = A.attn_init(init, d, dims, dtype, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
        if blk.cross_attn:
            p["lnx"] = L.rmsnorm_init(init, d, dtype)
            p["xattn"] = A.attn_init(init, d, dims, dtype, qk_norm=cfg.qk_norm)
            p["xgate"] = init.zeros((1,), dtype)  # gated cross-attn (llama-vision)
    elif blk.kind == "recurrent":
        p["rec"] = R.recurrent_block_init(init, d, cfg.d_rnn, cfg.conv_width, dtype)
    elif blk.kind == "mlstm":
        p["cell"] = R.mlstm_init(init, d, cfg.num_heads, 2 * d, dtype)
        return p
    elif blk.kind == "slstm":
        p["cell"] = R.slstm_init(init, d, cfg.num_heads, dtype)
        return p
    else:
        raise ValueError(f"unknown block kind {blk.kind}")
    if blk.mlp:
        p["ln2"] = L.rmsnorm_init(init, d, dtype)
        p["ffn"] = _ffn_init(init, cfg, blk, dtype)
    return p


def _cross(p, x, cfg, attend):
    """The gated cross-attention sub-block: x + tanh(xgate) * attend(h)."""
    hx = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    gx = torch.tanh(p["xgate"].float()).to(x.dtype)
    return x + gx * attend(hx)


def _ffn(p, x, cfg, blk):
    if blk.mlp and blk.kind in ("attn", "recurrent"):
        x = x + _ffn_apply(p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, blk)
    return x


# --------------------------------------------------------- sequence form ---


def block_seq(p, x, positions, cfg, blk, *, memory=None, want_cache=False,
              cache_len=0):
    """Full-sequence block. Returns (x, cache or state, or None)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    cache = None
    if blk.kind == "attn":
        if cfg.mla is not None:
            # the absorbed form only on the prefill path (want_cache), as in the reference
            use_absorbed = cfg.mla_absorbed and want_cache
            mla_fn = MLA.mla_attention_absorbed if use_absorbed else MLA.mla_attention
            y = mla_fn(p["attn"], h, positions, cfg, blk)
            if want_cache:
                cache = _mla_prefill_cache(p["attn"], h, positions, cfg, cache_len)
        elif want_cache:
            y, (k, v) = A.attention(
                p["attn"], h, positions, cfg, blk,
                causal=not blk.bidirectional, return_kv=True,
            )
            cache = _kv_prefill_cache(k, v, positions, cfg, blk, cache_len)
        else:
            y = A.attention(p["attn"], h, positions, cfg, blk, causal=not blk.bidirectional)
        x = x + y
        if blk.cross_attn and memory is not None:
            x = _cross(p, x, cfg, lambda hx: A.attention(
                p["xattn"], hx, positions, cfg, blk, memory=memory))
    elif blk.kind in ("recurrent", "mlstm", "slstm"):
        if blk.kind == "recurrent":
            y, state = R.recurrent_block_seq(p["rec"], h)
        elif blk.kind == "mlstm":
            y, state = R.mlstm_seq(p["cell"], h, cfg.num_heads)
        else:
            y, state = R.slstm_seq(p["cell"], h, cfg.num_heads)
        x = x + y
        cache = state if want_cache else None
    else:
        raise ValueError(f"unknown block kind {blk.kind}")
    return _ffn(p, x, cfg, blk), cache


def _pad_slots(t, slots, fill):
    """``t`` with axis 1 padded to ``slots`` rows of ``fill``."""
    pad = t.new_full((t.shape[0], slots - t.shape[1]) + tuple(t.shape[2:]), fill)
    return torch.cat([t, pad], dim=1)


def _roll_seq(t, shift):
    """``torch.roll(t, shift, dims=1)``; a DTensor by concatenating its two
    parts (``aten.roll`` has no DTensor strategy in every torch the port
    runs on)."""
    if not hasattr(t, "placements"):
        return torch.roll(t, shift, dims=1)
    n = t.shape[1]
    return torch.cat([t[:, n - shift:], t[:, :n - shift]], dim=1) if shift else t


def _kv_prefill_cache(k, v, positions, cfg, blk, cache_len):
    """Place prefill K/V (positions 0 .. s-1) into a decode cache, position
    p at slot p % slots (the ring layout of local attention), as
    ``A.init_cache`` lays it out.  Built by concatenation and a roll, not
    index writes, so that DTensor keys give a DTensor cache."""
    s = k.shape[1]
    slots = min(blk.window, cache_len) if blk.window > 0 else cache_len
    pos = positions.to(torch.int32)
    if s >= slots:  # keep the last `slots` positions (ring)
        shift = (s - slots) % slots
        k, v = (_roll_seq(t[:, s - slots:], shift) for t in (k, v))
        pos = torch.roll(pos[s - slots:], shift, dims=0)
    else:
        k, v = _pad_slots(k, slots, 0), _pad_slots(v, slots, 0)
        pos = _pad_slots(pos[None], slots, -1)[0]
    return {"k": k, "v": v, "pos": pos}


def _mla_prefill_cache(p_attn, h, positions, cfg, cache_len):
    """The MLA decode cache after prefill (positions 0 .. s-1): the latent
    and RoPE key at their positions, then empty slots."""
    s = h.shape[1]
    if s > cache_len:
        raise IndexError(f"prefill of {s} positions past the MLA cache's {cache_len} slots")
    ckv, kr = MLA.latent_kv(p_attn, h, positions, cfg)
    return {
        "ckv": _pad_slots(ckv.to(h.dtype), cache_len, 0),
        "kr": _pad_slots(kr.to(h.dtype), cache_len, 0),
        "pos": _pad_slots(positions.to(torch.int32)[None], cache_len, -1)[0],
    }


# ------------------------------------------------------------ step form ----


def _write_state(cache, new):
    """Copy a recurrent step's new state into the state it was given: the
    caller's stacked caches hold views, which ``decode_step`` keeps."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def block_step(p, x, cache, pos, cfg, blk, *, memory=None):
    """One-token decode. x: (B,1,D). Returns (x, cache): the attention and
    MLA caches are written at slot ``pos`` in place, the recurrent states
    overwritten with the step's new state."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if blk.kind == "attn":
        if cfg.mla is not None:
            y, cache = MLA.mla_decode(p["attn"], h, cache, pos, cfg, blk)
        else:
            y, cache = A.attention_decode(p["attn"], h, cache, pos, cfg, blk)
        x = x + y
        if blk.cross_attn and memory is not None:
            x = _cross(p, x, cfg, lambda hx: A.attention_decode(
                p["xattn"], hx, None, pos, cfg, blk, memory=memory)[0])
    elif blk.kind in ("recurrent", "mlstm", "slstm"):
        if blk.kind == "recurrent":
            y, new = R.recurrent_block_step(p["rec"], h, cache)
        elif blk.kind == "mlstm":
            y, new = R.mlstm_step(p["cell"], h, cache, cfg.num_heads)
        else:
            y, new = R.slstm_step(p["cell"], h, cache, cfg.num_heads)
        x = x + y
        cache = _write_state(cache, new)
    else:
        raise ValueError(f"unknown block kind {blk.kind}")
    return _ffn(p, x, cfg, blk), cache


def block_init_cache(cfg, blk, batch: int, cache_len: int, dtype, device="cuda"):
    if blk.kind == "attn":
        if cfg.mla is not None:
            return MLA.mla_init_cache(cfg, batch, cache_len, dtype, device=device)
        return A.init_cache(cfg, blk, batch, cache_len, dtype, device=device)
    if blk.kind == "recurrent":
        return R.recurrent_block_init_state(batch, cfg.d_rnn, cfg.conv_width, dtype, device=device)
    if blk.kind == "mlstm":
        dh = 2 * cfg.d_model // cfg.num_heads
        return R.mlstm_init_state(batch, cfg.num_heads, dh, device=device)
    if blk.kind == "slstm":
        return R.slstm_init_state(batch, cfg.num_heads, cfg.d_model // cfg.num_heads, device=device)
    raise ValueError(f"unknown block kind {blk.kind}")
