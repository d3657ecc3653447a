"""Decoder/encoder block assembly from BlockCfg, PyTorch port of
``repro.models.blocks``.

Every block kind exposes three entry points sharing one param dict:
  init   -- parameters
  seq    -- full-sequence forward (train / prefill); optionally fills a cache
  step   -- single-token decode against the cache (written in place)
Pre-norm residual structure throughout.

The port has the ``attn`` kind: causal and bidirectional self-attention,
gated cross-attention and the swiglu FFN.  Multi-head latent attention,
the MoE FFN and the recurrent kinds (recurrent / mlstm / slstm) raise
``NotImplementedError`` (ROADMAP Queue A item 13b).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import BlockCfg, ModelConfig


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP Queue A item 13b "
        "(models/mla.py, moe.py and recurrent.py)"
    )


def _check_ported(cfg: ModelConfig, blk: BlockCfg) -> None:
    if blk.kind in ("recurrent", "mlstm", "slstm"):
        raise _not_ported(f"the {blk.kind} block")
    if blk.kind != "attn":
        raise ValueError(f"unknown block kind {blk.kind}")
    if cfg.mla is not None:
        raise _not_ported("multi-head latent attention (MLA)")
    if blk.moe:
        raise _not_ported("the MoE FFN")


def block_init(init: L.Init, cfg: ModelConfig, blk: BlockCfg):
    _check_ported(cfg, blk)
    dtype = L.dt(cfg.param_dtype)
    d = cfg.d_model
    dims = A.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    p = {"ln1": L.rmsnorm_init(init, d, dtype)}
    p["attn"] = A.attn_init(
        init, d, dims, dtype, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm
    )
    if blk.cross_attn:
        p["lnx"] = L.rmsnorm_init(init, d, dtype)
        p["xattn"] = A.attn_init(init, d, dims, dtype, qk_norm=cfg.qk_norm)
        p["xgate"] = init.zeros((1,), dtype)  # gated cross-attn (llama-vision)
    if blk.mlp:
        p["ln2"] = L.rmsnorm_init(init, d, dtype)
        p["ffn"] = L.swiglu_init(init, cfg.d_model, cfg.d_ff, dtype)
    return p


def _cross(p, x, cfg, attend):
    """The gated cross-attention sub-block: x + tanh(xgate) * attend(h)."""
    hx = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    gx = torch.tanh(p["xgate"].float()).to(x.dtype)
    return x + gx * attend(hx)


def _ffn(p, x, cfg, blk):
    if blk.mlp:
        x = x + L.swiglu(p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x


# --------------------------------------------------------- sequence form ---


def block_seq(p, x, positions, cfg, blk, *, memory=None, want_cache=False,
              cache_len=0):
    """Full-sequence block. Returns (x, cache or None)."""
    _check_ported(cfg, blk)
    cache = None
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if want_cache:
        y, (k, v) = A.attention(
            p["attn"], h, positions, cfg, blk,
            causal=not blk.bidirectional, return_kv=True,
        )
        cache = _kv_prefill_cache(k, v, positions, cfg, blk, cache_len)
    else:
        y = A.attention(
            p["attn"], h, positions, cfg, blk, causal=not blk.bidirectional,
        )
    x = x + y
    if blk.cross_attn and memory is not None:
        x = _cross(p, x, cfg, lambda hx: A.attention(
            p["xattn"], hx, positions, cfg, blk, memory=memory))
    return _ffn(p, x, cfg, blk), cache


def _kv_prefill_cache(k, v, positions, cfg, blk, cache_len):
    """Place prefill K/V into a decode cache (ring layout for local attn)."""
    b, s = k.shape[0], k.shape[1]
    cache = A.init_cache(cfg, blk, b, cache_len, k.dtype, device=k.device)
    slots = cache["k"].shape[1]
    if s >= slots:  # keep the last `slots` positions (ring)
        k, v, positions = k[:, s - slots:], v[:, s - slots:], positions[s - slots:]
    idx = (positions % slots).long()
    cache["k"][:, idx] = k
    cache["v"][:, idx] = v
    cache["pos"][idx] = positions.to(torch.int32)
    return cache


# ------------------------------------------------------------ step form ----


def block_step(p, x, cache, pos, cfg, blk, *, memory=None):
    """One-token decode. x: (B,1,D). Returns (x, cache), the cache written
    in place (``attention_decode``)."""
    _check_ported(cfg, blk)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = A.attention_decode(p["attn"], h, cache, pos, cfg, blk)
    x = x + y
    if blk.cross_attn and memory is not None:
        x = _cross(p, x, cfg, lambda hx: A.attention_decode(
            p["xattn"], hx, None, pos, cfg, blk, memory=memory)[0])
    return _ffn(p, x, cfg, blk), cache


def block_init_cache(cfg, blk, batch: int, cache_len: int, dtype, device="cuda"):
    _check_ported(cfg, blk)
    return A.init_cache(cfg, blk, batch, cache_len, dtype, device=device)
