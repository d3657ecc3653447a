"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), PyTorch port
of ``repro.models.mla``.

Training/prefill uses the decompressed form (or, behind ``mla_absorbed``,
the absorbed one); decode uses the *absorbed* form: the KV up-projection is
folded into the query/output paths so the cache holds only the latent c_kv
plus the decoupled RoPE key.  RoPE here has the reference's fixed theta of
10,000, not ``cfg.rope_theta``.  ``mla_decode`` writes slot ``pos`` of the
cache in place and returns the same dict (the reference returns a new
cache, and its ``dynamic_update_slice`` clamps a ``pos`` past the cache's
end to the last slot, where the port raises).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import NEG_INF, _flash, _local, on_head_shards

ROPE_THETA = 10_000.0


def mla_init(init: L.Init, cfg, dtype):
    m = cfg.mla
    d = cfg.d_model
    h = cfg.num_heads
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": L.dense_init(init, d, m.q_lora_rank, dtype),
        "qnorm": L.rmsnorm_init(init, m.q_lora_rank, dtype),
        "wuq": L.dense_init(init, m.q_lora_rank, h * dqk, dtype),
        "wdkv": L.dense_init(init, d, m.kv_lora_rank, dtype),
        "kvnorm": L.rmsnorm_init(init, m.kv_lora_rank, dtype),
        "wukv": L.dense_init(init, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wkr": L.dense_init(init, d, m.qk_rope_head_dim, dtype),
        "wo": L.dense_init(init, h * m.v_head_dim, d, dtype),
    }


def _project_q(p, x, cfg, positions):
    m = cfg.mla
    h = cfg.num_heads
    b, s, _ = x.shape
    cq = L.rmsnorm(p["qnorm"], L.dense(p["wdq"], x), cfg.norm_eps)
    q = L.split_last(L.dense(p["wuq"], cq), h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    qn, qr = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = L.rope_cos_sin(positions, m.qk_rope_head_dim, ROPE_THETA)
    return qn, L.apply_rope(qr, cos, sin)


def latent_kv(p, x, positions, cfg):
    """The cached latent c_kv (B,S,r_kv) and the single-head RoPE key (B,S,dr)."""
    ckv = L.rmsnorm(p["kvnorm"], L.dense(p["wdkv"], x), cfg.norm_eps)
    kr = L.dense(p["wkr"], x)
    cos, sin = L.rope_cos_sin(positions, cfg.mla.qk_rope_head_dim, ROPE_THETA)
    return ckv, L.apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0]


def _split_wukv(p, cfg):
    """wukv as (r, H, dn) for keys and (r, H, dv) for values."""
    m = cfg.mla
    wukv = L.split_last(p["wukv"]["w"], cfg.num_heads, m.qk_nope_head_dim + m.v_head_dim)
    return wukv[..., : m.qk_nope_head_dim], wukv[..., m.qk_nope_head_dim:]


def _scale(m):
    return 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_attention(p, x, positions, cfg, block):
    """Train/prefill (decompressed) MLA. x: (B, S, D) -> (B, S, D)."""
    m = cfg.mla
    h = cfg.num_heads
    b, s, _ = x.shape
    qn, qr = _project_q(p, x, cfg, positions)
    ckv, kr = latent_kv(p, x, positions, cfg)
    kv = L.split_last(L.dense(p["wukv"], ckv), h, m.qk_nope_head_dim + m.v_head_dim)
    kn, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]

    q = torch.cat([qn, qr], dim=-1)[:, :, :, None, :]                   # (B,S,H,1,dqk)
    k = torch.cat([kn, kr[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)], dim=-1)   # (B,S,H,dqk)
    pos = _local(positions)
    out = on_head_shards(lambda q_, k_, v_, qpos_: _flash(
        q_, k_, v_, qpos_, pos,
        causal=True, window=0, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
        remat_kv=cfg.flash_remat,
    ), q, k, v, pos)                                                    # (B,S,H*dv)
    return L.dense(p["wo"], out)


def mla_attention_absorbed(p, x, positions, cfg, block):
    """Absorbed-form MLA for train/prefill: the KV up-projection is folded
    into the query/output paths, so attention runs MQA-style against the
    shared (kv_lora + rope)-dim latent.  Mathematically identical to
    ``mla_attention``."""
    m = cfg.mla
    h = cfg.num_heads
    b, s, _ = x.shape
    qn, qr = _project_q(p, x, cfg, positions)                  # (B,S,H,dn/dr)
    ckv, kr = latent_kv(p, x, positions, cfg)
    wuk, wuv = _split_wukv(p, cfg)

    q_eff = torch.einsum("bshd,rhd->bshr", qn.float(), wuk.float()).to(x.dtype)
    q_cat = torch.cat([q_eff, qr], dim=-1)                     # (B,S,H,r+dr)
    k_cat = torch.cat([ckv, kr], dim=-1)[:, :, None, :]        # (B,S,1,r+dr)
    v_lat = ckv[:, :, None, :]                                  # (B,S,1,r)

    out = _flash(
        q_cat.reshape(b, s, 1, h, m.kv_lora_rank + m.qk_rope_head_dim),
        k_cat, v_lat, positions, positions,
        causal=True, window=0, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
        remat_kv=cfg.flash_remat, scale=_scale(m),
    )                                                           # (B,S,1,H,r)
    y = torch.einsum("bshr,rhd->bshd", out[:, :, 0].float(), wuv.float()).to(x.dtype)
    return L.dense(p["wo"], L.merge_last(y, 2))


def mla_init_cache(cfg, batch: int, cache_len: int, dtype, device="cuda"):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((batch, cache_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }


def mla_decode(p, x, cache, pos, cfg, block):
    """Absorbed-form decode. x: (B, 1, D); cache holds (c_kv, k_rope),
    written at slot ``pos`` in place.  Returns (out (B, 1, D), cache)."""
    m = cfg.mla
    h = cfg.num_heads
    b = x.shape[0]
    pos = int(pos)
    ckv, kr, cpos = cache["ckv"], cache["kr"], cache["pos"]
    if not 0 <= pos < ckv.shape[1]:
        raise IndexError(f"decode position {pos} outside the MLA cache's {ckv.shape[1]} slots")
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)

    qn, qr = _project_q(p, x, cfg, posv)                                 # (B,1,H,*)
    ckv1, kr1 = latent_kv(p, x, posv, cfg)                               # (B,1,r), (B,1,dr)
    ckv[:, pos] = ckv1[:, 0].to(ckv.dtype)
    kr[:, pos] = kr1[:, 0].to(kr.dtype)
    cpos[pos].fill_(pos)   # a fill, not a copy from a host scalar (which would wait for the card)

    wuk, wuv = _split_wukv(p, cfg)                                       # (r,H,dn), (r,H,dv)
    # absorb K up-projection into q: q_eff (B, H, r)
    q_eff = torch.einsum("bhd,rhd->bhr", qn[:, 0].float(), wuk.float())
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, ckv.float())
    s_rope = torch.einsum("bhd,bsd->bhs", qr[:, 0].float(), kr.float())
    s = (s_lat + s_rope) * float(_scale(m))
    valid = (cpos >= 0) & (cpos <= pos)
    s = s.masked_fill(~valid[None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)

    o_lat = torch.einsum("bhs,bsr->bhr", w, ckv.float())
    out = L.merge_last(torch.einsum("bhr,rhd->bhd", o_lat, wuv.float()), 2).reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return L.dense(p["wo"], out), cache
