"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32, MHA) d_ff=8192
vocab=32064.  RoPE SwiGLU.  [arXiv:2404.14219; unverified]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_BLK = BlockCfg(kind="attn")


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        vocab=32_064,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        groups=(((_BLK,), 32),),
        max_seq=131_072,
        family="dense",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        groups=(((_BLK,), 3),), max_seq=128, q_chunk=16, k_chunk=16,
        remat=False,
    )
