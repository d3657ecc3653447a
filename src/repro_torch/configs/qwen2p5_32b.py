"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B family; hf]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_BLK = BlockCfg(kind="attn", rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        vocab=152_064,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27_648,
        groups=(((_BLK,), 64),),
        qkv_bias=True,
        max_seq=131_072,
        family="dense",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        groups=(((_BLK,), 3),), max_seq=128, q_chunk=16, k_chunk=16,
        remat=False,
    )
