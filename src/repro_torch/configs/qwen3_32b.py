"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936.  qk_norm.  [hf:Qwen/Qwen3-8B family; hf]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_BLK = BlockCfg(kind="attn", rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        vocab=151_936,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25_600,
        groups=(((_BLK,), 64),),
        qk_norm=True,
        max_seq=131_072,
        family="dense",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, groups=(((_BLK,), 3),), max_seq=128, q_chunk=16, k_chunk=16,
        remat=False,
    )
