"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  Gated cross-attention image layers every 5th layer; the vision
tower is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings (B, vision_tokens, vision_dim).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_SELF = BlockCfg(kind="attn", rope_theta=500_000.0)
_XCROSS = BlockCfg(kind="attn", cross_attn=True, rope_theta=500_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        vocab=128_256,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14_336,
        groups=(((_SELF,) * 4 + (_XCROSS,), 8),),  # 40 layers, cross every 5th
        vision_tokens=1601,       # 1 tile x (40x40 patches + cls)
        vision_dim=1280,
        max_seq=131_072,
        family="vlm",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        groups=(((_SELF, _XCROSS), 2),),
        vision_tokens=16, vision_dim=32,
        max_seq=128, q_chunk=16, k_chunk=16, remat=False,
    )
