"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local:global attention (window 1024), RoPE theta 10k local / 1M global,
qk-norm, tied embeddings.  [hf:google/gemma-3-1b-pt family; unverified]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_LOCAL = BlockCfg(kind="attn", window=1024, rope_theta=10_000.0)
_GLOBAL = BlockCfg(kind="attn", rope_theta=1_000_000.0)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        vocab=262_144,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15_360,
        groups=(((_LOCAL,) * 5 + (_GLOBAL,), 8),),  # 48 layers = 8 x (5L+1G)
        qk_norm=True,
        tie_embeddings=True,
        logit_softcap=30.0,
        max_seq=131_072,
        family="dense",
        sub_quadratic=False,   # global layers are full attention -> skip long_500k
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        groups=(((dataclasses.replace(_LOCAL, window=8),) * 2
                 + (dataclasses.replace(_GLOBAL),), 2),),
        max_seq=128,
        q_chunk=16,
        k_chunk=16,
        remat=False,
    )
