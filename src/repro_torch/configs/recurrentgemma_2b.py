"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  RG-LRU + local attention, pattern 2 recurrent : 1 attention
(window 2048).  [arXiv:2402.19427; hf]

26 layers = 8 x (rec, rec, attn) + (rec, rec).
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_REC = BlockCfg(kind="recurrent")
_ATT = BlockCfg(kind="attn", window=2048)


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        vocab=256_000,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        d_rnn=2560,
        conv_width=4,
        groups=(
            ((_REC, _REC, _ATT), 8),
            ((_REC, _REC), 1),
        ),
        tie_embeddings=True,
        max_seq=1_048_576,       # state is O(window): long-context capable
        family="hybrid",
        sub_quadratic=True,      # runs long_500k
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=128, d_rnn=64,
        groups=(((_REC, dataclasses.replace(_ATT, window=8)), 2),),
        max_seq=128, q_chunk=16, k_chunk=16, remat=False,
    )
