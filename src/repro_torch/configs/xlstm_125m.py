"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks; we use the xLSTM[3:1] layout (3 mLSTM : 1 sLSTM,
pattern of 4 repeated 3x).  d_ff=0: blocks carry their own up-projection
(mLSTM inner dim 2*d_model), no separate FFN.  [arXiv:2405.04517; unverified]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_M = BlockCfg(kind="mlstm", mlp=False)
_S = BlockCfg(kind="slstm", mlp=False)


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        vocab=50_304,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        groups=(((_M, _M, _M, _S), 3),),  # 12 layers
        tie_embeddings=True,
        max_seq=1_048_576,                # recurrent state: long-context capable
        family="ssm",
        sub_quadratic=True,               # runs long_500k
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=2, num_kv_heads=2,
        groups=(((_M, _S), 2),),
        max_seq=128, q_chunk=16, k_chunk=16, remat=False,
    )
