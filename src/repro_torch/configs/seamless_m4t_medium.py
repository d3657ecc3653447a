"""seamless-m4t-medium [audio]: enc-dec, 12L each, d_model=1024 16H (MHA)
d_ff=4096 vocab=256206.  The speech frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, S_frames, 1024).
[arXiv:2308.11596; hf]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, ModelConfig

_ENC = BlockCfg(kind="attn", bidirectional=True)
_DEC = BlockCfg(kind="attn", cross_attn=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        vocab=256_206,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        groups=(((_DEC,), 12),),
        encoder_groups=(((_ENC,), 12),),
        enc_input_dim=1024,
        max_seq=8192,
        family="audio",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        groups=(((_DEC,), 2),), encoder_groups=(((_ENC,), 2),),
        enc_input_dim=64, max_seq=128, q_chunk=16, k_chunk=16, remat=False,
    )
