"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP per layer (dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base; hf]

bf16 optimizer state: 480B params x 14B/param of fp32 AdamW would exceed a
256-chip v5e pod's 4 TB HBM; bf16 m/v + bf16 params (6 B/param) fits
(DESIGN.md #4).
"""
import dataclasses

from repro_torch.models.config import BlockCfg, MoECfg, ModelConfig

_BLK = BlockCfg(kind="attn", moe=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        vocab=32_000,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,               # dense residual path
        groups=(((_BLK,), 35),),
        moe=MoECfg(
            num_experts=128,
            top_k=2,
            expert_ff=4864,
            dense_residual_ff=4864,
        ),
        max_seq=131_072,
        param_dtype="bfloat16",
        opt_state_dtype="bfloat16",
        family="moe",
        sub_quadratic=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, groups=(((_BLK,), 2),),
        moe=MoECfg(num_experts=8, top_k=2, expert_ff=96, dense_residual_ff=96),
        max_seq=128, q_chunk=16, k_chunk=16, remat=False,
        param_dtype="float32", opt_state_dtype="float32",
    )
