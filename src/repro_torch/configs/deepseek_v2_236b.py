"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512)
per-expert d_ff=1536 vocab=102400, MoE 160 routed top-6 + 2 shared experts;
first layer dense (d_ff 12288).  [arXiv:2405.04434; hf]
"""
import dataclasses

from repro_torch.models.config import BlockCfg, MLACfg, MoECfg, ModelConfig

_DENSE = BlockCfg(kind="attn", moe=False)
_MOE = BlockCfg(kind="attn", moe=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        vocab=102_400,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12_288,             # the single dense layer's FFN
        groups=(
            ((_DENSE,), 1),
            ((_MOE,), 59),
        ),
        mla=MLACfg(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoECfg(num_experts=160, top_k=6, expert_ff=1536, num_shared=2),
        max_seq=131_072,
        param_dtype="bfloat16",
        opt_state_dtype="bfloat16",
        family="moe",
        sub_quadratic=False,
        # EXPERIMENTS.md #Perf cell C: larger flash chunks cut the 32k-prefill
        # memory term ~1.8x (fewer chunk-pair relayouts) and still fit HBM
        q_chunk=1024,
        k_chunk=4096,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        vocab=512, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        groups=(((_DENSE,), 1), ((_MOE,), 2)),
        mla=MLACfg(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16),
        moe=MoECfg(num_experts=8, top_k=2, expert_ff=64, num_shared=1),
        max_seq=128, q_chunk=16, k_chunk=16, remat=False,
        param_dtype="float32", opt_state_dtype="float32",
    )
