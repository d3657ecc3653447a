"""Unified model configuration covering the 10 assigned architectures.

A model is a stack of *layer groups*; each group is a repeating *pattern* of
blocks (e.g. gemma3's 5 local + 1 global attention layers).  Within a group,
each pattern position's parameters are stacked on a leading repeat axis, as
in ``repro.models`` (which ``lax.scan``s over it); the port loops over it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One block position inside a layer-group pattern."""

    kind: str                    # attn | recurrent | mlstm | slstm
    window: int = 0              # >0: local (sliding-window) attention
    cross_attn: bool = False     # adds a cross-attention sub-block (VLM/encdec)
    moe: bool = False            # MoE FFN instead of dense FFN
    rope_theta: float = 10_000.0
    bidirectional: bool = False  # encoder self-attention (no causal mask)
    mlp: bool = True             # False: block has no FFN sub-block (xLSTM)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int = 0
    top_k: int = 2
    expert_ff: int = 0           # per-expert hidden size
    num_shared: int = 0          # always-on shared experts (deepseek)
    dense_residual_ff: int = 0   # parallel dense FFN (arctic's dense residual)
    capacity_factor: float = 1.25
    # tokens are routed within groups so the routing sort stays local to a
    # data shard instead of a replicated global sort (EXPERIMENTS.md #Perf)
    routing_groups: int = 32


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention (deepseek-v2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    # layer structure: tuple of (pattern, repeat); total layers = sum(len(p)*r)
    groups: Tuple[Tuple[Tuple[BlockCfg, ...], int], ...]
    head_dim: Optional[int] = None        # default d_model // num_heads
    qk_norm: bool = False                 # qwen3
    qkv_bias: bool = False                # qwen2.5
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq: int = 131_072
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    # recurrent blocks
    d_rnn: int = 0                        # RG-LRU width (recurrentgemma: d_model)
    conv_width: int = 4
    # encoder-decoder (seamless): encoder defined by enc_* fields
    encoder_groups: Optional[Tuple[Tuple[Tuple[BlockCfg, ...], int], ...]] = None
    enc_input_dim: int = 0                # stub frontend embedding width
    # vision stub (llama-3.2-vision): cross-attn memory width
    vision_tokens: int = 0
    vision_dim: int = 0
    # numerics / memory policy
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"      # bf16 for >=236B configs (DESIGN.md #4)
    remat: bool = True
    # remat granularity (EXPERIMENTS.md #Perf): "pattern" checkpoints the
    # whole repeat-body (min saved, max recompute peak -- all pattern blocks'
    # residuals live at once in backward); "block" checkpoints each block
    # (saves inter-block activations, peak = one block); "double" nests both.
    remat_mode: str = "block"
    flash_remat: bool = True              # recompute flash score chunks in bwd
    # absorbed-form MLA outside decode: refuted by measurement -- GSPMD
    # re-gathers the replicated 576-d latent per flash chunk, trading the
    # K/V-traffic win for a 3x collective regression (EXPERIMENTS.md #Perf
    # cell B iter 3).  Decode always uses the absorbed form (separate path).
    mla_absorbed: bool = False
    logit_softcap: float = 0.0            # gemma-style final-logit softcap
    # attention chunking (online-softmax flash form)
    q_chunk: int = 512
    k_chunk: int = 1024
    # streaming cross-entropy vocab chunk (train path; 0 = materialize logits)
    ce_chunk: int = 8192
    # architecture family tag used by shape-applicability logic
    family: str = "dense"                 # dense | moe | hybrid | ssm | audio | vlm
    sub_quadratic: bool = False           # can run long_500k decode

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_layers(self) -> int:
        total = sum(len(p) * r for p, r in self.groups)
        return total

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline math)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


def dense_stack(block: BlockCfg, layers: int):
    return (((block,), layers),)
