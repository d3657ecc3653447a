"""The model serving path's models, PyTorch port of ``repro.models``: the
attention-family architectures (GQA / MHA, local windows, qk-norm, qkv
bias, tied embeddings, logit softcap, a bidirectional encoder and gated
cross-attention).  MLA, MoE and the recurrent blocks are ROADMAP item 13b.
"""
from repro_torch.models.config import BlockCfg, MLACfg, MoECfg, ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    abstract_params,
    count_params_analytic,
    decode_step,
    forward_loss,
    forward_train,
    init_caches,
    init_params,
    params_from_numpy,
    prefill,
)
