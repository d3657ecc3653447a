"""The model serving path's models, PyTorch port of ``repro.models``: all
ten architectures of ``repro_torch.configs`` (GQA / MHA, local windows,
qk-norm, qkv bias, tied embeddings, logit softcap, a bidirectional encoder,
gated cross-attention, multi-head latent attention, the MoE FFN, and the
RG-LRU, mLSTM and sLSTM mixers).
"""
from repro_torch.models import mla, moe, recurrent  # noqa: F401
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
