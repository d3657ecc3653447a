"""PyTorch port vs the JAX package: the gradients and the train step of
the four archs of MLA, MoE and the recurrent mixers (recurrentgemma-2b,
xlstm-125m, deepseek-v2, arctic) on the CPU.

The same checks as ``test_torch_train_grads.py`` (``model_twins``'s
``check_grads`` / ``check_train_step``: the same batch and vocab chunk,
the reference jitted once per arch): gradients within 1e-4 through the
RG-LRU doubling scan, the causal conv, the chunkwise mLSTM, the sLSTM time
loop, MLA and the MoE's sorted routing with its capacity drops; the
composed step at steps 1 and 2.
"""
import pytest

from model_twins import one_torch_thread, MLA_MOE_ARCHS, RECURRENT_ARCHS, check_grads, check_train_step  # noqa: F401

ARCHS = RECURRENT_ARCHS + MLA_MOE_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
