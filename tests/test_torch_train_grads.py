"""PyTorch port vs the JAX package: the gradients and the train step of
the six attention-family archs (gemma3, phi3, qwen3, qwen2.5, seamless-m4t,
llama-3.2-vision) on the CPU.

Each arch's reduced config at fp32 activations, on the reference's weights
(``params_from_numpy``) and one numpy batch of 2 x 40 tokens with a vocab
chunk of 200, so ``_flash`` walks three query and key chunks and the
streaming CE three vocab chunks, the last overlapping.  The reference runs
jitted (``model_twins.train_twin``; one compile per arch).

- Gradients (``train.steps.loss_and_grads`` against
  ``jax.value_and_grad(forward_loss)``): loss within 1e-5, every leaf of
  the same tree with the same dtype within 1e-4 (max|diff| / max|ref|).
- The composed step (``make_train_step``): loss, ``grad_norm`` and ``lr``
  within 1e-5, updated params within atol 2 lr (at step 1 AdamW moves a
  weight by about lr g / |g|, so a near-zero gradient of another sign moves
  it by 2 lr), m and v within 1e-4, step ``==``; at step 1 from
  ``adamw_init`` and at step 2 from the reference's state after its step 1.
"""
import pytest

from model_twins import one_torch_thread, ATTN_ARCHS, check_grads, check_train_step  # noqa: F401


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
