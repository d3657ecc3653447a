"""PyTorch port vs the JAX package: flash attention (K5) and its oracle.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version
(the CUDA kernel is held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here it is compared
with ``repro.kernels.flash_attention.flash_attention`` in interpret mode, as
``tests/test_flash_kernel.py`` runs it, and with ``repro.kernels.ref``'s
dense oracle, on the same numpy inputs.  Tolerances are the JAX tests' own:
2e-5 in f32, 2e-2 in bf16 (one bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as port_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(bh, sq, sk, dh, dv, dtype="float32", seed=0):
    """numpy inputs, and the same values as torch and jax arrays of ``dtype``
    (both sides round the f32 values to bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((bh, sq, dh), (bh, sk, dh), (bh, sk, dv))]
    port = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jax_ = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return port, jax_


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,qc,kc", [(64, 64, 16, 16), (128, 128, 32, 64), (64, 128, 64, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel_and_oracle(sq, sk, qc, kc, causal):
    # causal with sq != sk included: both sides align top-left (cols <= rows)
    (q, k, v), (jq, jk, jv) = _qkv(4, sq, sk, 32, 32)
    got = fa.flash_attention(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc)
    assert got.shape == (4, sq, 32) and got.dtype == torch.float32
    _close(got, ref_flash.flash_attention(jq, jk, jv, causal=causal, q_chunk=qc, k_chunk=kc), "float32")
    _close(got, ref_ref.ref_attention(jq, jk, jv, causal=causal), "float32")


@pytest.mark.parametrize(
    "bh,sq,sk,dh,dv,qc,kc,dtype,scale",
    [
        (2, 64, 64, 48, 16, 32, 32, "float32", None),    # MLA-shaped: dv != dh
        (2, 64, 64, 32, 32, 32, 32, "bfloat16", None),
        (2, 32, 32, 24, 24, 16, 16, "float32", 0.125),   # custom scale
        (3, 96, 32, 16, 40, 32, 16, "float32", None),    # causal, sq > sk
        (2, 48, 80, 64, 64, 16, 16, "bfloat16", 0.125),  # causal, sq < sk
    ],
)
def test_flash_shapes_types_and_scale(bh, sq, sk, dh, dv, qc, kc, dtype, scale):
    (q, k, v), (jq, jk, jv) = _qkv(bh, sq, sk, dh, dv, dtype, seed=dh + dv)
    got = fa.flash_attention(q, k, v, causal=True, q_chunk=qc, k_chunk=kc, scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (bh, sq, dv)
    want = ref_flash.flash_attention(jq, jk, jv, causal=True, q_chunk=qc, k_chunk=kc, scale=scale)
    _close(got, want, dtype)
    _close(got, ref_ref.ref_attention(jq, jk, jv, causal=True, scale=scale), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,scale", [("float32", None), ("float32", 0.125), ("bfloat16", None)])
def test_ref_attention_matches_jax(causal, dtype, scale):
    (q, k, v), (jq, jk, jv) = _qkv(3, 40, 56, 24, 8, dtype, seed=7)
    got = port_ref.ref_attention(q, k, v, causal=causal, scale=scale)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref_ref.ref_attention(jq, jk, jv, causal=causal, scale=scale), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_does_not_depend_on_chunks(causal):
    (q, k, v), _ = _qkv(2, 96, 96, 32, 16, seed=11)
    want = port_ref.ref_attention(q, k, v, causal=causal)
    for qc, kc in [(96, 96), (32, 32), (16, 48), (48, 16), (512, 512)]:
        got = fa.flash_attention_plain(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc)
        _close(got, want.numpy(), "float32")


@pytest.mark.parametrize("sq,sk,qc,kc", [(48, 64, 32, 32), (64, 48, 32, 32), (64, 64, 24, 64)])
def test_lengths_that_do_not_divide_raise_as_in_jax(sq, sk, qc, kc):
    (q, k, v), (jq, jk, jv) = _qkv(1, sq, sk, 8, 8)
    with pytest.raises(ValueError) as jax_err:
        ref_flash.flash_attention(jq, jk, jv, q_chunk=qc, k_chunk=kc)
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        with pytest.raises(ValueError) as port_err:
            fn(q, k, v, q_chunk=qc, k_chunk=kc)
        assert str(port_err.value) == str(jax_err.value)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    (q, k, v), _ = _qkv(2, 32, 32, 16, 16, seed=3)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, q_chunk=16, k_chunk=16)
    assert fa.LAUNCHES["flash_attention"] == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, q_chunk=16, k_chunk=16))


def test_mismatched_shapes_raise():
    (q, k, v), _ = _qkv(2, 32, 32, 16, 16)
    for args in ((q[0], k, v), (q, k[:1], v), (q, k[..., :8], v), (q, k, v[:, :16])):
        with pytest.raises(ValueError, match="3-D|shapes do not match"):
            fa.flash_attention(*args)
