"""PyTorch port vs the JAX package: flash attention (K5) and its oracle.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version
(the CUDA kernel is held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here it is compared
with ``repro.kernels.flash_attention.flash_attention`` in interpret mode, as
``tests/test_flash_kernel.py`` runs it, and with ``repro.kernels.ref``'s
dense oracle, on the same numpy inputs.  Tolerances are the JAX tests' own:
2e-5 in f32, 2e-2 in bf16 (one bf16 rounding of the output).

It also checks the choice of kernel (``_route``) and that ``chip_smoke.py``'s
full-width limit has the power the tensor-core kernel's design rests on:
an emulation of that kernel's arithmetic passes it with P carried as bf16
hi + lo and fails it with P rounded to bf16.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as port_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ATTN_FULL_TOL  # noqa: E402

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
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, q_chunk=16, k_chunk=16)
    assert fa.LAUNCHES == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, q_chunk=16, k_chunk=16))


def test_mismatched_shapes_raise():
    (q, k, v), _ = _qkv(2, 32, 32, 16, 16)
    for args in ((q[0], k, v), (q, k[:1], v), (q, k[..., :8], v), (q, k, v[:, :16])):
        with pytest.raises(ValueError, match="3-D|shapes do not match"):
            fa.flash_attention(*args)


@pytest.mark.parametrize(
    "device,dtype,dh,dv,route",
    [
        ("cpu", torch.bfloat16, 128, 128, "plain"),
        ("cpu", torch.float32, 128, 128, "plain"),
        ("meta", torch.bfloat16, 128, 128, "wgmma"),      # qwen3-32b
        ("meta", torch.bfloat16, 192, 128, "wgmma"),      # deepseek-v2 MLA
        ("meta", torch.bfloat16, 8, 256, "wgmma"),        # the domain's edges
        ("meta", torch.float32, 128, 128, "cuda_core"),   # f32 is held to 2e-5
        ("meta", torch.bfloat16, 20, 12, "cuda_core"),    # rows not 16-byte multiples
        ("meta", torch.bfloat16, 128, 36, "cuda_core"),
        ("meta", torch.bfloat16, 264, 64, "cuda_core"),   # dh above 256
    ],
)
def test_route_reads_device_dtype_and_widths(device, dtype, dh, dv, route):
    # "meta" stands in for a CUDA device here: _route reads no data
    q = torch.empty((2, 64, dh), dtype=dtype, device=device)
    v = torch.empty((2, 64, dv), dtype=dtype, device=device)
    assert fa._route(q, v) == route
    if route != "plain":
        assert fa.ROUTE_KERNEL[route] in fa.LAUNCHES


def _emulate_wgmma_kernel(q, k, v, *, p_hi_lo, bk=128):
    """The tensor-core kernel's arithmetic in plain PyTorch (causal): bf16
    inputs, f32 sums, an online softmax over ``bk``-key tiles in log2 units
    (``exp2`` with ``scale * log2(e)`` folded into one multiply), masked
    scores -1e30, ``l`` summed from the f32 p, and P entering P V as bf16
    hi + lo (``p_hi_lo``) or rounded to bf16."""
    bh, sq, dh = q.shape
    sk, dv = v.shape[1], v.shape[2]
    scale_log2 = torch.tensor(dh ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), fa.NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, dv))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        s = torch.bmm(qf, kf[:, k0:k0 + bk].transpose(1, 2)) * scale_log2
        s = torch.where(k0 + torch.arange(s.shape[2])[None, :] <= rows, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(2, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(2, keepdim=True)
        hi = p.bfloat16().float()
        pv = torch.bmm(hi, vf[:, k0:k0 + bk])
        if p_hi_lo:
            pv = pv + torch.bmm((p - hi).bfloat16().float(), vf[:, k0:k0 + bk])
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-37)).to(q.dtype)


@pytest.mark.parametrize("p_hi_lo,passes", [(True, True), (False, False)], ids=["p_hi_lo", "p_bf16"])
def test_full_width_limit_tells_p_hi_lo_from_p_bf16(p_hi_lo, passes):
    # few-key rows of a causal bf16 head: bf16's 2^-9 relative error on p is
    # large against a small |o| there; hi + lo carries ~16 bits of p
    (q, k, v), _ = _qkv(2, 512, 512, 64, 64, "bfloat16", seed=0)
    want = fa.flash_attention_plain(q, k, v, causal=True).float()
    got = _emulate_wgmma_kernel(q, k, v, p_hi_lo=p_hi_lo).float()
    rtol, atol = ATTN_FULL_TOL
    worst = float(((got - want).abs() / (rtol * want.abs() + atol)).max())
    assert (worst <= 1.0) == passes, worst
