"""PyTorch port vs the JAX package: the model path on the CPU.

Configs field for field (all ten archs); the port's own ``init_params``
(tree, shapes, dtypes and the intended distributions); the analytic
parameter counts; the layers, ``_flash`` (against the reference's and
against ``attention_plain``); then, per attention-family arch with the
reference's weights converted through numpy, ``forward_train``,
``forward_loss``, ``prefill`` and its caches, and 8 ``decode_step``s
(teacher-forced, so both packages see the same tokens).  Reduced gemma3's
local window is 8 and the prompt 12, so its ring buffer wraps in prefill
and again in decode.  Tolerances (``model_twins.TOL``): max|diff| /
max|ref| <= 1e-5 at fp32 activations, <= 2e-2 at bf16.

The reference runs op by op there (``jax.disable_jit``): under ``jit``,
XLA's CPU fusions keep bf16 intermediates in fp32 (excess precision),
which moves the reference's bf16 logits up to 2e-2 from its own op-by-op
results; op by op the two packages differ by at most a few bf16 roundings
(a one-ulp flip where the fp32 products sum in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from model_twins import (
    ATTN_ARCHS, DECODE_STEPS, DTYPES, PROMPT, TOL, assert_close, check_abstract_params, check_decode,
    check_decode_matches_forward_train, check_forward_loss, check_forward_train, check_init_distributions,
    check_param_counts, check_prefill, twin_run,
)
from repro.models import attention as ref_A
from repro.models import layers as ref_L
from repro_torch import configs, models
from repro_torch.models import attention as A
from repro_torch.models import layers as L



# -- configs ---------------------------------------------------------------


def test_arch_registry_matches_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs._ALIASES == ref_configs._ALIASES
    for alias in list(ref_configs._ALIASES) + ["gemma3_12b", "no-such-arch"]:
        assert configs.canonical(alias) == ref_configs.canonical(alias)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_match_reference_field_for_field(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_reduced_config, ref_configs.get_reduced_config)):
        got, want = get(arch), ref_get(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.head_dim_, got.num_layers) == (want.head_dim_, want.num_layers)


# -- parameters --------------------------------------------------------------


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_abstract_params_match_reference_at_full_width(arch):
    check_abstract_params(arch)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_param_counts_match_reference(arch):
    check_param_counts(arch)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_init_params_tree_and_distributions(arch):
    check_init_distributions(arch)


def test_params_from_numpy_keeps_bfloat16_bits():
    import ml_dtypes

    a = (np.arange(12, dtype=np.float32) / 7 - 1).reshape(3, 4).astype(ml_dtypes.bfloat16)
    tree = {"x": [a, np.arange(3, dtype=np.int32)]}
    got = models.params_from_numpy(tree, "cpu")
    assert got["x"][0].dtype == torch.bfloat16 and got["x"][1].dtype == torch.int32
    np.testing.assert_array_equal(got["x"][0].view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            models.params_from_numpy(tree)


# -- layers ------------------------------------------------------------------


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("xdtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_reference(xdtype, bias):
    r = _rng(1)
    x = r.normal(size=(2, 5, 48)).astype(np.float32)
    p = {"w": r.normal(size=(48, 40)).astype(np.float32) / 7}
    if bias:
        p["b"] = r.normal(size=(40,)).astype(np.float32)
    jx = jnp.asarray(x, xdtype)
    want = ref_L.dense(jax.tree.map(jnp.asarray, p), jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, xdtype))
    got = L.dense({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    assert got.dtype == getattr(torch, xdtype)
    assert_close(got, want, TOL[xdtype], "dense")
    f32 = L.dense({k: torch.from_numpy(v) for k, v in p.items()}, tx, torch.float32)
    assert_close(f32, ref_L.dense(jax.tree.map(jnp.asarray, p), jx, jnp.float32), 1e-6, "dense fp32 out")


@pytest.mark.parametrize("xdtype", DTYPES)
def test_norms_rope_swiglu_softcap_match_reference(xdtype):
    r = _rng(2)
    tol = TOL[xdtype]
    x = r.normal(size=(2, 6, 4, 16)).astype(np.float32) * 3
    jx = jnp.asarray(x, xdtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, xdtype))
    scale = r.normal(size=(16,)).astype(np.float32)
    bias = r.normal(size=(16,)).astype(np.float32)
    assert_close(L.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6),
                 ref_L.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6), tol, "rmsnorm")
    assert_close(L.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}, tx),
                 ref_L.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx), tol, "layernorm")
    for theta in (10_000.0, 1_000_000.0):
        pos = np.arange(100, 106, dtype=np.int32)
        c, s = L.rope_cos_sin(torch.from_numpy(pos), 16, theta)
        rc, rs = ref_L.rope_cos_sin(jnp.asarray(pos), 16, theta)
        assert_close(c, rc, 1e-5, "cos")
        assert_close(s, rs, 1e-5, "sin")
        assert_close(L.apply_rope(tx, c, s), ref_L.apply_rope(jx, rc, rs), tol, "apply_rope")
        q5 = tx.reshape(2, 6, 2, 2, 16)
        assert_close(A.apply_rope_grouped(q5, c, s),
                     ref_A.apply_rope_grouped(jx.reshape(2, 6, 2, 2, 16), rc, rs), tol, "apply_rope_grouped")
    h = r.normal(size=(2, 5, 32)).astype(np.float32)
    jh = jnp.asarray(h, xdtype)
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(getattr(torch, xdtype))
    ffn = {n: {"w": r.normal(size=shape).astype(np.float32) / 5}
           for n, shape in (("wg", (32, 48)), ("wi", (32, 48)), ("wo", (48, 32)))}
    tffn = {n: {"w": torch.from_numpy(p["w"])} for n, p in ffn.items()}
    assert_close(L.swiglu(tffn, th), ref_L.swiglu(jax.tree.map(jnp.asarray, ffn), jh), tol, "swiglu")
    mlp = {"wi": {"w": ffn["wg"]["w"], "b": r.normal(size=(48,)).astype(np.float32)},
           "wo": {"w": ffn["wo"]["w"], "b": r.normal(size=(32,)).astype(np.float32)}}
    assert_close(L.gelu_mlp({n: {k: torch.from_numpy(v) for k, v in p.items()} for n, p in mlp.items()}, th),
                 ref_L.gelu_mlp(jax.tree.map(jnp.asarray, mlp), jh), tol, "gelu_mlp")
    logits = r.normal(size=(3, 50)).astype(np.float32) * 40
    for cap in (0.0, 30.0):
        assert_close(L.softcap(torch.from_numpy(logits), cap), ref_L.softcap(jnp.asarray(logits), cap), 1e-6,
                     "softcap")


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("chunk", [100, 512, 8192])  # overlap / exact / single
def test_blocked_cross_entropy_matches_reference(chunk, tied):
    r = _rng(3)
    x = r.normal(size=(2, 16, 24)).astype(np.float32)
    labels = r.integers(0, 512, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    kw = {}
    if tied:
        kw["table"] = r.normal(size=(512, 24)).astype(np.float32)
    else:
        kw["w"] = r.normal(size=(24, 512)).astype(np.float32)
        kw["bias"] = r.normal(size=(512,)).astype(np.float32)
    want = ref_L.blocked_cross_entropy(jnp.asarray(x), jnp.asarray(labels), chunk=chunk, logit_softcap=30.0,
                                       **{k: jnp.asarray(v) for k, v in kw.items()})
    got = L.blocked_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels), chunk=chunk, logit_softcap=30.0,
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    assert_close(got, want, 1e-5, "blocked CE")


def test_blocked_cross_entropy_all_masked_is_zero():
    x = torch.ones((1, 4, 8))
    loss = L.blocked_cross_entropy(x, torch.full((1, 4), -1, dtype=torch.int32), w=torch.ones((8, 20)), chunk=7)
    want = ref_L.blocked_cross_entropy(jnp.ones((1, 4, 8)), jnp.full((1, 4), -1, jnp.int32), w=jnp.ones((8, 20)),
                                       chunk=7)
    assert float(loss) == float(want) == 0.0


# -- attention ---------------------------------------------------------------

# (b, sq, sk, kvh, g, dh, dv, causal, window, q_chunk, k_chunk, qpos0): self-attention
# cases have sq == sk and positions from qpos0; cross cases arange keys
FLASH_CASES = {
    "causal": (2, 32, 32, 2, 2, 16, 16, True, 0, 16, 16, 0),
    "window": (2, 40, 40, 2, 2, 16, 16, True, 8, 16, 16, 0),
    "window_offset": (1, 24, 24, 1, 4, 8, 8, True, 5, 8, 16, 100),
    "padded": (2, 27, 27, 2, 2, 16, 16, True, 0, 16, 16, 0),
    "padded_window": (2, 21, 21, 1, 2, 16, 16, True, 6, 8, 16, 0),
    "bidirectional_padded": (2, 19, 19, 2, 2, 16, 16, False, 0, 16, 8, 0),
    "cross_padded": (2, 12, 21, 2, 2, 16, 16, False, 0, 16, 16, 0),
    "dv_differs": (1, 20, 20, 2, 2, 16, 8, True, 0, 8, 8, 0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_matches_reference_and_plain(case, dtype):
    b, sq, sk, kvh, g, dh, dv, causal, window, qc, kc, pos0 = FLASH_CASES[case]
    r = _rng(4)
    q = r.normal(size=(b, sq, kvh, g, dh)).astype(np.float32)
    k = r.normal(size=(b, sk, kvh, dh)).astype(np.float32)
    v = r.normal(size=(b, sk, kvh, dv)).astype(np.float32)
    qpos = np.arange(pos0, pos0 + sq, dtype=np.int32)
    kpos = np.arange(pos0, pos0 + sk, dtype=np.int32)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    kw = dict(causal=causal, window=window)
    want = ref_A._flash(jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos), q_chunk=qc, k_chunk=kc, **kw)
    got = A._flash(tq, tk, tv, torch.from_numpy(qpos), torch.from_numpy(kpos), q_chunk=qc, k_chunk=kc, **kw)
    assert got.shape == (b, sq, kvh, g, dv) and got.dtype == getattr(torch, dtype)
    assert_close(got, want, TOL[dtype], "flash vs reference")
    # _flash pads the keys to a multiple of the key chunk with zeros at
    # position 10**9, which only the causal mask hides: without it (the
    # encoder, cross-attention) the reference attends to the padding too,
    # so the plain version gets the keys as _flash pads them
    pad = (-sk) % min(kc, sk)
    pk, pv = (torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1) for t in (tk, tv))
    pkpos = np.concatenate([kpos, np.full(pad, 10**9, np.int32)])
    plain = A.attention_plain(tq, pk, pv, torch.from_numpy(qpos), torch.from_numpy(pkpos), **kw)
    assert_close(got, plain, TOL[dtype], "flash vs attention_plain")
    if causal or not pad:
        unpadded = A.attention_plain(tq, tk, tv, torch.from_numpy(qpos), torch.from_numpy(kpos), **kw)
        assert_close(got, unpadded, TOL[dtype], "flash vs attention_plain on the keys alone")


# -- the model, per arch -----------------------------------------------------

def _run(arch, dtype):
    return twin_run(arch, dtype)   # the reference op by op: see the module docstring


CASES = [pytest.param(a, d, id=f"{a}-{d}") for a in ATTN_ARCHS for d in DTYPES]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_train_matches_reference(arch, dtype):
    check_forward_train(_run(arch, dtype), dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_loss_matches_reference(arch, dtype):
    check_forward_loss(_run(arch, dtype), dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_logits_and_caches_match_reference(arch, dtype):
    check_prefill(_run(arch, dtype), dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_steps_match_reference(arch, dtype):
    check_decode(_run(arch, dtype), dtype)


def test_gemma_ring_wraps_in_prefill_and_decode():
    """Reduced gemma3: window 8 < prompt 12, so the local layers' caches
    hold the last 8 positions in ring order, and decode overwrites them."""
    run = _run("gemma3_12b", "float32")
    local = run["port"]["caches"][0][0]["pos"]          # pattern position 0: local, window 8
    assert local.shape == (2, 8)
    assert sorted(local[0].tolist()) == list(range(PROMPT - 8, PROMPT))
    assert [int(p) % 8 for p in local[0]] == list(range(8))
    after = run["port"]["decoded_caches"][0][0]["pos"][0]
    end = PROMPT + DECODE_STEPS
    assert sorted(after.tolist()) == list(range(end - 8, end))
    glob = run["port"]["decoded_caches"][0][2]["pos"][0]   # global: cache_len slots, all filled
    assert glob.tolist() == list(range(end))


def test_decode_matches_forward_train_at_the_last_position():
    """The reference's own bound (tests/test_archs_smoke.py): prefill on s-1
    tokens plus one decode step equals forward_train at s-1, rel < 5e-3."""
    for arch in ATTN_ARCHS:
        check_decode_matches_forward_train(arch)
