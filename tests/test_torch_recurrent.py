"""PyTorch port vs the JAX package: the recurrent mixers and the two
recurrent archs (recurrentgemma-2b, xlstm-125m) on the CPU.

First each function of ``repro_torch.models.recurrent`` against its
``repro.models.recurrent`` counterpart on the same numpy inputs and the
reference's parameters: the RG-LRU (sequence form, with and without an
initial state, and chained steps), the causal conv, the Griffin block (a
prompt shorter than the conv history too), the chunkwise mLSTM (one
partial chunk, whole chunks, a partial last chunk, a carried state) and
its steps, the sLSTM; the doubling scan against the plain recurrence.
Then per arch: the parameter tree at full width and the analytic counts,
the port's own ``init_params``, ``forward_train`` / ``forward_loss`` /
``prefill`` / 8 chained ``decode_step``s (every step's logits and states)
at fp32 and bf16 activations, greedy tokens, decode against
``forward_train``, and the states written in place.

Tolerances (``model_twins.TOL``): max|diff| / max|ref| <= 1e-5 at fp32,
<= 2e-2 at bf16.  The RG-LRU scan rounds its products in another order
than ``jax.lax.associative_scan``'s tree, which the fp32 tolerance holds.
The reference runs op by op (``jax.disable_jit``) where bf16 is compared
and jitted at fp32 (``model_twins``); each arch's run is computed once
(``twin_run`` memoizes it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_twins import (
    DTYPES, PROMPT, RECURRENT_ARCHS, TOL, assert_close, assert_tree_close, check_abstract_params, check_decode,
    check_decode_matches_forward_train, check_forward_loss, check_forward_train, check_greedy_tokens,
    check_init_distributions, check_param_counts, check_prefill, make_batch, to_jax, to_torch, twin_configs,
    twin_params, twin_run,
)
from repro.models import model as ref_model
from repro.models import recurrent as ref_R
from repro_torch import configs, models
from repro_torch.models import BlockCfg
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params_from_numpy
from repro_torch.models import recurrent as R

CASES = [pytest.param(a, d, id=f"{a}-{d}") for a in RECURRENT_ARCHS for d in DTYPES]


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _params(init, *args):
    """Reference parameters from ``init(key, *args)``, and the port's copy."""
    p = init(jax.random.key(7), *args)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _state_pair(state):
    """A reference state and the port's copy of it."""
    return state, params_from_numpy(jax.tree.map(np.asarray, state), "cpu")


# -- the doubling scan -------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_linear_scan_matches_the_plain_recurrence(s):
    r = np.random.default_rng(s)
    a = r.uniform(0.5, 1.0, (2, s, 3))
    b = r.normal(size=(2, s, 3))
    h, prod = np.zeros((2, 3)), np.ones((2, 3))
    want_h, want_a = [], []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        want_h.append(h)
        want_a.append(prod)
    got_a, got_h = R.linear_scan(torch.from_numpy(a).float(), torch.from_numpy(b).float())
    assert_close(got_h, np.stack(want_h, 1), 1e-6, "h")
    assert_close(got_a, np.stack(want_a, 1), 1e-6, "prod a")


# -- RG-LRU, conv, the Griffin block ------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_matches_reference(dtype, with_h0):
    rp, pp = _params(ref_R.rglru_init, 32, jnp.float32)
    jx, tx = _pair(_x((2, 13, 32), 1), dtype)
    h0 = _x((2, 32), 2) if with_h0 else None
    with jax.disable_jit():
        want_y, want_h = ref_R.rglru_seq(rp, jx, None if h0 is None else jnp.asarray(h0))
    got_y, got_h = R.rglru_seq(pp, tx, None if h0 is None else torch.from_numpy(h0))
    assert got_y.dtype == tx.dtype and got_h.dtype == torch.float32
    assert_close(got_y, want_y, TOL[dtype], "y")
    assert_close(got_h, want_h, TOL[dtype], "h")
    for i in range(4):   # chained steps from the sequence's state
        jx1, tx1 = _pair(_x((2, 1, 32), 10 + i), dtype)
        want_y, want_h = ref_R.rglru_step(rp, jx1, want_h)
        got_y, got_h = R.rglru_step(pp, tx1, got_h)
        assert_close(got_y, want_y, TOL[dtype], f"step {i} y")
        assert_close(got_h, want_h, TOL[dtype], f"step {i} h")


def test_rglru_steps_equal_the_sequence_form():
    _, pp = _params(ref_R.rglru_init, 16, jnp.float32)
    x = torch.from_numpy(_x((2, 11, 16), 3))
    y, h_last = R.rglru_seq(pp, x)
    h = torch.zeros((2, 16))
    for t in range(11):
        yt, h = R.rglru_step(pp, x[:, t:t + 1], h)
        assert_close(yt[:, 0], y[:, t], 1e-5, f"step {t}")
    assert_close(h, h_last, 1e-5, "h_last")


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_matches_reference(dtype):
    rp, pp = _params(ref_R.conv1d_init, 4, 24, jnp.float32)
    jx, tx = _pair(_x((2, 9, 24), 4), dtype)
    assert_close(R.conv1d_seq(pp, tx), ref_R.conv1d_seq(rp, jx), TOL[dtype], "conv1d_seq")
    jh, th = jx[:, -3:], tx[:, -3:]
    for i in range(4):
        jx1, tx1 = _pair(_x((2, 1, 24), 20 + i), dtype)
        want_y, jh = ref_R.conv1d_step(rp, jx1, jh)
        got_y, th = R.conv1d_step(pp, tx1, th)
        assert_close(got_y, want_y, TOL[dtype], f"step {i} y")
        assert_close(th, jh, 0.0, f"step {i} history")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_recurrent_block_matches_reference(dtype, s):
    """Prompts of 1 and 2 tokens keep a conv history shorter than
    conv_width - 1, in both packages; the step then fails in both."""
    rp, pp = _params(ref_R.recurrent_block_init, 48, 32, 4, jnp.float32)
    jx, tx = _pair(_x((2, s, 48), 5), dtype)
    with jax.disable_jit():
        want_y, want_state = ref_R.recurrent_block_seq(rp, jx)
    got_y, got_state = R.recurrent_block_seq(pp, tx)
    assert_close(got_y, want_y, TOL[dtype], "y")
    assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], "state")
    assert got_state["conv"].shape == (2, min(s, 3), 32)
    jx1, tx1 = _pair(_x((2, 1, 48), 6), dtype)
    if s < 3:
        with pytest.raises((ValueError, TypeError)):
            ref_R.recurrent_block_step(rp, jx1, want_state)
        with pytest.raises(RuntimeError):
            R.recurrent_block_step(pp, tx1, got_state)
        return
    for i in range(4):
        jx1, tx1 = _pair(_x((2, 1, 48), 30 + i), dtype)
        want_y, want_state = ref_R.recurrent_block_step(rp, jx1, want_state)
        got_y, got_state = R.recurrent_block_step(pp, tx1, got_state)
        assert_close(got_y, want_y, TOL[dtype], f"step {i} y")
        assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], f"step {i} state")


def test_recurrent_block_init_state_matches_reference():
    want = ref_R.recurrent_block_init_state(3, 16, 4, jnp.bfloat16)
    assert_tree_close(R.recurrent_block_init_state(3, 16, 4, torch.bfloat16, device="cpu"),
                      jax.tree.map(np.asarray, want), 0.0)


# -- mLSTM, sLSTM --------------------------------------------------------------

MLSTM_CASES = {            # (S, chunk, carried state)
    "one_partial_chunk": (5, 8, False),
    "whole_chunks": (16, 8, False),
    "partial_last_chunk": (21, 8, False),
    "carried_state": (21, 8, True),
}


def _mlstm_params():
    return _params(ref_R.mlstm_init, 32, 2, 64, jnp.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MLSTM_CASES))
def test_mlstm_seq_matches_reference(dtype, case):
    s, chunk, carried = MLSTM_CASES[case]
    rp, pp = _mlstm_params()
    jx, tx = _pair(_x((2, s, 32), 8), dtype)
    with jax.disable_jit():
        state = None
        if carried:
            jx0, _ = _pair(_x((2, 6, 32), 9), dtype)
            state = ref_R.mlstm_seq(rp, jx0, 2, chunk=chunk)[1]
        want_y, want_state = ref_R.mlstm_seq(rp, jx, 2, state, chunk=chunk)
    port_state = None if state is None else _state_pair(state)[1]
    got_y, got_state = R.mlstm_seq(pp, tx, 2, port_state, chunk=chunk)
    assert got_y.dtype == tx.dtype
    assert_close(got_y, want_y, TOL[dtype], "y")
    assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_steps_match_reference(dtype):
    rp, pp = _mlstm_params()
    jx, tx = _pair(_x((2, 9, 32), 11), dtype)
    with jax.disable_jit():
        want_state = ref_R.mlstm_seq(rp, jx, 2, chunk=4)[1]
    got_state = R.mlstm_seq(pp, tx, 2, chunk=4)[1]
    for i in range(4):
        jx1, tx1 = _pair(_x((2, 1, 32), 40 + i), dtype)
        want_y, want_state = ref_R.mlstm_step(rp, jx1, want_state, 2)
        got_y, got_state = R.mlstm_step(pp, tx1, got_state, 2)
        assert_close(got_y, want_y, TOL[dtype], f"step {i} y")
        assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], f"step {i} state")


def test_mlstm_steps_equal_the_chunkwise_form():
    """The reference's claim for its chunkwise form: the same outputs and
    state as the recurrent steps, here on the port."""
    _, pp = _mlstm_params()
    x = torch.from_numpy(_x((2, 13, 32), 12))
    y, final = R.mlstm_seq(pp, x, 2, chunk=4)
    state = R.mlstm_init_state(2, 2, 32, device="cpu")
    for t in range(13):
        yt, state = R.mlstm_step(pp, x[:, t:t + 1], state, 2)
        assert_close(yt[:, 0], y[:, t], 1e-4, f"step {t}")
    for name in ("C", "n"):   # stored descaled by exp(m): compare exp(m)-scaled
        assert_close(state[name] * torch.exp(state["m"]).reshape(2, 2, *[1] * (state[name].dim() - 2)),
                     final[name] * torch.exp(final["m"]).reshape(2, 2, *[1] * (final[name].dim() - 2)), 1e-4, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_matches_reference(dtype):
    rp, pp = _params(ref_R.slstm_init, 32, 2, jnp.float32)
    jx, tx = _pair(_x((2, 7, 32), 13), dtype)
    with jax.disable_jit():
        want_y, want_state = ref_R.slstm_seq(rp, jx, 2)
    got_y, got_state = R.slstm_seq(pp, tx, 2)
    assert_close(got_y, want_y, TOL[dtype], "y")
    assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], "state")
    for i in range(4):
        jx1, tx1 = _pair(_x((2, 1, 32), 50 + i), dtype)
        with jax.disable_jit():
            want_y, want_state = ref_R.slstm_step(rp, jx1, want_state, 2)
        got_y, got_state = R.slstm_step(pp, tx1, got_state, 2)
        assert_close(got_y, want_y, TOL[dtype], f"step {i} y")
        assert_tree_close(got_state, jax.tree.map(np.asarray, want_state), TOL[dtype], f"step {i} state")


def test_xlstm_init_states_match_reference():
    assert_tree_close(R.mlstm_init_state(2, 4, 8, device="cpu"),
                      jax.tree.map(np.asarray, ref_R.mlstm_init_state(2, 4, 8)), 0.0)
    assert_tree_close(R.slstm_init_state(2, 4, 8, device="cpu"),
                      jax.tree.map(np.asarray, ref_R.slstm_init_state(2, 4, 8)), 0.0)


# -- the two archs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_abstract_params_match_reference_at_full_width(arch):
    check_abstract_params(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_param_counts_match_reference(arch):
    check_param_counts(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_init_params_tree_and_distributions(arch):
    seen = check_init_distributions(arch)
    assert {"recurrentgemma_2b": {"lam", "b"}, "xlstm_125m": {"r", "b"}}[arch] <= seen


def _run(arch, dtype):
    return twin_run(arch, dtype, op_by_op=dtype == "bfloat16")


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


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_greedy_tokens_match_reference(arch):
    check_greedy_tokens(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_decode_matches_forward_train_at_the_last_position(arch):
    check_decode_matches_forward_train(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_decode_writes_the_states_in_place(arch):
    """``decode_step`` returns the caches it was given, each leaf the same
    storage, and every recurrent state moved."""
    run = _run(arch, "float32")
    cfg = run["cfg"]
    caches = M.tree_map(torch.clone, run["port"]["caches"])
    before = M.tree_map(torch.clone, caches)
    ptrs = [t.data_ptr() for t in M.tree_leaves(caches)]
    _, out = models.decode_step(run["port"]["params"], caches, torch.zeros(2, dtype=torch.int32), PROMPT, cfg)
    assert out is caches and [t.data_ptr() for t in M.tree_leaves(out)] == ptrs
    kinds = set()
    for (pattern, _), gc, gc0 in zip(cfg.groups, caches, before):
        for blk, c, c0 in zip(pattern, gc, gc0):
            if blk.kind != "attn":
                kinds.add(blk.kind)
                for name in c:
                    assert not torch.equal(c[name], c0[name]), (blk.kind, name)
    assert kinds == {"recurrentgemma_2b": {"recurrent"}, "xlstm_125m": {"mlstm", "slstm"}}[arch]


def test_recurrentgemma_short_prompt_keeps_a_short_conv_history():
    """A 2-token prompt: the conv history is 2 rows (conv_width - 1 = 3),
    the reference's ``b1[:, -(w-1):]``; prefill equals the reference and
    decode fails in both packages."""
    ref_cfg, cfg = twin_configs("recurrentgemma_2b", "float32")
    ref_params, params = twin_params(ref_cfg, seed=1)
    batch = make_batch(cfg, 2, 2, seed=3)
    want_logits, want_caches, _ = ref_model.prefill(ref_params, to_jax(batch), ref_cfg, 8)
    got_logits, got_caches, _ = models.prefill(params, to_torch(batch), cfg, 8)
    assert_close(got_logits, want_logits, TOL["float32"], "prefill logits")
    assert_tree_close(got_caches, jax.tree.map(np.asarray, want_caches), TOL["float32"], "caches")
    assert got_caches[0][0]["conv"].shape == (2, 2, 2, cfg.d_rnn)
    tok = np.zeros(2, np.int32)
    with pytest.raises((ValueError, TypeError)):
        ref_model.decode_step(ref_params, want_caches, jnp.asarray(tok), jnp.int32(2), ref_cfg)
    with pytest.raises(RuntimeError):
        models.decode_step(params, got_caches, torch.from_numpy(tok), 2, cfg)


def test_unknown_block_kind_raises():
    cfg = configs.get_reduced_config("xlstm_125m")
    blk = BlockCfg(kind="conv")
    x = torch.zeros((1, 3, cfg.d_model))
    pos = torch.arange(3, dtype=torch.int32)
    for call in (lambda: B.block_init(L.Init(torch.Generator(), "cpu"), cfg, blk),
                 lambda: B.block_seq({"ln1": {"scale": torch.ones(cfg.d_model)}}, x, pos, cfg, blk),
                 lambda: B.block_step({"ln1": {"scale": torch.ones(cfg.d_model)}}, x[:, :1], {}, 3, cfg, blk),
                 lambda: B.block_init_cache(cfg, blk, 1, 8, torch.float32, device="cpu")):
        with pytest.raises(ValueError, match="unknown block kind conv"):
            call()
