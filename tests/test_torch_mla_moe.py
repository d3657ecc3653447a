"""PyTorch port vs the JAX package: multi-head latent attention, the MoE
FFN and the two archs that use them (deepseek-v2-236b, arctic-480b) on the
CPU.

First each function of ``repro_torch.models.moe`` / ``mla`` against its
``repro.models`` counterpart on the same numpy inputs and the reference's
parameters: ``capacity``, ``moe_apply`` on both reduced configs and on a
top-6 config, a forced capacity drop (one routing group, a router biased
toward expert 0: assignments are dropped, and the port still equals the
reference), top-k ties (a zero router: every probability equal, so the
lower experts win in both), the load-balance loss; ``mla_attention``, its
absorbed form (against the reference's and against the decompressed form),
and chained ``mla_decode`` steps on the prefill cache.  Then per arch: the
parameter tree at full width and the analytic counts (total and
``active_only``), the port's own ``init_params``, ``forward_train`` /
``forward_loss`` / ``prefill`` / 8 chained ``decode_step``s (every step's
logits and caches) at fp32 and bf16 activations, greedy tokens, decode
against ``forward_train`` (``capacity_factor=8.0``, as the reference's
test has it), the caches written in place; and deepseek's prefill with
``mla_absorbed=True`` against the reference's and the decompressed one.

Tolerances (``model_twins.TOL``): max|diff| / max|ref| <= 1e-5 at fp32,
<= 2e-2 at bf16.  The reference runs op by op (``jax.disable_jit``) where
bf16 is compared and jitted at fp32; each arch's run is computed once
(``twin_run`` memoizes it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_twins import (
    BATCH, DECODE_STEPS, DTYPES, MLA_MOE_ARCHS, PROMPT, TOL, assert_close, assert_tree_close, check_abstract_params, check_decode,
    check_decode_matches_forward_train, check_forward_loss, check_forward_train, check_greedy_tokens,
    check_init_distributions, check_param_counts, check_prefill, make_batch, to_jax, to_torch, twin_configs,
    twin_run,
)
from repro.models import blocks as ref_B
from repro.models import mla as ref_MLA
from repro.models import model as ref_model
from repro.models import moe as ref_MOE
from repro_torch.models import blocks as B
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import params_from_numpy

CASES = [pytest.param(a, d, id=f"{a}-{d}") for a in MLA_MOE_ARCHS for d in DTYPES]


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


def _x(shape, seed, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + offset).astype(np.float32)


def _params(init, cfg):
    """Reference parameters from ``init(key, cfg, float32)``, and the port's copy."""
    p = init(jax.random.key(7), cfg, jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _moe_cfgs(arch, dtype="float32", **moe):
    ref_cfg, cfg = twin_configs(arch, dtype)
    return (dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)))


def _moe_matches(ref_cfg, cfg, x, dtype, edit=None):
    """moe_apply in both packages on the reference's parameters (edited by
    ``edit`` first); returns the port's dropped assignments."""
    rp, pp = _params(ref_MOE.moe_init, ref_cfg)
    if edit is not None:
        rp = edit(jax.tree.map(np.array, rp))
        pp = params_from_numpy(rp, "cpu")
        rp = jax.tree.map(jnp.asarray, rp)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        want = ref_MOE.moe_apply(rp, jx, ref_cfg)
    got = MOE.moe_apply(pp, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_close(got, want, TOL[dtype], "moe_apply")
    return MOE.dropped_assignments(pp, tx, cfg)


# -- MoE -------------------------------------------------------------------------


def test_capacity_and_groups_match_reference():
    for arch in MLA_MOE_ARCHS:
        for factor in (1.0, 1.25, 8.0):
            ref_cfg, cfg = _moe_cfgs(arch, capacity_factor=factor)
            for n in (1, 3, 7, 24, 48, 100, 2048):
                assert MOE.capacity(n, cfg.moe) == ref_MOE.capacity(n, ref_cfg.moe)
    m = twin_configs("deepseek_v2_236b", "float32")[1].moe
    # the reference's count: at most routing_groups, halved until it divides n
    assert [MOE.num_groups(n, m) for n in (1, 24, 48, 50, 2048)] == [1, 24, 16, 2, 32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    ref_cfg, cfg = twin_configs(arch, dtype)
    assert _moe_matches(ref_cfg, cfg, _x((2, 24, 64), 1), dtype) == 0   # 16 groups of 3: no drop


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_top6_matches_reference(dtype):
    """deepseek's top-6 routing and shared experts: each token's six
    contributions add in the reference's order (ascending expert)."""
    ref_cfg, cfg = _moe_cfgs("deepseek_v2_236b", num_experts=16, top_k=6, routing_groups=2)
    ref_cfg = dataclasses.replace(ref_cfg, activation_dtype=dtype)
    cfg = dataclasses.replace(cfg, activation_dtype=dtype)
    _moe_matches(ref_cfg, cfg, _x((2, 20, 64), 2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_drop_matches_reference(dtype):
    """One routing group of 300 tokens, every one routed first to expert 0
    (a positive offset on the inputs and on the router's expert-0 column):
    expert 0 takes 96 of its 300 assignments and drops the rest, in both
    packages alike."""
    ref_cfg, cfg = _moe_cfgs("arctic_480b", routing_groups=1)
    ref_cfg = dataclasses.replace(ref_cfg, activation_dtype=dtype)
    cfg = dataclasses.replace(cfg, activation_dtype=dtype)

    def bias(p):
        p["router"]["w"][:, 0] += 0.5
        return p

    dropped = _moe_matches(ref_cfg, cfg, _x((1, 300, 64), 3, offset=1.0), dtype, edit=bias)
    assert MOE.capacity(300, cfg.moe) == 96
    assert dropped >= 300 - 96, dropped


def test_topk_ties_break_toward_the_lower_expert():
    """A zero router gives every expert the same probability: top-k takes
    experts 0..k-1 (``jax.lax.top_k``'s order), which then overflow."""
    ref_cfg, cfg = _moe_cfgs("deepseek_v2_236b", routing_groups=1)

    def zero(p):
        p["router"]["w"][:] = 0
        return p

    dropped = _moe_matches(ref_cfg, cfg, _x((1, 40, 64), 4), "float32", edit=zero)
    cap = MOE.capacity(40, cfg.moe)
    assert dropped == 2 * (40 - cap)
    _, _, slot, keep, _ = MOE.route(torch.zeros((1, 40, 64)), torch.zeros((64, 8)), cfg.moe, cap)
    assert set((slot[keep] // cap).tolist()) == {0, 1}


def test_aux_load_balance_loss_matches_reference():
    r = np.random.default_rng(5)
    logits = r.normal(size=(30, 8)).astype(np.float32)
    eidx = r.integers(0, 8, (30, 2)).astype(np.int32)
    want = ref_MOE.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(eidx), 8)
    got = MOE.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(eidx), 8)
    assert_close(got, want, 1e-6, "aux loss")


# -- MLA ---------------------------------------------------------------------------


def _mla(dtype):
    ref_cfg, cfg = twin_configs("deepseek_v2_236b", dtype)
    rp, pp = _params(ref_MLA.mla_init, ref_cfg)
    return ref_cfg, cfg, rp, pp


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_matches_reference(dtype):
    ref_cfg, cfg, rp, pp = _mla(dtype)
    jx, tx = _pair(_x((2, 21, 64), 6), dtype)     # 21: two 16-row flash chunks, the second partial
    pos = np.arange(21, dtype=np.int32)
    with jax.disable_jit():
        want = ref_MLA.mla_attention(rp, jx, jnp.asarray(pos), ref_cfg, None)
    assert_close(MLA.mla_attention(pp, tx, torch.from_numpy(pos), cfg, None), want, TOL[dtype], "mla_attention")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_absorbed_matches_reference_and_the_decompressed_form(dtype):
    ref_cfg, cfg, rp, pp = _mla(dtype)
    jx, tx = _pair(_x((2, 21, 64), 7), dtype)
    pos = np.arange(21, dtype=np.int32)
    with jax.disable_jit():
        want = ref_MLA.mla_attention_absorbed(rp, jx, jnp.asarray(pos), ref_cfg, None)
    got = MLA.mla_attention_absorbed(pp, tx, torch.from_numpy(pos), cfg, None)
    assert_close(got, want, TOL[dtype], "absorbed")
    if dtype == "float32":   # the reference's docstring: mathematically identical
        assert_close(got, MLA.mla_attention(pp, tx, torch.from_numpy(pos), cfg, None), TOL[dtype], "decompressed")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_steps_match_reference(dtype):
    """The prefill cache of 9 positions, then 4 chained absorbed decode
    steps: every step's output and cache."""
    ref_cfg, cfg, rp, pp = _mla(dtype)
    jx, tx = _pair(_x((2, 9, 64), 8), dtype)
    pos = np.arange(9, dtype=np.int32)
    with jax.disable_jit():
        want_cache = ref_B._mla_prefill_cache(rp, jx, jnp.asarray(pos), ref_cfg, 16)
    cache = B._mla_prefill_cache(pp, tx, torch.from_numpy(pos), cfg, 16)
    assert_tree_close(cache, jax.tree.map(np.asarray, want_cache), TOL[dtype], "prefill cache")
    for i in range(4):
        jx1, tx1 = _pair(_x((2, 1, 64), 60 + i), dtype)
        with jax.disable_jit():
            want, want_cache = ref_MLA.mla_decode(rp, jx1, want_cache, jnp.int32(9 + i), ref_cfg, None)
        got, same = MLA.mla_decode(pp, tx1, cache, 9 + i, cfg, None)
        assert same is cache
        assert_close(got, want, TOL[dtype], f"step {i}")
        assert_tree_close(cache, jax.tree.map(np.asarray, want_cache), TOL[dtype], f"cache after step {i}")


def test_mla_decode_equals_the_decompressed_attention():
    """Decode at position 9 on the cache of 0..8 equals mla_attention's
    output at position 9 of the same 10 inputs."""
    _, cfg, _, pp = _mla("float32")
    x = torch.from_numpy(_x((2, 10, 64), 9))
    pos = torch.arange(10, dtype=torch.int32)
    want = MLA.mla_attention(pp, x, pos, cfg, None)[:, 9]
    cache = B._mla_prefill_cache(pp, x[:, :9], pos[:9], cfg, 12)
    got, _ = MLA.mla_decode(pp, x[:, 9:], cache, 9, cfg, None)
    assert_close(got[:, 0], want, 1e-5, "decode vs decompressed")


def test_mla_decode_past_the_cache_raises_where_the_reference_clamps():
    """The reference's ``dynamic_update_slice`` clamps a position past the
    cache to the last slot; the port raises (ROADMAP Queue C)."""
    ref_cfg, cfg, rp, pp = _mla("float32")
    x = _x((2, 1, 64), 10)
    want_cache = ref_MLA.mla_init_cache(ref_cfg, 2, 4, jnp.float32)
    _, want_cache = ref_MLA.mla_decode(rp, jnp.asarray(x), want_cache, jnp.int32(6), ref_cfg, None)
    assert np.asarray(want_cache["pos"]).tolist() == [-1, -1, -1, 6]
    cache = MLA.mla_init_cache(cfg, 2, 4, torch.float32, device="cpu")
    with pytest.raises(IndexError, match="outside the MLA cache"):
        MLA.mla_decode(pp, torch.from_numpy(x), cache, 6, cfg, None)


def test_mla_init_cache_matches_reference():
    ref_cfg, cfg = twin_configs("deepseek_v2_236b", "bfloat16")
    assert_tree_close(MLA.mla_init_cache(cfg, 3, 5, torch.bfloat16, device="cpu"),
                      jax.tree.map(np.asarray, ref_MLA.mla_init_cache(ref_cfg, 3, 5, jnp.bfloat16)), 0.0)


# -- the two archs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_abstract_params_match_reference_at_full_width(arch):
    check_abstract_params(arch)


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_param_counts_match_reference(arch):
    check_param_counts(arch)


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_init_params_tree_and_distributions(arch):
    assert {"wg", "wi", "wo"} <= check_init_distributions(arch)


def _run(arch, dtype, **overrides):
    return twin_run(arch, dtype, op_by_op=dtype == "bfloat16", **overrides)


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


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_greedy_tokens_match_reference(arch):
    check_greedy_tokens(arch)


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_decode_matches_forward_train_at_the_last_position(arch):
    cfg = twin_configs(arch, "float32")[1]
    check_decode_matches_forward_train(arch, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.mark.parametrize("arch", MLA_MOE_ARCHS)
def test_decode_writes_the_caches_in_place(arch):
    run = _run(arch, "float32")
    caches = M.tree_map(torch.clone, run["port"]["caches"])
    before = M.tree_map(torch.clone, caches)
    ptrs = [t.data_ptr() for t in M.tree_leaves(caches)]
    _, out = M.decode_step(run["port"]["params"], caches, torch.zeros(2, dtype=torch.int32), PROMPT, run["cfg"])
    assert out is caches and [t.data_ptr() for t in M.tree_leaves(out)] == ptrs
    for c, c0 in zip(M.tree_leaves(caches), M.tree_leaves(before)):
        assert not torch.equal(c, c0)
        assert torch.equal(c.flatten(0, 1)[:, PROMPT + 1:] if c.dim() > 2 else c[:, PROMPT + 1:],
                           c0.flatten(0, 1)[:, PROMPT + 1:] if c0.dim() > 2 else c0[:, PROMPT + 1:])


def test_deepseek_absorbed_prefill_matches_reference_and_decompressed():
    """``mla_absorbed=True`` routes prefill through the absorbed form (only
    there): its logits and caches equal the reference's with the same
    flag, and the decompressed prefill's within the fp32 tolerance."""
    ref_cfg, cfg = twin_configs("deepseek_v2_236b", "float32", mla_absorbed=True)
    plain = _run("deepseek_v2_236b", "float32")
    ref_params = jax.tree.map(jnp.asarray, M.tree_map(lambda t: t.numpy(), plain["port"]["params"]))
    batch = make_batch(cfg, BATCH, PROMPT, seed=3)             # twin_run's inputs
    want_logits, want_caches, _ = ref_model.prefill(ref_params, to_jax(batch), ref_cfg, PROMPT + DECODE_STEPS)
    got_logits, got_caches, _ = M.prefill(plain["port"]["params"], to_torch(batch), cfg, PROMPT + DECODE_STEPS)
    assert_close(got_logits, want_logits, TOL["float32"], "absorbed prefill logits")
    assert_tree_close(got_caches, jax.tree.map(np.asarray, want_caches), TOL["float32"], "absorbed prefill caches")
    assert_close(got_logits, plain["port"]["prefill"], TOL["float32"], "absorbed vs decompressed")
    assert_tree_close(got_caches, jax.tree.map(np.asarray, plain["ref"]["caches"]), TOL["float32"], "caches")


def test_contributions_add_in_the_reference_scatter_order(monkeypatch):
    """Each token's k bf16 contributions sum as the reference's scatter-add
    ``.at[st].add(contrib)`` sums them (its updates in sorted order,
    ascending expert), bit for bit; the reverse order would differ."""
    ref_cfg, cfg = _moe_cfgs("deepseek_v2_236b", num_experts=6, top_k=4, routing_groups=1, capacity_factor=8.0)
    m = cfg.moe
    scale = torch.tensor([1.0, 2.0 ** -8, 3 * 2.0 ** -9, 2.0 ** -7, 5 * 2.0 ** -10, 2.0 ** -9])
    # every expert's output: its own scale, so the k addends span 2^10
    monkeypatch.setattr(MOE, "_experts", lambda h, p, dtype: (scale[None, :, None, None] + 0 * h.float()).to(dtype))
    _, pp = _params(ref_MOE.moe_init, ref_cfg)
    x = torch.from_numpy(_x((1, 64, 64), 11)).bfloat16()
    cap = MOE.capacity(64, m)
    got = MOE._route_groups(x, pp, m, cap)[0]
    st, sg, slot, keep, _ = MOE.route(x, pp["router"]["w"], m, cap)
    assert bool(keep.all())
    contrib = scale.bfloat16()[slot[0] // cap] * sg[0].bfloat16()   # (n*k,) in sorted order
    contrib = contrib[:, None].expand(-1, 64)
    as_jnp = jnp.asarray(contrib.float().numpy(), jnp.bfloat16)
    with jax.disable_jit():
        want = jnp.zeros((64, 64), jnp.bfloat16).at[jnp.asarray(st[0].numpy())].add(as_jnp)
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    with jax.disable_jit():
        rev = jnp.zeros((64, 64), jnp.bfloat16).at[jnp.asarray(st[0].numpy()[::-1].copy())].add(as_jnp[::-1])
    assert not np.array_equal(np.asarray(rev.astype(jnp.float32)), np.asarray(want.astype(jnp.float32)))
