"""PyTorch port vs the JAX package on the CPU: the optimizer, the
checkpoint, the two rematerialized backwards and ``launch/train``.

- ``train/optimizer.py``: ``schedule`` at warmup, decay and the floor;
  ``adamw_update`` on the reference's own gradients (phi3's reduced
  config, jitted ``jax.grad``) at fp32 and bf16 state, two steps: params,
  m, v, ``grad_norm`` and ``lr`` within 1e-6 (max|diff| / max|ref|), step
  ``==``; the clipping and hand-computed cases of ``tests/test_train.py``;
  the update is in place (the reference's is functional: Queue C).
- ``train/checkpoint.py``: saved in either package and restored in the
  other, leaf for leaf ``==``; the same file names, bytes and manifest; a
  bf16 leaf (the port restores it; the reference's own restore raises
  ``TypeError`` on it, a recorded fact of the reference: Queue C);
  atomicity, the shape check, a missing leaf.
- ``blocked_cross_entropy``'s and ``_flash``'s gradients against the
  materialized versions (the dense ``log_softmax`` CE, ``attention_plain``)
  and the reference's ``jax.grad`` (1e-5); the bytes each saves for
  backward (``saved_tensors_hooks``, parameters excluded): the CE's do not
  grow with the number of vocab chunks, and ``_flash`` with ``remat_kv``
  saves no (..., qc, kc) score block (without it, it does).
- ``launch/train.main``: every arch for a step on the CPU; stopped and
  resumed equals uninterrupted (losses and the step-4 checkpoint ``==``);
  the port resumes the reference's step-2 checkpoint and its step-3 loss
  lies within 2e-2 of the reference's uninterrupted one (the jitted
  reference keeps bf16 intermediates in fp32); ``--dedup`` keeps the
  reference's examples.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_twins import (  # noqa: F401
    ARCHS, assert_close, assert_tree_close, make_batch, one_torch_thread, to_jax, twin_configs, twin_params,
)
from repro.launch import train as ref_launch
from repro.models import attention as ref_A
from repro.models import forward_loss as ref_forward_loss
from repro.models import layers as ref_L
from repro.train import OptHParams as RefHP
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import latest_step as ref_latest_step
from repro.train import restore_checkpoint as ref_restore
from repro.train import save_checkpoint as ref_save
from repro.train.optimizer import schedule as ref_schedule
from repro_torch.launch import train as launch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params_from_numpy
from repro_torch.train import (
    OptHParams, adamw_init, adamw_update, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.train.optimizer import global_norm, schedule

OPT_TOL = 1e-6
BWD_TOL = 1e-5
RESUME_TOL = 2e-2
SRC = Path(__file__).resolve().parents[1] / "src"

sys.path.insert(0, str(SRC.parent))
from chip_smoke import saved_bytes  # noqa: E402


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def assert_equal_trees(got, want):
    """The port's tree against the reference's, leaf for leaf ``==`` by
    path, with the same shapes and dtypes."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(M.tree_leaves(got))
    for path, w in flat:
        g = got
        for p in path:
            g = g[p.key] if hasattr(p, "key") else g[p.idx]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == str(w.dtype), path
        if w.dtype.name == "bfloat16":
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), path
        else:
            assert np.array_equal(g.numpy(), w), path


# -- the optimizer ---------------------------------------------------------------

SCHEDULE_STEPS = [0, 1, 7, 10, 11, 500, 9999, 10_000, 10_001, 50_000]


@pytest.mark.parametrize("step", SCHEDULE_STEPS)
def test_schedule_matches_reference(step):
    """Warmup (to step 10), cosine decay (to 10,000) and the 10% floor past it."""
    for kw in ({"warmup_steps": 10, "total_steps": 10_000}, {"warmup_steps": 0, "total_steps": 1}):
        got = schedule(OptHParams(**kw), torch.tensor(step, dtype=torch.int32))
        want = ref_schedule(RefHP(**kw), jnp.int32(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= OPT_TOL * abs(float(want)) + 1e-12, (kw, step)
    assert float(schedule(OptHParams(), torch.tensor(50_000))) == pytest.approx(0.1 * 3e-4, rel=1e-6)


@pytest.fixture(scope="module")
def ref_grads():
    """phi3's reduced params and the reference's gradients of its loss
    (fp32 activations), jitted."""
    ref_cfg, _ = twin_configs("phi3_mini_3p8b", "float32")
    params, _ = twin_params(ref_cfg, seed=1)
    batch = to_jax(make_batch(ref_cfg, 2, 24, seed=3))
    grads = jax.jit(jax.grad(lambda p: ref_forward_loss(p, batch, ref_cfg)))(params)
    return params, grads


OPT_CASES = [("float32", 0.5), ("float32", 1e9), ("bfloat16", 1e9)]


@pytest.mark.parametrize("state_dtype,clip_norm", OPT_CASES, ids=[f"{d}-clip{c:g}" for d, c in OPT_CASES])
def test_adamw_update_matches_reference_on_its_gradients(ref_grads, state_dtype, clip_norm):
    """Two steps of both ``adamw_update``s on the same gradients (the
    second from each package's own state), with weight decay, clipped (the
    gradient norm is above clip_norm 0.5) or not.  bf16 state runs
    unclipped: clipped, the two packages' norms sum in another order, the
    scale can differ in its last bit, and a bf16 moment then rounds one
    bf16 step (2^-8) apart, which 1e-6 cannot hold."""
    params, grads = ref_grads
    kw = {"lr": 1e-2, "warmup_steps": 1, "total_steps": 4, "clip_norm": clip_norm}
    ref_hp, hp = RefHP(**kw), OptHParams(**kw)
    ref_p, ref_s = params, ref_adamw_init(params, state_dtype)
    p, s = to_port(params), adamw_init(to_port(params), state_dtype)
    g = to_port(grads)
    for step in (1, 2):   # op by op: under jit XLA fuses b1 m + (1 - b1) g into another fp32 rounding
        ref_p, ref_s, ref_m = ref_adamw_update(ref_p, grads, ref_s, ref_hp)
        out_p, out_s, m = adamw_update(p, g, s, hp)
        assert out_p is p and out_s is s                     # in place
        assert_tree_close(p, ref_p, OPT_TOL, f"step {step} params")
        assert_tree_close(s["m"], ref_s["m"], OPT_TOL, f"step {step} m")
        assert_tree_close(s["v"], ref_s["v"], OPT_TOL, f"step {step} v")
        assert s["step"].dtype == torch.int32 and s["step"].shape == () and int(s["step"]) == step
        for name in ("grad_norm", "lr"):
            assert m[name].shape == () and m[name].dtype == torch.float32
            assert_close(m[name], ref_m[name], OPT_TOL, f"step {step} {name}")
    assert (float(m["grad_norm"]) > clip_norm) == (clip_norm < 1e9)   # clipped or not, as meant


def test_adamw_matches_manual_reference():
    """``tests/test_train.py``'s hand-computed first step."""
    hp = OptHParams(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                    clip_norm=1e9, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    p1, _, _ = adamw_update(p, g, adamw_init(p), hp)
    m = 0.1 * np.array([0.5, 0.25])
    v = 0.01 * np.array([0.25, 0.0625])
    upd = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    lr1 = float(schedule(hp, torch.tensor(1, dtype=torch.int32)))
    np.testing.assert_allclose(p1["w"].numpy(), np.array([1.0, -2.0]) - lr1 * upd, rtol=1e-5)


def test_grad_clipping_bounds_update():
    """``tests/test_train.py``'s clipping case, and the reference's numbers."""
    hp = OptHParams(clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    _, st1, metrics = adamw_update(p, {"w": torch.full((4,), 100.0)}, adamw_init(p), hp)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    np.testing.assert_allclose(st1["m"]["w"].numpy(), 0.05, rtol=1e-5)   # g * (1/200) * 0.1
    rp = {"w": jnp.zeros(4)}
    ref_p, ref_st, ref_m = ref_adamw_update(rp, {"w": jnp.full(4, 100.0)}, ref_adamw_init(rp),
                                            RefHP(clip_norm=1.0, warmup_steps=0, weight_decay=0.0))
    assert_close(st1["m"]["w"], ref_st["m"]["w"], OPT_TOL, "m")
    assert_close(p["w"], ref_p["w"], OPT_TOL, "params")


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": [torch.tensor([4.0], dtype=torch.bfloat16)]}
    assert float(global_norm(t)) == pytest.approx(5.0)


def test_adamw_init_follows_the_state_dtype():
    p = {"w": torch.zeros(3, 2), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    st = adamw_init(p, "bfloat16")
    assert st["m"]["w"].dtype == st["v"]["b"][0].dtype == torch.bfloat16
    assert st["m"]["w"].shape == (3, 2) and st["step"].dtype == torch.int32 and st["step"].shape == ()


# -- checkpoints -----------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_tree(ref_grads):
    """A reference tree with params, a stepped optimizer state and its step."""
    params, grads = ref_grads
    _, opt, _ = ref_adamw_update(params, grads, ref_adamw_init(params), RefHP())
    return {"params": params, "opt": opt}


def test_reference_checkpoint_restores_in_the_port(ckpt_tree, tmp_path):
    ref_save(str(tmp_path), 7, ckpt_tree, extra={"data_cursor": 12345})
    assert latest_step(str(tmp_path)) == 7
    like = M.tree_map(lambda t: t.to("meta"), to_port(ckpt_tree))
    tree, step, extra = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 7 and extra == {"data_cursor": 12345}
    assert_equal_trees(tree, ckpt_tree)
    assert all(t.device.type == "cpu" for t in M.tree_leaves(tree))


def test_port_checkpoint_restores_in_the_reference(ckpt_tree, tmp_path):
    save_checkpoint(str(tmp_path), 3, to_port(ckpt_tree), extra={"data_cursor": 3})
    assert ref_latest_step(str(tmp_path)) == 3
    tree, step, extra = ref_restore(str(tmp_path), jax.eval_shape(lambda: ckpt_tree))
    assert step == 3 and extra == {"data_cursor": 3}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ckpt_tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def _files(d):
    return {f: (Path(d) / f).read_bytes() for f in sorted(os.listdir(d))}


def test_both_packages_write_the_same_files(ckpt_tree, tmp_path):
    """The same file names (sha1 of the reference's leaf names), the same
    manifest text and the same .npy bytes."""
    a = ref_save(str(tmp_path / "ref"), 5, ckpt_tree, extra={"data_cursor": 5})
    b = save_checkpoint(str(tmp_path / "port"), 5, to_port(ckpt_tree), extra={"data_cursor": 5})
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert fa == fb
    names = json.loads(fa["manifest.json"])["leaves"]
    assert "opt/step" in names and "params/groups/0/0/attn/wq/w" in names


def test_bf16_leaf_crosses_and_reference_restore_fails_on_it(tmp_path):
    """A bf16 leaf: the same bytes from both packages, restored bit for bit
    by the port; the reference's own restore raises ``TypeError`` on the
    '|V2' array that ``np.load`` returns (ROADMAP Queue C)."""
    vals = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    ref_tree = {"w": jnp.asarray(vals, jnp.bfloat16), "s": jnp.int32(4), "f": jnp.asarray(vals)}
    a = ref_save(str(tmp_path / "ref"), 1, ref_tree)
    b = save_checkpoint(str(tmp_path / "port"), 1, to_port(ref_tree))
    assert _files(a) == _files(b)
    assert json.loads(_files(a)["manifest.json"])["leaves"]["w"]["dtype"] == "bfloat16"
    like = {"w": torch.empty(3, 5, dtype=torch.bfloat16), "s": torch.empty((), dtype=torch.int32),
            "f": torch.empty(3, 5)}
    for d in (tmp_path / "ref", tmp_path / "port"):
        tree, _, _ = restore_checkpoint(str(d), like, device="cpu")
        assert_equal_trees(tree, ref_tree)
        with pytest.raises(TypeError, match="V2"):
            ref_restore(str(d), jax.eval_shape(lambda: ref_tree))


def test_checkpoint_atomicity_keeps_previous_on_partial_write(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000002.tmp")            # an interrupted save
    assert latest_step(str(tmp_path)) == 1
    os.makedirs(tmp_path / "step_00000003")                # no manifest: incomplete
    assert latest_step(str(tmp_path)) == 1
    tree, step, _ = restore_checkpoint(str(tmp_path), {"w": torch.empty(2)}, device="cpu")
    assert step == 1 and torch.equal(tree["w"], torch.ones(2))
    save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(2)})   # a stale .tmp is replaced
    assert latest_step(str(tmp_path)) == 2 and not (tmp_path / "step_00000002.tmp").exists()


def test_checkpoint_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.empty(8, 4)}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf v"):
        restore_checkpoint(str(tmp_path), {"w": torch.empty(4, 4), "v": torch.empty(1)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"w": torch.empty(4, 4)}, device="cpu")
    assert latest_step(str(tmp_path / "none")) is None


# -- the rematerialized backwards --------------------------------------------------


CE_CASES = [   # tied, bias, logit softcap, vocab chunk (vocab 256)
    (True, False, 0.0, 64),      # four whole chunks
    (True, False, 30.0, 100),    # overlapping last chunk, softcap
    (False, True, 0.0, 100),
    (False, False, 30.0, 256),   # one chunk
]


def _ce_inputs(tied, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = (rng.normal(size=(256, 16) if tied else (16, 256)) * 0.5).astype(np.float32)
    b = rng.normal(size=(256,)).astype(np.float32) if bias else None
    labels = rng.integers(0, 256, (2, 7)).astype(np.int32)
    labels[0, :2] = -1                                       # masked positions
    return x, w, b, labels


@pytest.mark.parametrize("tied,bias,cap,chunk", CE_CASES)
def test_blocked_ce_gradient_matches_dense_and_reference(tied, bias, cap, chunk):
    x, w, b, labels = _ce_inputs(tied, bias)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True) if bias else None
    wkw = {"table": tw} if tied else {"w": tw}
    loss = L.blocked_cross_entropy(tx, torch.tensor(labels), bias=tb, chunk=chunk, logit_softcap=cap, **wkw)
    got = torch.autograd.grad(loss, [tx, tw] + ([tb] if bias else []))

    # the dense log_softmax CE on the same leaves
    dx, dw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    db = torch.tensor(b, requires_grad=True) if bias else None
    logits = dx @ (dw.T if tied else dw) + (db if bias else 0.0)
    logits = L.softcap(logits, cap)
    lab = torch.tensor(labels).long()
    ll = torch.gather(torch.log_softmax(logits, -1), -1, lab.clamp_min(0)[..., None])[..., 0]
    mask = (lab >= 0).float()
    dense = -(ll * mask).sum() / mask.sum()
    want = torch.autograd.grad(dense, [dx, dw] + ([db] if bias else []))
    assert_close(loss, dense, BWD_TOL, "loss")

    # the reference's jax.grad through its checkpointed scan
    def ref_loss(x_, w_, b_):
        kw = {"table": w_} if tied else {"w": w_}
        return ref_L.blocked_cross_entropy(x_, jnp.asarray(labels), bias=b_, chunk=chunk, logit_softcap=cap, **kw)

    ref = jax.grad(ref_loss, argnums=(0, 1, 2) if bias else (0, 1))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None)
    for name, g, d, r in zip(("x", "w", "bias"), got, want, ref):
        assert_close(g, d, BWD_TOL, f"d{name} against the dense CE")
        assert_close(g, r, BWD_TOL, f"d{name} against the reference")


def test_blocked_ce_saved_bytes_do_not_grow_with_chunks():
    """x, the labels and the online softmax's (m, z): the same bytes for 1,
    2, 4 and 8 vocab chunks (parameters excluded)."""
    x, w, _, labels = _ce_inputs(True, False)
    seen = {}
    for chunk in (256, 128, 64, 32):
        tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
        loss, nbytes, shapes = saved_bytes(
            torch, lambda: L.blocked_cross_entropy(tx, torch.tensor(labels), table=tw, chunk=chunk), params=[tw])
        seen[256 // chunk] = nbytes
        assert all(s[-1] != chunk for s in shapes if len(s) == 3), shapes   # no (B, S, chunk) logits
        assert torch.isfinite(torch.autograd.grad(loss, tx)[0]).all()
    assert len(set(seen.values())) == 1, seen
    assert seen[1] <= x.nbytes + labels.nbytes * 2 + 2 * 2 * 7 * 4 + 64, seen


FLASH_CASES = {   # B, Sq, Sk, KV, G, dh, dv, causal, window, q_chunk, k_chunk, scale
    "causal_gqa": (2, 37, 37, 2, 2, 8, 8, True, 0, 16, 8, None),
    "local_window": (1, 40, 40, 1, 3, 8, 8, True, 6, 16, 8, None),
    "bidirectional_padded_keys": (2, 37, 37, 1, 2, 8, 8, False, 0, 16, 16, None),
    "cross": (2, 20, 13, 2, 1, 8, 8, False, 0, 8, 8, None),
    "mla_dv_ne_dh": (1, 33, 33, 2, 2, 12, 8, True, 0, 16, 16, 0.2),
}


def _flash_inputs(b, sq, sk, kvh, g, dh, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, kvh, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, dv)).astype(np.float32)
    do = rng.normal(size=(b, sq, kvh, g, dv)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_gradient_matches_plain_and_reference(case):
    b, sq, sk, kvh, g, dh, dv, causal, window, qc, kc, scale = FLASH_CASES[case]
    q, k, v, do = _flash_inputs(b, sq, sk, kvh, g, dh, dv)
    qpos, kpos = np.arange(sq, dtype=np.int32), np.arange(sk, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=scale)

    def port(remat_kv, plain=False):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        pos = torch.tensor(qpos), torch.tensor(kpos)
        if plain:
            out = A.attention_plain(*ts, *pos, **kw)
        else:
            out = A._flash(*ts, *pos, q_chunk=qc, k_chunk=kc, remat_kv=remat_kv, **kw)
        return out, torch.autograd.grad(out, ts, torch.tensor(do))

    out, got = port(True)
    out_loop, loop = port(False)
    assert torch.equal(out, out_loop)                        # one forward, two backwards
    for name, a, c in zip("qkv", got, loop):
        assert_close(a, c, 1e-6, f"d{name}: remat_kv against autograd through the blocks")
    if causal or sk % kc == 0:   # without a causal mask, _flash's padded keys join the softmax (Queue C)
        _, plain = port(False, plain=True)
        for name, a, c in zip("qkv", got, plain):
            assert_close(a, c, BWD_TOL, f"d{name} against attention_plain")

    def ref(q_, k_, v_):
        o = ref_A._flash(q_, k_, v_, jnp.asarray(qpos), jnp.asarray(kpos), q_chunk=qc, k_chunk=kc,
                         remat_kv=True, **kw)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, c in zip("qkv", got, want):
        assert_close(a, c, BWD_TOL, f"d{name} against the reference")


def test_flash_remat_saves_no_score_block():
    """With ``remat_kv`` no saved tensor ends in (qc, kc); without it the
    blocks' probabilities are saved (the control)."""
    b, sq, sk, kvh, g, dh, dv, causal, window, qc, kc, _ = FLASH_CASES["causal_gqa"]
    q, k, v, _ = _flash_inputs(b, 48, 48, kvh, 3, 12, 12)
    pos = torch.arange(48, dtype=torch.int32)
    found = {}
    for remat_kv in (True, False):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        _, nbytes, shapes = saved_bytes(torch, lambda: A._flash(*ts, pos, pos, causal=True, window=0, q_chunk=16,
                                                         k_chunk=8, remat_kv=remat_kv))
        found[remat_kv] = [s for s in shapes if s[-2:] == (16, 8)]
    assert found[True] == []
    assert found[False], "the control saved no score block"


# -- launch/train ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_every_arch_on_the_cpu(arch, capsys):
    loss = launch.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "24", "--device", "cpu"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert re.search(r"step     0 loss=\d+\.\d{4} gnorm=\d+\.\d\d lr=\d\.\d\de-\d\d", out), out
    assert "step     1 loss=" in out and out.rstrip().endswith("done.")


def test_train_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--steps", "1"])


def test_train_module_imports_without_side_effects():
    out = subprocess.run(
        [sys.executable, "-c", "import repro_torch.launch.train as t; print(t.main.__name__)"],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout == "main\n"


RUN = ["--batch", "4", "--seq", "32", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The reference's main for 3 steps with --dedup (checkpoint at step 2);
    the port's for 4 uninterrupted steps with --dedup, for 2 then resumed to
    4, and resumed from the reference's step-2 checkpoint to 3."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("launch")
    out = {}

    def run(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = fn(argv)
        return loss, buf.getvalue()

    out["ref"] = run(ref_launch.main, ["--steps", "3", "--ckpt-dir", str(d / "ref"), "--dedup", *RUN])
    cpu = ["--device", "cpu", *RUN]
    out["whole"] = run(launch.main, ["--steps", "4", "--ckpt-dir", str(d / "whole"), "--dedup", *cpu])
    out["first"] = run(launch.main, ["--steps", "2", "--ckpt-dir", str(d / "split"), *cpu])
    out["resumed"] = run(launch.main, ["--steps", "4", "--ckpt-dir", str(d / "split"), *cpu])
    out["from_ref"] = run(launch.main, ["--steps", "3", "--ckpt-dir", str(d / "ref"), *cpu])
    out["dir"] = d
    return out


def test_train_resume_equals_uninterrupted(launches):
    assert "resumed from step 2 (data cursor 2)" in launches["resumed"][1]
    assert launches["resumed"][0] == launches["whole"][0]
    d = launches["dir"]
    assert latest_step(str(d / "whole")) == latest_step(str(d / "split")) == 4
    a, b = _files(d / "whole" / "step_00000004"), _files(d / "split" / "step_00000004")
    assert a == b


def test_train_resumes_the_reference_checkpoint(launches):
    """The port's step 3 from the reference's step-2 checkpoint (params,
    AdamW state, data cursor) against the reference's uninterrupted step 3."""
    loss, text = launches["from_ref"]
    assert "resumed from step 2 (data cursor 2)" in text
    assert "step     2 loss=" in text
    assert abs(loss - launches["ref"][0]) <= RESUME_TOL * abs(launches["ref"][0]), (loss, launches["ref"][0])


def test_train_dedup_keeps_the_reference_examples(launches):
    line = re.compile(r"dedup: kept (\d+)/(\d+) examples")
    want, got = line.search(launches["ref"][1]), line.search(launches["whole"][1])
    assert want and got and got.groups() == want.groups() and want.group(2) == "4"
