"""The model path in both packages on the same inputs: shared by
``test_torch_models.py``, ``test_torch_serve.py``,
``test_torch_recurrent.py`` and ``test_torch_mla_moe.py``.

Weights come from the reference's ``init_params`` and reach the port
through numpy (``repro_torch.models.params_from_numpy``); inputs are drawn
with numpy.  Tolerances: max|got - want| / max|want| <= 1e-5 at fp32
activations and <= 2e-2 at bf16 (a few bf16 roundings of the activations
apart); integer leaves (cache positions) compare with ``==``.

The reference runs op by op (``jax.disable_jit``) wherever bf16 is
compared: under ``jit``, XLA's CPU fusions keep bf16 intermediates in fp32
(excess precision), which moves its bf16 logits up to 2e-2 from its own
op-by-op results.  At fp32 the jitted reference sits within 1e-6 of its
op-by-op results, and ``twin_run`` may jit it (``op_by_op=False``).
"""
import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro.models import init_params as ref_init_params
from repro.train import make_prefill as ref_make_prefill
from repro.train import make_serve_step as ref_make_serve_step
from repro_torch import configs, models
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import params_from_numpy

ATTN_ARCHS = [
    "gemma3_12b", "phi3_mini_3p8b", "qwen3_32b", "qwen2p5_32b",
    "seamless_m4t_medium", "llama3p2_vision_11b",
]
RECURRENT_ARCHS = ["recurrentgemma_2b", "xlstm_125m"]
MLA_MOE_ARCHS = ["deepseek_v2_236b", "arctic_480b"]
ARCHS = ATTN_ARCHS + RECURRENT_ARCHS + MLA_MOE_ARCHS   # all ten of ARCH_IDS
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
PROMPT, DECODE_STEPS, BATCH = 12, 8, 2


def twin_configs(arch, activation_dtype, **overrides):
    """The reduced config of ``arch`` in both packages, at the given
    activations (and other fields ``overrides`` names)."""
    ref = dataclasses.replace(ref_configs.get_reduced_config(arch), activation_dtype=activation_dtype, **overrides)
    port = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype=activation_dtype, **overrides)
    return ref, port


def twin_params(ref_cfg, seed=0):
    """(reference params, the same as the port's tree on the CPU)."""
    params = ref_init_params(ref_cfg, jax.random.key(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def make_batch(cfg, b, s, seed=0):
    """numpy inputs: tokens, labels = tokens, and the stub frames / patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"] = batch["tokens"]
    if cfg.encoder_groups is not None:
        batch["frames"] = rng.normal(size=(b, 16, cfg.enc_input_dim)).astype(np.float32)
    if cfg.vision_tokens:
        batch["patches"] = rng.normal(size=(b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def as_numpy(x):
    """A torch tensor or a jax / numpy array as a float64 or int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) or x.dtype.name == "bfloat16" else x


def rel_err(got, want) -> float:
    """max|got - want| / max|want|."""
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def assert_close(got, want, tol, what=""):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: max|diff|/max|ref| = {err:.3g} > {tol}"


def dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def assert_tree_close(got, want, tol, path="root"):
    """Leaf for leaf: the same structure, shapes and dtypes; float leaves
    within ``tol``, integer leaves ``==``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (path, type(got), len(got))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, tol, f"{path}[{i}]")
    else:
        assert tuple(got.shape) == tuple(want.shape), (path, got.shape, want.shape)
        assert dtype_name(got) == str(np.asarray(want).dtype), (path, got.dtype, want.dtype)
        if got.is_floating_point():
            assert_close(got, want, tol, path)
        else:
            np.testing.assert_array_equal(as_numpy(got), as_numpy(want), err_msg=path)


# -- one arch through both packages -------------------------------------------

_RUNS = {}


def twin_run(arch, dtype, *, op_by_op=True, **overrides):
    """Both packages on the same weights and inputs (memoized per case):
    ``forward_train``, ``forward_loss``, ``prefill`` (logits, caches,
    memory) and DECODE_STEPS teacher-forced ``decode_step``s (so both see
    the same tokens), with every step's logits and caches."""
    key = (arch, dtype, op_by_op, tuple(sorted(overrides.items())))
    if key in _RUNS:
        return _RUNS[key]
    ref_cfg, cfg = twin_configs(arch, dtype, **overrides)
    ref_params, params = twin_params(ref_cfg, seed=1)
    batch = make_batch(cfg, BATCH, PROMPT, seed=3)
    cache_len = PROMPT + DECODE_STEPS
    steps = np.random.default_rng(5).integers(0, cfg.vocab, (DECODE_STEPS, BATCH)).astype(np.int32)
    out = {"cfg": cfg, "ref": {}, "port": {}}
    ref, port = out["ref"], out["port"]

    train, loss, pre = ref_models.forward_train, ref_models.forward_loss, ref_models.prefill
    step = ref_models.decode_step
    if not op_by_op:
        train, loss = jax.jit(train, static_argnums=2), jax.jit(loss, static_argnums=2)
        pre = jax.jit(pre, static_argnums=(2, 3))
        step = jax.jit(step, static_argnums=4)
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        jb = to_jax(batch)
        ref["loss"], ref["logits"] = train(ref_params, jb, ref_cfg)
        ref["ce"] = loss(ref_params, jb, ref_cfg)
        ref["prefill"], caches, memory = pre(ref_params, jb, ref_cfg, cache_len)
        ref["memory"], ref["caches"] = memory, jax.tree.map(np.asarray, caches)
        ref["decode"], ref["step_caches"] = [], []
        for i, tok in enumerate(steps):
            lg, caches = step(ref_params, caches, jnp.asarray(tok), jnp.int32(PROMPT + i), ref_cfg, memory=memory)
            ref["decode"].append(lg)
            ref["step_caches"].append(jax.tree.map(np.asarray, caches))
        ref["decoded_caches"] = ref["step_caches"][-1]

    tb = to_torch(batch)
    port["loss"], port["logits"] = models.forward_train(params, tb, cfg)
    port["ce"] = models.forward_loss(params, tb, cfg)
    port["prefill"], caches, port["memory"] = models.prefill(params, tb, cfg, cache_len)
    port["params"], port["caches"] = params, M.tree_map(torch.clone, caches)   # decode writes in place
    port["decode"], port["step_caches"] = [], []
    for i, tok in enumerate(steps):
        lg, caches = models.decode_step(params, caches, torch.from_numpy(tok), PROMPT + i, cfg,
                                        memory=port["memory"])
        port["decode"].append(lg)
        port["step_caches"].append(M.tree_map(torch.clone, caches))
    port["decoded_caches"] = caches
    _RUNS[key] = out
    return out


def check_forward_train(run, dtype):
    assert run["port"]["logits"].shape == (BATCH, PROMPT, run["cfg"].vocab)
    assert_close(run["port"]["logits"], run["ref"]["logits"], TOL[dtype], "logits")
    assert_close(run["port"]["loss"], run["ref"]["loss"], TOL[dtype], "loss")


def check_forward_loss(run, dtype):
    assert_close(run["port"]["ce"], run["ref"]["ce"], TOL[dtype], "forward_loss")
    # the streaming CE equals the dense loss within fp32 rounding
    assert_close(run["port"]["ce"], run["port"]["loss"], 1e-5, "forward_loss vs forward_train")


def check_prefill(run, dtype):
    assert_close(run["port"]["prefill"], run["ref"]["prefill"], TOL[dtype], "prefill logits")
    if run["ref"]["memory"] is None:
        assert run["port"]["memory"] is None
    else:
        assert_close(run["port"]["memory"], run["ref"]["memory"], TOL[dtype], "memory")
    assert_tree_close(run["port"]["caches"], run["ref"]["caches"], TOL[dtype], "prefill caches")


def check_decode(run, dtype):
    """Every step's logits and caches: a state the port dropped would show
    from the second step on."""
    steps = zip(run["port"]["decode"], run["ref"]["decode"], run["port"]["step_caches"], run["ref"]["step_caches"])
    for i, (got, want, got_c, want_c) in enumerate(steps):
        assert got.shape == (BATCH, run["cfg"].vocab) and got.dtype == torch.float32
        assert_close(got, want, TOL[dtype], f"decode step {i}")
        assert_tree_close(got_c, want_c, TOL[dtype], f"caches after step {i}")
    assert_tree_close(run["port"]["decoded_caches"], run["ref"]["decoded_caches"], TOL[dtype], "decoded caches")


def check_decode_matches_forward_train(arch, **overrides):
    """The reference's own bound (tests/test_archs_smoke.py): prefill on s-1
    tokens plus one decode step equals forward_train at s-1, rel < 5e-3."""
    _, cfg = twin_configs(arch, "float32", **overrides)
    params = models.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = to_torch(make_batch(cfg, 2, 24, seed=3))
    _, logits = models.forward_train(params, batch, cfg)
    ctx = dict(batch, tokens=batch["tokens"][:, :23], labels=batch["tokens"][:, :23])
    _, caches, memory = models.prefill(params, ctx, cfg, cache_len=32)
    lg, _ = models.decode_step(params, caches, batch["tokens"][:, 23], 23, cfg, memory=memory)
    ref = logits[:, 23]
    assert float((lg - ref).abs().max() / ref.abs().max()) < 5e-3, arch


# -- parameters ----------------------------------------------------------------


def shapes(tree):
    """{path: (shape, dtype name)} of a torch, jax or ShapeDtypeStruct tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}.{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    walk(tree, "")
    return out


def check_abstract_params(arch):
    got = models.abstract_params(configs.get_config(arch))
    assert all(t.device.type == "meta" for t in M.tree_leaves(got))
    assert shapes(got) == shapes(ref_models.abstract_params(ref_configs.get_config(arch)))


def check_param_counts(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert models.count_params_analytic(cfg) == ref_models.count_params_analytic(ref_cfg)
    assert (models.count_params_analytic(cfg, active_only=True)
            == ref_models.count_params_analytic(ref_cfg, active_only=True))
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


# leaves drawn from a normal times 1 / sqrt(fan-in), the fan-in being the
# leaf's second-to-last axis: dense "w" (the router's and the conv's too,
# whose fan-in is its width), the MoE experts' stacks "wg" / "wi" / "wo"
# (elsewhere these names hold dense dicts) and sLSTM's recurrent "r"
_NORMAL = {"w", "wg", "wi", "wo", "r"}


def check_init_distributions(arch):
    """The port's own ``init_params``: the reference's tree, shapes and
    dtypes, and the intended distributions (normal x 1/sqrt(fan-in), the
    embedding normal x 0.02, RG-LRU's lambda uniform on [-4.6, -3), norm
    scales ones, biases and ``xgate`` zeros); the same seed draws the same."""
    cfg = configs.get_reduced_config(arch)
    got = models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: ref_models.init_params(ref_configs.get_reduced_config(arch), jax.random.key(0)))
    assert shapes(got) == shapes(want)
    leaves = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for v in t:
                walk(v, path)
        else:
            leaves.setdefault(path, []).append(t)

    walk(got, ())
    seen = set()
    for path, ts in leaves.items():
        name = path[-1]
        for t in ts:
            seen.add(name)
            if name == "lam":
                assert t.dtype == torch.float32 and bool(((t >= -4.6) & (t < -3.0)).all()), path
                assert abs(float(t.mean()) + 3.8) < 0.1 and float(t.std()) > 0.4, path
                continue
            if name == "table":
                std = 0.02
            elif name in _NORMAL:
                std = 1.0 / np.sqrt(t.shape[-2])
            else:
                fill = 1.0 if name == "scale" else 0.0   # norm scales; biases and xgate
                assert bool((t == fill).all()), path
                continue
            got_std = float(t.double().std())
            assert abs(got_std / std - 1) < 0.05, (path, got_std, std)
            assert abs(float(t.double().mean())) < 0.1 * std, path
    assert {"table", "w", "scale"} <= seen
    again = models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(M.tree_leaves(got), M.tree_leaves(again)))
    return seen


# -- the serving loop ----------------------------------------------------------


def reference_loop(ref_cfg, params, batch, prompt, max_new):
    """The reference's greedy loop, as ``repro.launch.serve`` runs it; the
    logits of every step (the prefill's first)."""
    logits, caches, memory = ref_make_prefill(ref_cfg, prompt + max_new)(params, batch)
    logits = logits[..., : ref_cfg.vocab]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    step = jax.jit(lambda p, c, t, pos, mem: ref_make_serve_step(ref_cfg)(p, c, t, pos, memory=mem))
    toks, all_logits = [tok], [logits]
    for i in range(max_new - 1):
        tok, logits, caches = step(params, caches, tok, jnp.int32(prompt + i), memory)
        toks.append(tok)
        all_logits.append(logits)
    return np.stack([np.asarray(t) for t in toks], axis=1), np.stack([np.asarray(x) for x in all_logits], axis=1)


def check_greedy_tokens(arch, batch_size=3, prompt=12, max_new=12):
    """The port's greedy loop (``launch.serve.generate``) against the
    reference's at fp32 on the same weights and prompts: the tokens are
    equal step for step, but for a step whose reference top-2 logits lie
    within TOL of each other, which is reported as a warning and ends the
    comparison of that row (the loops' inputs differ from there on)."""
    ref_cfg, cfg = twin_configs(arch, "float32")
    ref_params, params = twin_params(ref_cfg, seed=2)
    batch = make_batch(cfg, batch_size, prompt, seed=7)
    want, ref_logits = reference_loop(ref_cfg, ref_params, to_jax(batch), prompt, max_new)
    got = serve.generate(cfg, params, to_torch(batch), max_new)
    assert got.tokens.shape == (batch_size, max_new) and got.tokens.dtype == np.int32
    assert got.logits.shape == (batch_size, cfg.vocab)
    for b in range(batch_size):
        diff = np.flatnonzero(got.tokens[b] != want[b])
        if diff.size == 0:
            continue
        j = int(diff[0])
        top2 = np.sort(ref_logits[b, j])[-2:]
        gap = float(top2[1] - top2[0]) / float(np.abs(ref_logits[b, j]).max())
        assert gap <= TOL["float32"], (
            f"{arch} row {b} step {j}: token {got.tokens[b, j]} != {want[b, j]}, reference top-2 gap {gap:.3g}"
        )
        warnings.warn(f"{arch} row {b}: greedy tokens part at step {j} on a reference near-tie "
                      f"(top-2 gap {gap:.3g} of max|logit|)")
    if np.array_equal(got.tokens, want):
        # the last step's logits too, when no near-tie parted the loops
        err = np.abs(got.logits.numpy() - ref_logits[:, -1]).max() / np.abs(ref_logits[:, -1]).max()
        assert err <= TOL["float32"], err


# -- training ------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's reduced models on one torch thread: their ops are tiny,
    and with pytest-xdist's workers each running a full thread pool they
    spend most of their time in thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a train step's inputs: 40 tokens (three query / key chunks of 16, the last
# padded) and ce_chunk 200 (the reduced vocab of 512 in three chunks, the last
# overlapping the second), so the rematerialized backwards walk several chunks
TRAIN_BATCH, TRAIN_SEQ = 2, 40
TRAIN_OVERRIDES = {"ce_chunk": 200}
TRAIN_HP = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10}


def tree_at(tree, path):
    """The leaf of a dict / list tree at a JAX key path."""
    for p in path:
        tree = tree[p.key] if hasattr(p, "key") else tree[p.idx]
    return tree


def ref_leaves(tree):
    """(key path string, path, leaf) of a reference tree, in its flatten order."""
    return [(jax.tree_util.keystr(p), p, x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_tree_atol(got, want, atol, what=""):
    """The port's tree against the reference's, leaf for leaf by path:
    max|got - want| <= atol."""
    for name, path, w in ref_leaves(want):
        err = float(np.max(np.abs(as_numpy(tree_at(got, path)) - as_numpy(w)), initial=0.0))
        assert err <= atol, f"{what}{name}: max|diff| = {err:.3g} > {atol}"


def clone_tree(tree):
    return M.tree_map(lambda t: t.detach().clone(), tree)


_TRAIN_RUNS = {}


def train_twin(arch, dtype="float32", **overrides):
    """One train step of each package on the same weights and batch
    (memoized): the reference's ``make_train_step`` jitted, the port's on
    the CPU.  Step 1 starts both from ``adamw_init``; step 2 starts both
    from the reference's params and optimizer state after its step 1.
    The reference's gradients are the ones its step hands to
    ``adamw_update`` (after the bf16 cast, where there is one), captured by
    a wrapper of ``repro.train.steps.adamw_update`` while the step traces,
    so one program gives both.
    Returns {"cfg", "hp", "ref": {...}, "port": {...}} with keys loss,
    grads, params1, opt1, metrics1, params2, opt2, metrics2."""
    import repro.train.steps as ref_steps
    from repro.train import OptHParams as RefHP
    from repro.train import adamw_init as ref_adamw_init
    from repro_torch.train import OptHParams, adamw_init, make_train_step
    from repro_torch.train.steps import loss_and_grads

    overrides = {**TRAIN_OVERRIDES, **overrides}
    key = (arch, dtype, tuple(sorted(overrides.items())))
    if key in _TRAIN_RUNS:
        return _TRAIN_RUNS[key]
    ref_cfg, cfg = twin_configs(arch, dtype, **overrides)
    ref_params, params = twin_params(ref_cfg, seed=1)
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=3)
    ref_hp, hp = RefHP(**TRAIN_HP), OptHParams(**TRAIN_HP)

    real_update = ref_steps.adamw_update

    def capturing(p, grads, state, hp_):
        new_p, new_state, metrics = real_update(p, grads, state, hp_)
        return new_p, new_state, dict(metrics, grads=grads)

    ref_steps.adamw_update = capturing
    try:
        fn = jax.jit(ref_steps.make_train_step(ref_cfg, ref_hp))
        jb, tb = to_jax(batch), to_torch(batch)
        ref = {}
        ref["params1"], ref["opt1"], ref["metrics1"] = fn(
            ref_params, ref_adamw_init(ref_params, ref_cfg.opt_state_dtype), jb)
        ref["params2"], ref["opt2"], ref["metrics2"] = fn(ref["params1"], ref["opt1"], jb)
    finally:
        ref_steps.adamw_update = real_update
    ref["loss"], ref["grads"] = ref["metrics1"]["loss"], ref["metrics1"].pop("grads")
    ref["metrics2"].pop("grads")

    port = {}
    port["loss"], port["grads"] = loss_and_grads(params, tb, cfg)
    step = make_train_step(cfg, hp)
    p1 = clone_tree(params)
    port["params1"], port["opt1"], port["metrics1"] = step(p1, adamw_init(p1, cfg.opt_state_dtype), tb)
    p2 = params_from_numpy(jax.tree.map(np.asarray, ref["params1"]), "cpu")
    o2 = params_from_numpy(jax.tree.map(np.asarray, ref["opt1"]), "cpu")
    port["params2"], port["opt2"], port["metrics2"] = step(p2, o2, tb)
    out = {"cfg": cfg, "ref_cfg": ref_cfg, "hp": hp, "params": params, "batch": batch, "ref": ref, "port": port}
    _TRAIN_RUNS[key] = out
    return out


GRAD_TOL = 1e-4     # a gradient leaf: max|diff| / max|ref|, fp32
LOSS_TOL = 1e-5     # loss, grad_norm, lr


def check_grads(arch, dtype="float32", **overrides):
    run = train_twin(arch, dtype, **overrides)
    assert_close(run["port"]["loss"], run["ref"]["loss"], LOSS_TOL, "loss")
    assert_tree_close(run["port"]["grads"], run["ref"]["grads"], GRAD_TOL, "grads")
    return run


def check_train_step(arch):
    run = train_twin(arch)
    port, ref = run["port"], run["ref"]
    assert_close(port["loss"], ref["loss"], LOSS_TOL, "loss")
    for step in ("1", "2"):
        for name in ("grad_norm", "lr"):
            assert_close(port["metrics" + step][name], ref["metrics" + step][name], LOSS_TOL, f"step {step} {name}")
        assert_close(port["metrics" + step]["loss"], ref["metrics" + step]["loss"], LOSS_TOL, f"step {step} loss")
        atol = 2 * float(ref["metrics" + step]["lr"])
        assert_tree_atol(port["params" + step], ref["params" + step], atol, f"step {step} params")
        for moment in ("m", "v"):
            assert_tree_close(port["opt" + step][moment], ref["opt" + step][moment], GRAD_TOL, f"step {step} {moment}")
        assert int(port["opt" + step]["step"]) == int(ref["opt" + step]["step"]) == int(step)
    # the step moved the weights
    moved = [name for name, path, w in ref_leaves(ref["params1"])
             if rel_err(tree_at(port["params1"], path), tree_at(run["params"], path)) > 0]
    assert moved, "the step moved no weight"
