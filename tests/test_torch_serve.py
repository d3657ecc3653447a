"""PyTorch port vs the JAX package: the serving loop on the CPU.

The port's greedy loop (``launch.serve.generate`` over ``make_prefill`` /
``make_serve_step``) against the reference's ``make_prefill`` /
``make_serve_step`` on the same converted weights and prompts, at fp32
activations: the tokens are equal step for step.  The one allowed
exception is a step whose reference top-2 logits lie within the stated
tolerance of each other (``model_twins.TOL``: max|diff| / max|ref| <=
1e-5); such a step is reported as a warning, and the loops are compared
no further (their inputs differ from there on).  Then the CLI, ``python -m
repro_torch.launch.serve``, with ``--device cpu`` for the six
attention-family archs, and the item-13b error for the other four.
"""
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_twins import ATTN_ARCHS, OTHER_ARCHS, TOL, make_batch, to_jax, to_torch, twin_configs, twin_params
from repro.train import make_prefill as ref_make_prefill
from repro.train import make_serve_step as ref_make_serve_step
from repro_torch.launch import serve

SRC = Path(__file__).resolve().parents[1] / "src"
BATCH, PROMPT, MAX_NEW = 3, 12, 12


def _reference_loop(ref_cfg, params, batch):
    """The reference's greedy loop, as ``repro.launch.serve`` runs it; the
    logits of every step (the prefill's first)."""
    logits, caches, memory = ref_make_prefill(ref_cfg, PROMPT + MAX_NEW)(params, batch)
    logits = logits[..., : ref_cfg.vocab]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    step = jax.jit(lambda p, c, t, pos, mem: ref_make_serve_step(ref_cfg)(p, c, t, pos, memory=mem))
    toks, all_logits = [tok], [logits]
    for i in range(MAX_NEW - 1):
        tok, logits, caches = step(params, caches, tok, jnp.int32(PROMPT + i), memory)
        toks.append(tok)
        all_logits.append(logits)
    return np.stack([np.asarray(t) for t in toks], axis=1), np.stack([np.asarray(x) for x in all_logits], axis=1)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_greedy_tokens_match_reference(arch):
    ref_cfg, cfg = twin_configs(arch, "float32")
    ref_params, params = twin_params(ref_cfg, seed=2)
    batch = make_batch(cfg, BATCH, PROMPT, seed=7)
    want, ref_logits = _reference_loop(ref_cfg, ref_params, to_jax(batch))
    got = serve.generate(cfg, params, to_torch(batch), MAX_NEW)
    assert got.tokens.shape == (BATCH, MAX_NEW) and got.tokens.dtype == np.int32
    assert got.logits.shape == (BATCH, cfg.vocab)
    for b in range(BATCH):
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


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "10", "--max-new", "5", "--device", "cpu"])
    cfg = twin_configs(arch, "bfloat16")[1]
    assert gen.shape == (2, 5) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    out = capsys.readouterr().out
    assert f"arch={cfg.name} batch=2 prompt=10 new=5 device=cpu" in out
    assert "ms/token" in out and "sample[1]" in out


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_serve_cli_raises_item_13b_for_the_other_archs(arch):
    with pytest.raises(NotImplementedError, match="13b"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_serve_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--max-new", "2"])


def test_serve_module_imports_without_side_effects():
    out = subprocess.run(
        [sys.executable, "-c", "import repro_torch.launch.serve as s; print(s.main.__name__)"],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout == "main\n"
