"""PyTorch port vs the JAX package: the serving loop on the CPU.

The port's greedy loop (``launch.serve.generate`` over ``make_prefill`` /
``make_serve_step``) against the reference's ``make_prefill`` /
``make_serve_step`` on the same converted weights and prompts, at fp32
activations (``model_twins.check_greedy_tokens``, for the six
attention-family archs; ``test_torch_recurrent.py`` and
``test_torch_mla_moe.py`` run it for the other four): the tokens are equal
step for step.  The one allowed exception is a step whose reference top-2
logits lie within the stated tolerance of each other (``model_twins.TOL``:
max|diff| / max|ref| <= 1e-5); such a step is reported as a warning, and
the loops are compared no further (their inputs differ from there on).
Then the CLI, ``python -m repro_torch.launch.serve``, with ``--device cpu``
for all ten archs, and its default arch, the reference's.
"""
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from model_twins import ARCHS, ATTN_ARCHS, check_greedy_tokens, twin_configs
from repro.launch import serve as ref_serve
from repro_torch.launch import serve

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_greedy_tokens_match_reference(arch):
    check_greedy_tokens(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "10", "--max-new", "5", "--device", "cpu"])
    cfg = twin_configs(arch, "bfloat16")[1]
    assert gen.shape == (2, 5) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    out = capsys.readouterr().out
    assert f"arch={cfg.name} batch=2 prompt=10 new=5 device=cpu" in out
    assert "ms/token" in out and "sample[1]" in out


def test_serve_cli_defaults_to_the_reference_arch(capsys):
    """``--arch`` defaults to the reference's ``xlstm_125m``."""
    assert re.search(r'"--arch", default="xlstm_125m"', inspect.getsource(ref_serve.main))
    default = serve.main(["--batch", "1", "--prompt-len", "6", "--max-new", "3", "--device", "cpu"])
    assert "arch=xlstm-125m batch=1 prompt=6 new=3 device=cpu" in capsys.readouterr().out
    assert np.array_equal(default, serve.main(["--arch", "xlstm_125m", "--batch", "1", "--prompt-len", "6",
                                               "--max-new", "3", "--device", "cpu"]))


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
