"""The model path in both packages on the same inputs: shared by
``test_torch_models.py`` and ``test_torch_serve.py``.

Weights come from the reference's ``init_params`` and reach the port
through numpy (``repro_torch.models.params_from_numpy``); inputs are drawn
with numpy.  Tolerances: max|got - want| / max|want| <= 1e-5 at fp32
activations and <= 2e-2 at bf16 (a few bf16 roundings of the activations
apart); integer leaves (cache positions) compare with ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.models import init_params as ref_init_params
from repro_torch import configs
from repro_torch.models import params_from_numpy

ATTN_ARCHS = [
    "gemma3_12b", "phi3_mini_3p8b", "qwen3_32b", "qwen2p5_32b",
    "seamless_m4t_medium", "llama3p2_vision_11b",
]
OTHER_ARCHS = ["recurrentgemma_2b", "arctic_480b", "deepseek_v2_236b", "xlstm_125m"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def twin_configs(arch, activation_dtype):
    """The reduced config of ``arch`` in both packages, at the given activations."""
    ref = dataclasses.replace(ref_configs.get_reduced_config(arch), activation_dtype=activation_dtype)
    port = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype=activation_dtype)
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
