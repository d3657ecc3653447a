"""Checkpoint save / restore, PyTorch port of ``repro.train.checkpoint``,
in the reference's on-disk format, so either package loads the other's.

Layout:  <dir>/step_<N>/
            manifest.json       -- step, leaf names, shapes, dtypes, extra
            <leaf-hash>.npy     -- one file per tree leaf (sha1 of its name)

A leaf's name is its path in the tree joined by "/", as the reference's
``_leaf_name`` spells a JAX key path (``params/groups/0/1/attn/wq/w``,
``opt/step``); a dict's keys are walked in sorted order, as JAX flattens
them, so the manifest is the reference's byte for byte.  Writes go to a temp directory
that is atomically renamed, so an interrupted save never corrupts the
latest checkpoint; restore picks the newest complete manifest.

bf16 leaves: the reference's ``np.save`` of an ``ml_dtypes`` bfloat16 array
writes 2-byte void elements (descr ``<V2``) and the manifest says
``"bfloat16"``.  The port writes the same bytes (that header, then the
leaf's raw 16-bit words) and reads such a leaf back through a 16-bit
integer view, keyed on the manifest's dtype; it never needs ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.snapshot import resolve_device


def _flatten(tree, path=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in ``_flatten``'s order
    from the iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _fname(name: str) -> str:
    return hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"


def _save_leaf(path: str, t: torch.Tensor):
    """Write one leaf as the reference's ``np.save`` does; returns (shape,
    the manifest's dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": words.shape})
            f.write(words.tobytes())
        return list(words.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in _flatten(tree):
        name = "/".join(path)
        fn = _fname(name)
        shape, dtype = _save_leaf(os.path.join(tmp, fn), leaf)
        manifest["leaves"][name] = {"file": fn, "shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device="cuda") -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, on any
    device, ``meta`` included: only its structure and shapes are read).

    Returns (tree of new tensors on ``device``, step, the manifest's extra).
    """
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    leaves = []
    for path, leaf in _flatten(like):
        name = "/".join(path)
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(os.path.join(d, meta["file"]))
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(leaf.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaves.append(t.to(dev))
    tree = _rebuild(like, iter(leaves))
    return tree, step, manifest.get("extra", {})
