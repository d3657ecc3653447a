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

Sharded state (a DTensor leaf, the elastic re-mesh of the reference): each
leaf is saved as its global array, the same file a plain tensor writes.
Every rank calls ``save_checkpoint`` (each leaf is gathered whole with
``full_tensor()``, one leaf at a time, a collective); rank 0 of the default
process group writes the files and renames the temp directory, and a
barrier then holds every rank until the checkpoint is complete.
``restore_checkpoint(..., shardings=)`` places each global array by a
matching tree of ``NamedSharding``s (mesh and spec): every rank reads the
whole array and keeps its own shards, so a checkpoint saved on one mesh
restores onto any other, or, without ``shardings``, as plain tensors.

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


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``.  With DTensor leaves,
    every rank calls it and rank 0 writes (see the module's docstring)."""
    import torch.distributed as dist

    leaves = _flatten(tree)
    sharded = any(_is_dtensor(t) for _, t in leaves)
    group = sharded and dist.is_initialized()
    writer = not group or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in leaves:
        name = "/".join(path)
        fn = _fname(name)
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if writer:
            shape, dtype = _save_leaf(os.path.join(tmp, fn), leaf)
            manifest["leaves"][name] = {"file": fn, "shape": shape, "dtype": dtype}
        del leaf
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
    if group:
        dist.barrier()
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


def _sharding_at(shardings, path):
    """The ``NamedSharding`` (or None) of the leaf at ``path`` of a tree
    that matches ``like``; a ``NamedSharding`` or None higher up covers
    its whole subtree."""
    from repro_torch.sharding.rules import NamedSharding

    s = shardings
    for k in path:
        if s is None or isinstance(s, NamedSharding):
            break
        s = s[k] if isinstance(s, dict) else s[int(k)]
    return s


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device="cuda", shardings: Any = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, on any
    device, ``meta`` included: only its structure and shapes are read).

    ``shardings``: optional matching tree of ``NamedSharding``s (e.g.
    ``named_shardings(param_specs(...), mesh)``): each leaf that has one
    comes back as a DTensor on its mesh, each rank keeping its own shards
    of the global array (no collective); the elastic re-mesh.

    Returns (tree of new tensors on ``device``, or DTensors, step, the
    manifest's extra).
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
        sh = _sharding_at(shardings, path)
        if sh is None:
            leaves.append(t.to(dev))
        else:
            from torch.distributed.tensor import distribute_tensor
            t = t.to(sh.mesh.device_type)
            leaves.append(distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None))
    tree = _rebuild(like, iter(leaves))
    return tree, step, manifest.get("extra", {})
