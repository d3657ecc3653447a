"""PartitionSpec rules: DP over ("pod","data"), TP/EP over "model", PyTorch
port of ``repro.sharding.rules``.

Baseline sharding, as in the reference:

  * embeddings/unembed: vocab over "model"
  * attention/MLP in-projections: output features over "model"
  * out-projections: input features over "model"
  * MoE expert stacks: expert axis over "model" (expert parallelism)
  * FSDP (>=236B configs): the remaining large dim over "data"
  * KV caches: KV heads (else head_dim) over "model", batch over DP axes
  * recurrent states: feature dim over "model", batch over DP

Every rule is divisibility-guarded: a dim is only sharded if divisible by
the mesh axis size (e.g. qwen2.5's 40 heads shard as the flattened 5120-wide
head*dh dim, not the head count).

A spec is a ``PartitionSpec``: a tuple with, per tensor dim, a mesh axis
name, a tuple of names or ``None``; it compares ``==`` with the tuple of
the reference's ``jax.sharding.PartitionSpec``.  The rules read the axis
sizes from a torch ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or from
a ``ShapeMesh``, the counterpart of ``jax.sharding.AbstractMesh``, so specs
are computed without a process group.  ``to_placements`` turns a spec into
DTensor placements on a ``DeviceMesh``, ``distribute`` places a tree by a
tree of specs.  Trees are the port's dicts, lists and tuples; a leaf's path
is its dict keys and sequence indices from the root, as the reference's
jax key paths give them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or ``None``.  A
    tuple of one name is that name and an empty one ``None``, as JAX
    normalizes them."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, tuple) and len(a) <= 1:
                return a[0] if a else None
            return a
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes, no devices: ``jax.sharding.AbstractMesh``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``ShapeMesh``."""
    if isinstance(mesh, ShapeMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a mesh whose dims are named")
    return {n: mesh.size(i) for i, n in enumerate(names)}


def dp_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _div(n: int, shape: Dict[str, int], axis) -> bool:
    if axis is None:
        return True
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= shape[a]
    return size > 0 and n % size == 0


def _guard(spec_axes, dims, shape: Dict[str, int]) -> P:
    """Drop any axis the dim size doesn't divide."""
    return P(*(ax if (ax is not None and _div(d, shape, ax)) else None
               for d, ax in zip(dims, spec_axes)))


# parameter-name classes
_IN_PROJ = {
    "wq", "wk", "wv", "wg", "wi", "wog", "wuq", "wukv", "wzifo",
    "win1", "win2", "wa", "wx",
}
_OUT_PROJ = {"wo", "wout"}
_REPLICATED = {"router", "wkr", "wdq", "wdkv", "xgate", "b", "lam"}
_NORMS = ("qnorm", "knorm", "norm", "ln1", "ln2", "lnx", "final_norm", "enc_norm", "kvnorm")


def _leaf_spec(path, dims, shape: Dict[str, int], fsdp: bool, stack_depth: int) -> P:
    """path: dict keys and sequence indices from the root to this leaf."""
    fs = "data" if (fsdp and "data" in shape) else None
    names = [p for p in path if isinstance(p, str)]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    lead = (None,) * stack_depth
    nd = len(dims) - stack_depth
    body = dims[stack_depth:]
    replicated = P(*((None,) * len(dims)))

    def make(*axes):
        return _guard(lead + axes, dims, shape)

    if leaf in ("scale", "bias", "lam", "xgate") or parent in _NORMS:
        # norm params: shard 1-D over model only if large (d_rnn/d_inner)
        if nd == 1 and body[0] % max(shape.get("model", 1), 1) == 0 and body[0] >= 1024:
            return make("model")
        return replicated
    if leaf == "table":  # embedding (vocab, d)
        return make("model", fs)
    if parent == "unembed" and leaf == "w":
        return make(fs, "model")
    if parent == "router":
        return replicated
    if leaf == "w" and parent in _IN_PROJ:
        return make(fs, "model")
    if leaf == "w" and parent in _OUT_PROJ:
        return make("model", fs)
    if leaf == "w" and parent in _REPLICATED:
        return make(fs, None)
    if leaf == "w" and parent == "conv":
        return make(None, "model")
    if leaf in ("wg", "wi") and nd == 3:   # MoE experts (E, d, f)
        return make("model", fs, None)
    if leaf == "wo" and nd == 3:           # MoE experts (E, f, d)
        return make("model", None, fs)
    if leaf == "r" and nd == 4:            # sLSTM recurrent (4, H, dh, dh)
        return make(None, "model", None, None)
    if leaf == "b":
        return replicated
    # fallback: shard the largest dim over model if divisible
    if nd >= 1:
        body_axes: list = [None] * nd
        big = max(range(nd), key=lambda i: body[i])
        body_axes[big] = "model"
        return make(*body_axes)
    return replicated


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a dict / list / tuple tree (a
    ``PartitionSpec`` is a leaf; ``None`` stays ``None``), the tree's
    structure kept."""
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _stack_depth_of_path(path) -> int:
    """Params under groups/<g>/<pos> are stacked with one leading repeat axis."""
    return 1 if ("groups" in path or "enc_groups" in path) else 0


def param_specs(params_tree, mesh, fsdp: bool = False):
    """Tree of ``PartitionSpec`` matching ``params_tree``."""
    shape = mesh_shape(mesh)
    return map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), shape, fsdp,
                                      _stack_depth_of_path(path)),
        params_tree)


def cache_specs(cache_tree, mesh):
    """KV caches / recurrent states: batch over DP, features over model."""
    shape = mesh_shape(mesh)
    dp = dp_axes(mesh)

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        dims = tuple(leaf.shape)
        # all stacked caches have a leading (repeat,) axis then batch
        if name == "pos":
            return P(*((None,) * len(dims)))
        axes = [None] * len(dims)
        if len(dims) >= 2:
            axes[1] = dp if _div(dims[1], shape, dp) else None
        if len(dims) == 5:
            # (repeat, B, S, KV, dh) attention cache: prefer KV-head sharding
            # when divisible
            if _div(dims[3], shape, "model"):
                axes[3] = "model"
            elif _div(dims[4], shape, "model"):
                axes[4] = "model"
        elif len(dims) >= 3:
            last = len(dims) - 1
            axes[last] = "model" if _div(dims[last], shape, "model") else None
        return P(*axes)

    return map_with_path(spec, cache_tree)


def batch_spec(batch_tree, mesh):
    """Input batches: leading batch dim over DP axes."""
    shape = mesh_shape(mesh)
    dp = dp_axes(mesh)

    def spec(_, leaf):
        axes = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and _div(leaf.shape[0], shape, dp):
            axes[0] = dp
        return P(*axes)

    return map_with_path(spec, batch_tree)


def to_placements(spec, mesh):
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d names it, else ``Replicate()``; a mesh
    dim of size 1 holds the whole tensor, ``Replicate()``.  A dim sharded
    over several axes is split in the mesh's dim order (pod-major for
    ``("pod", "data")``, as in JAX); a spec naming them in another order
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    where = {}
    for d, ax in enumerate(spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} names mesh dims out of the mesh's order {names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[n]) if n in where and mesh.size(i) > 1 else Replicate()
                 for i, n in enumerate(names))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a spec on it, ``jax.sharding.NamedSharding``'s
    counterpart: the leaf of the tree that ``restore_checkpoint(...,
    shardings=)`` places a checkpoint by."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)


def named_shardings(specs, mesh):
    """A tree of specs (``param_specs``, ``cache_specs``, ...) as a tree of
    ``NamedSharding``s on ``mesh``."""
    return map_with_path(lambda _, spec: NamedSharding(mesh, spec), specs)


_REGISTERED = []


def register_strategies():
    """Register the DTensor sharding strategies the port's models need and
    DTensor lacks (once per process): ``aten.searchsorted`` (the MoE's
    ``route``) shards over any leading dim that both its inputs shard
    alike, else runs replicated; ``aten.log_sigmoid_forward`` and
    ``_backward`` (the mLSTM's and sLSTM's forget gates) are pointwise;
    ``aten.flip`` (in the backward of the mLSTM's cumsum; torch 2.11 has no
    strategy for it) keeps any shard of a dim it does not flip."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, values, *args, **kwargs):
        lead = min(sorted_sequence.ndim, values.ndim) - 1
        return [([Replicate()], [Replicate(), Replicate()])] + [
            ([Shard(d)], [Shard(d), Shard(d)]) for d in range(lead)]

    @register_sharding(torch.ops.aten.log_sigmoid_forward.default)
    def _log_sigmoid_forward(x):
        return [([Replicate()] * 2, [Replicate()])] + [
            ([Shard(d)] * 2, [Shard(d)]) for d in range(x.ndim)]

    @register_sharding(torch.ops.aten.flip.default)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        return [([Replicate()], [Replicate()] * 3)] + [
            ([Shard(d)], [Shard(d)] * 3) for d in range(x.ndim)]

    _REGISTERED.append(True)


def distribute(tree, specs, mesh, src_data_rank=0):
    """``tree``'s tensors as DTensors on ``mesh``, placed by the matching
    tree of specs.  Each rank passes the whole tensor, as
    ``distribute_tensor`` takes it: rank ``src_data_rank``'s is scattered,
    or with ``None`` each rank keeps its own shard of it, which moves
    nothing.  A DTensor (a prefill's caches) is redistributed to the spec.
    Registers ``register_strategies``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    register_strategies()

    def spec_at(path):
        s = specs
        for k in path:
            s = s[k]
        return s

    def place(path, t):
        placements = to_placements(spec_at(path), mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements)
        return distribute_tensor(t, mesh, placements, src_data_rank=src_data_rank)

    return map_with_path(place, tree)
