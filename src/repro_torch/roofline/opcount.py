"""Per-chip op costs of a PyTorch program: the counterpart of
``repro.roofline.hlo``.

The port has no HLO.  Its per-chip program is the stream of aten ops that
one rank dispatches, and ``count_ops()`` is a ``TorchDispatchMode`` that
sees each of them.  Under DTensor the mode steps aside for an op on
DTensors (it returns ``NotImplemented``), so DTensor runs it, and the mode
then sees the local ops on this rank's shards and the collectives DTensor
issues: the numbers are per chip, as the reference's per-partition module
is.  It sums, into an ``OpCosts`` with the keys of ``HloCosts.as_dict()``:

  * FLOPs: 2 * M * N * K per mm / addmm / bmm / baddbmm (times the batch),
    2 * out * (in_ch / groups) * kernel per convolution, from local shapes;
    those on fp32 (or fp64) operands also go to ``dot_flops_fp32``: the port
    runs them without TF32, on the CUDA cores, at another peak than bf16's;
  * HBM bytes: operand + result bytes per op.  Views (view, slice, select,
    transpose, unbind, expand, as_strided: any op whose result aliases an
    operand without writing it) and metadata queries (``prim::device``,
    which DTensor asks of every local tensor it wraps) charge nothing.  An
    in-place write charges the tensor it writes (a slice of a cache, not
    the cache) and what it reads; an indexed in-place write (index_put_, scatter_, index_add_,
    index_copy_) twice its other operands, not the target; a gather (index,
    gather, index_select, embedding) twice its result plus its indices.
    Eager PyTorch runs each op as a kernel of its own, a round trip through
    HBM, so this charges more than the reference does after XLA's fusion
    (``_op_traffic``): the port on the card, not an error;
  * collectives: tensor bytes and ring wire bytes per type, with the group
    size read from the op's group, by the reference's formulas:
        all-reduce      2 x bytes x (S-1)/S
        all-gather      result_bytes x (S-1)/S
        reduce-scatter  operand_bytes x (S-1)/S
        all-to-all      bytes x (S-1)/S
        collective-permute  bytes
    ``ring_scan``'s point-to-point exchanges (``batch_isend_irecv``) are no
    dispatcher ops: an entered counter listens to ``core.distributed``'s
    rotations and charges each as a collective-permute;
  * ``temp_bytes``: the peak of the live bytes of the results that the ops
    allocate (views and in-place results excluded), each freed when its
    tensor is: the counterpart of ``memory_analysis().temp_size_in_bytes``.

A Python loop dispatches every iteration, so each iteration is counted
as it runs.  The one exception is ``repeated(n)``: a loop of ``n``
identical steps on fake tensors (shapes only, no values) runs one step
inside it, which every entered counter charges ``n`` times, the
counterpart of a while loop's trip count in the reference's HLO; each such
loop adds one to ``num_while_loops``.

DTensor learns each op's output shape by running the op once more on
fake tensors of the global shapes (``ShardingPropagator.
_propagate_tensor_meta_non_cached``), under the active fake mode, so
through this counter when the dry-run's tensors are fake.  Those runs are
no work of the chip: while a counter is entered it wraps that method and
charges nothing inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.distributed import ROTATION_LISTENERS


_VIEWS = {
    "view", "_unsafe_view", "slice", "select", "transpose", "t", "permute",
    "unbind", "expand", "as_strided", "squeeze", "unsqueeze", "alias",
    "detach", "split", "split_with_sizes", "unsafe_split", "chunk", "narrow",
    "_reshape_alias", "unfold", "diagonal", "view_as_real", "view_as_complex",
    "lift_fresh", "_conj", "_neg_view", "wait_tensor", "_wrap_tensor_autograd",
}
_INDEXED_WRITES = {
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_add_", "index_copy_", "index_fill_",
    "masked_scatter_",
}
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}

# _c10d_functional op -> the reference's collective type
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_WIDE = (torch.float32, torch.float64)   # products off the tensor cores (no TF32)


@dataclasses.dataclass
class OpCosts:
    dot_flops: float = 0.0
    dot_flops_fp32: float = 0.0    # the part of dot_flops on fp32 / fp64 operands
    hbm_bytes: float = 0.0
    collective_tensor_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_by_type: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    bytes_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    num_while_loops: int = 0
    temp_bytes: int = 0            # peak live result bytes
    live_bytes: int = 0

    def as_dict(self):
        return {
            "dot_flops": self.dot_flops,
            "dot_flops_fp32": self.dot_flops_fp32,
            "hbm_bytes": self.hbm_bytes,
            "collective_tensor_bytes": self.collective_tensor_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_by_type": dict(self.collective_by_type),
            "collective_count": dict(self.collective_count),
            "bytes_by_op": dict(self.bytes_by_op),
            "num_while_loops": self.num_while_loops,
        }

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def wire_bytes(kind: str, result_bytes: float, operand_bytes: float, group_size: int) -> float:
    """Ring wire bytes per chip of one collective (the reference's formulas)."""
    frac = (group_size - 1) / group_size if group_size > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "reduce-scatter":
        return operand_bytes * frac
    if kind == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)   # collective-permute


def _charge_collective(costs: OpCosts, kind, result_bytes, operand_bytes, group_size) -> None:
    wire = wire_bytes(kind, result_bytes, operand_bytes, group_size)
    costs.collective_tensor_bytes += result_bytes
    costs.collective_wire_bytes += wire
    costs.collective_by_type[kind] += wire
    costs.collective_count[kind] += 1


def _group_size(func, args) -> int:
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    if "group_size" in named:
        return int(named["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(named["group_name"]).size()


def _dot_flops(name: str, args, out) -> Tuple[float, torch.dtype]:
    """(the product's FLOPs, its first operand's dtype); (0, None) for other ops."""
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
        batch = a.shape[0] if a.dim() == 3 else 1
        return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1], a.dtype
    if name in ("mv", "dot", "vdot"):
        return 2.0 * args[0].numel(), args[0].dtype
    if name in ("convolution", "_convolution"):
        x, w = args[0], args[1]
        transposed = bool(args[6])
        kernel = math.prod(w.shape[2:]) * w.shape[1]
        return 2.0 * (x.numel() if transposed else out.numel()) * kernel, x.dtype
    return 0.0, None


_ENTERED: list = []        # the counters entered, innermost last

_SUMMED = ("dot_flops", "dot_flops_fp32", "hbm_bytes", "collective_tensor_bytes", "collective_wire_bytes")
_KEYED = ("collective_by_type", "collective_count", "bytes_by_op")


@contextlib.contextmanager
def repeated(n: int):
    """What runs inside stands for ``n`` identical runs: each entered
    counter charges its FLOPs, bytes and collectives ``n`` times (the peak
    of live bytes is taken once)."""
    before = [(c, {f: getattr(c.costs, f) for f in _SUMMED}, {f: dict(getattr(c.costs, f)) for f in _KEYED})
              for c in _ENTERED]
    yield
    for counter, sums, keyed in before:
        costs = counter.costs
        for f, v in sums.items():
            setattr(costs, f, v + n * (getattr(costs, f) - v))
        for f, old in keyed.items():
            table = getattr(costs, f)
            for k in list(table):
                table[k] = old.get(k, 0) + n * (table[k] - old.get(k, 0))
        costs.num_while_loops += 1


class OpCounter(TorchDispatchMode):
    """A ``TorchDispatchMode`` that sums this rank's op costs into
    ``self.costs`` (an ``OpCosts``), and listens to ``core.distributed``'s
    ring rotations while it is entered."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.costs = OpCosts()
        self._propagating = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        saved = self._saved_propagate = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *args, **kwargs):
            self._propagating += 1
            try:
                return saved(prop, *args, **kwargs)
            finally:
                self._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        ROTATION_LISTENERS.append(self._rotation)
        _ENTERED.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved_propagate
        ROTATION_LISTENERS.remove(self._rotation)
        _ENTERED.remove(self)
        return super().__exit__(*exc)

    def _rotation(self, nbytes: int, group_size: int) -> None:
        """One ring rotation of ``nbytes`` per rank: its wire bytes as a
        collective-permute and its HBM traffic (read once, written once)."""
        _charge_collective(self.costs, "collective-permute", nbytes, nbytes, group_size)
        self.costs.hbm_bytes += 2 * nbytes
        self.costs.bytes_by_op["collective-permute"] += 2 * nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented     # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        if not self._propagating:
            self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        c = self.costs
        name = func._overloadpacket.__name__
        returns = func._schema.returns
        alias = [r.alias_info for r in returns if r.alias_info is not None]
        if name in _VIEWS or func.namespace == "prim" or (alias and not any(a.is_write for a in alias)):
            return
        in_place = any(a.is_write for a in alias)
        operands = _tensors((args, kwargs))
        results = _tensors(out)
        obytes = sum(_nbytes(t) for t in operands)
        rbytes = sum(_nbytes(t) for t in results)
        flops, dtype = _dot_flops(name, args, out)
        c.dot_flops += flops
        if dtype in _WIDE:
            c.dot_flops_fp32 += flops
        if func.namespace == "_c10d_functional" and name in _FUNCTIONAL:
            _charge_collective(c, _FUNCTIONAL[name], rbytes, obytes, _group_size(func, args))
        if name in _INDEXED_WRITES:
            traffic = 2.0 * (obytes - _nbytes(args[0]))
        elif name in _GATHERS:
            traffic = 2.0 * rbytes + sum(_nbytes(t) for t in operands[1:])
        elif name in _ALLOCS:
            traffic = 0.0
        else:
            traffic = float(obytes + rbytes)
        c.hbm_bytes += traffic
        c.bytes_by_op[name] += traffic
        if not in_place:
            for t in results:
                nb = _nbytes(t)
                c.live_bytes += nb
                weakref.finalize(t, c._free, nb)
            c.temp_bytes = max(c.temp_bytes, c.live_bytes)


def count_ops() -> OpCounter:
    """``with count_ops() as counter: ...`` then ``counter.costs``."""
    return OpCounter()
