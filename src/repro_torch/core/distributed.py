"""Distributed self-join: entity partitioning + ring pass (paper Sec. 6.2/6.3),
PyTorch port.

The paper's strategy for |D| exceeding one device:

  * every node starts with an entity-partitioned query shard Q_k of |D|/|p|
    points and a copy E_k of the same shard;
  * |p| rounds of BSP supersteps: join Q_k against the entry set currently
    held, then send it to node (k+1) mod |p| and receive from (k-1) mod |p|.

The JAX package maps this onto ``shard_map`` + ``jax.lax.ppermute``; here
every ring position is one process of a ``torch.distributed`` group, and
the rotation is one ``dist.batch_isend_irecv`` per round boundary (send
to the next position, receive from the previous one), so peak memory per
rank stays at two shards and the transport totals (|p|-1)|D| points.  With
``overlap=True`` the exchange of round r+1 is issued before round r's body
and waited on after it (the paper's Fig. 4 pipeline).

The ring is a ``Ring``: the global ranks of its positions in order and the
process group they share.  ``ring_of`` derives it from a ``ProcessGroup``
(positions in group-rank order) or from a ``DeviceMesh`` and the names of
the dims the ring spans, row-major over those dims in the order named, as
the JAX package's ring spans its mesh axes: a 1-D ``("data",)`` mesh and
the joint ``("pod", "data")`` dims of a 2-D mesh both work.  The caller
creates and owns the process group; nothing here initialises one.

This module owns the ring transport (``ring_scan``, whose payload is any
tensor or list / tuple / dict of tensors), the two collectives the fused
ring agrees by (``ring_all_gather``, ``ring_broadcast``; tensors travel
where ``carrier_device`` says the group's backend carries them) and the
dense reference on the ring (``make_ring_counts_fn`` /
``ring_self_join_counts``): the payload is the raw point block and the
local join a row-blocked brute-force count.  The grid-indexed distributed
join is ``core/dist_engine.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.core.snapshot import resolve_device

AxisNames = Union[str, Tuple[str, ...]]

# callables (bytes per rank, ring size) told of each ring rotation: the
# exchange is no dispatcher op, so a dispatch-mode op counter listens here
ROTATION_LISTENERS: List[Callable[[int, int], None]] = []


def _axes_tuple(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _local_counts(q: torch.Tensor, e: torch.Tensor, eps2, row_block: int = 1024) -> torch.Tensor:
    """Per-q counts of e-points within eps (matmul form, row-blocked).

    Rows of ``q`` are zero-padded to a multiple of ``row_block`` and each
    block's ``|q|^2 + |e|^2 - 2 q e^T`` is compared with ``eps2`` in fp32.
    The matmul must run in IEEE fp32 (PyTorch's default; TF32 matmuls must
    stay off) for the counts to be exact on 1/64-quantized data.
    """
    nq = q.shape[0]
    if nq == 0:
        return torch.zeros(0, dtype=torch.int32, device=q.device)
    ne_norm = (e * e).sum(1)
    pad = (-nq) % row_block
    qp = torch.nn.functional.pad(q, (0, 0, 0, pad))
    out = []
    for qb in qp.reshape(-1, row_block, q.shape[1]):
        d2 = (qb * qb).sum(1)[:, None] + ne_norm[None, :] - 2.0 * (qb @ e.T)
        out.append((d2 <= eps2).sum(1, dtype=torch.int32))
    return torch.cat(out)[:nq]


def _ring_perm(size: int) -> Sequence[Tuple[int, int]]:
    return [(j, (j + 1) % size) for j in range(size)]


@dataclasses.dataclass(frozen=True)
class Ring:
    """One rank's ring: the global ranks of the positions, in ring order,
    this rank's position, and the process group they share (``None``: the
    default group)."""

    ranks: Tuple[int, ...]
    position: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def next(self) -> int:
        """Global rank of the position this one sends to, (j + 1) mod |p|."""
        return self.ranks[_ring_perm(self.size)[self.position][1]]

    @property
    def prev(self) -> int:
        """Global rank of the position this one receives from, (j - 1) mod |p|."""
        return self.ranks[(self.position - 1) % self.size]


def ring_of(mesh, axes: AxisNames = "data") -> Ring:
    """This rank's ``Ring`` over ``mesh``.

    ``mesh`` is a ``ProcessGroup`` (the ring follows its group ranks;
    ``axes`` is not read) or a ``DeviceMesh``, whose dims named by ``axes``
    the ring spans, row-major in the order named.  A ring over several dims
    must span the whole mesh, and the mesh the whole default group, whose
    point-to-point ops it then uses.
    """
    if isinstance(mesh, dist.ProcessGroup):
        ranks = tuple(dist.get_process_group_ranks(mesh))
        return Ring(ranks=ranks, position=dist.get_rank(mesh), group=mesh)
    axes_t = _axes_tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes_t if a not in names]
    if missing:
        raise ValueError(f"mesh has no dims named {missing}; it has {names}")
    ring_dims = [names.index(a) for a in axes_t]
    other = [i for i in range(mesh.ndim) if i not in ring_dims]
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    grid = mesh.mesh.permute(*other, *ring_dims)
    for i in other:
        grid = grid[coord[i]]
    ranks = tuple(int(r) for r in grid.reshape(-1).tolist())
    if len(axes_t) == 1:
        group = mesh.get_group(ring_dims[0])
    else:
        if other or len(ranks) != dist.get_world_size():
            raise ValueError(
                "a ring over several mesh dims must span the whole mesh and "
                "the whole default process group"
            )
        group = None
    return Ring(ranks=ranks, position=ranks.index(dist.get_rank()), group=group)


def _issue_rotation(ring: Ring, payload):
    """Post the exchange that moves ``payload`` one position forward.

    Returns the payload as it will arrive and what ``_finish_rotation``
    waits on (the works, and the ops that hold the buffers until then).
    The exchange is no dispatcher op, so each of ``ROTATION_LISTENERS``
    (an entered ``roofline.count_ops()``) is told its bytes per rank and
    the ring's size.
    """
    leaves, spec = pytree.tree_flatten(payload)
    if ROTATION_LISTENERS:
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        for listener in ROTATION_LISTENERS:
            listener(nbytes, ring.size)
    recv = [torch.empty_like(x) for x in leaves]
    ops = []
    for x, y in zip(leaves, recv):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), ring.next, ring.group))
        ops.append(dist.P2POp(dist.irecv, y, ring.prev, ring.group))
    return pytree.tree_unflatten(recv, spec), (dist.batch_isend_irecv(ops), ops)


def _finish_rotation(pending) -> None:
    works, _ = pending
    for w in works:
        w.wait()


def carrier_device(ring: Ring, device) -> torch.device:
    """Where ``ring``'s group carries the tensors of a rank that computes on
    ``device``: the card itself under NCCL, host memory under gloo (which
    sends no CUDA tensor).  Read from the backend of the group the caller
    passed; any other pairing raises, and nothing falls back."""
    dev = torch.device(device)
    backend = str(dist.get_backend(ring.group))
    if dev.type == "cuda" and "nccl" in backend:
        return dev
    if "gloo" in backend:
        return torch.device("cpu")
    raise ValueError(f"a {backend!r} group cannot carry the tensors of a rank computing on {dev}")


def _group_index(ring: Ring) -> Sequence[int]:
    """Index, in a collective's per-rank output list, of each ring position."""
    if ring.group is None:
        return list(ring.ranks)
    return [dist.get_group_rank(ring.group, r) for r in ring.ranks]


def ring_all_gather(ring: Ring, x: torch.Tensor) -> torch.Tensor:
    """Every position's ``x`` (one shape on every rank), stacked in ring
    order as ``(|p|, *x.shape)`` on ``x``'s device."""
    y = x.to(carrier_device(ring, x.device)).contiguous()
    out = [torch.empty_like(y) for _ in range(ring.size)]
    dist.all_gather(out, y, group=ring.group)
    return torch.stack([out[i] for i in _group_index(ring)]).to(x.device)


def ring_broadcast(ring: Ring, x: torch.Tensor, position: int) -> torch.Tensor:
    """``x`` as ring position ``position`` holds it, on every rank (``x``'s
    shape and dtype on every rank), on ``x``'s device."""
    y = x.to(carrier_device(ring, x.device), copy=True).contiguous()
    dist.broadcast(y, src=ring.ranks[position], group=ring.group)
    return y.to(x.device)


def ring_scan(ring: Ring, body, carry, payload, *, num_rounds=None, overlap=False):
    """Generic BSP ring, run by every rank of ``ring``.

    Runs ``num_rounds`` (default: the ring size) supersteps of

        carry = body(round, carry, payload)

    moving ``payload`` -- a tensor or a list / tuple / dict of tensors,
    of the same shapes on every rank -- one ring position forward (sent to
    ``(j + 1) mod |p|``, received from ``(j - 1) mod |p|``) between rounds.
    After the last round nothing moves: no later round would read it.
    With ``overlap=True`` the exchange for round r+1 is issued before round
    r's body and waited on after it (the paper's Fig. 4 pipeline); the body
    must then not write to the payload.  A one-position ring is the
    identity and issues no point-to-point op.  Each exchange (its wait,
    with ``overlap``) is a ``ring.exchange`` span.
    """
    n = ring.size if num_rounds is None else int(num_rounds)
    moves = ring.size > 1
    for r in range(n):
        rotate = moves and r < n - 1
        if rotate and overlap:
            arriving, pending = _issue_rotation(ring, payload)
        carry = body(r, carry, payload)
        if rotate:
            with obs.span("ring.exchange", "ring", round=r):
                if not overlap:
                    arriving, pending = _issue_rotation(ring, payload)
                _finish_rotation(pending)
            payload = arriving
    return carry


def make_ring_counts_fn(
    mesh, axes: AxisNames, eps: float, row_block: int = 1024, *, overlap: bool = False
):
    """The ring-join counts program of this rank over ``mesh``.

    Returns ``fn(d_block)``: ``d_block`` is this rank's entity-partition
    shard (the same number of rows on every rank), the result its points'
    neighbour counts (self included) over the whole ring, int32 on
    ``d_block``'s device.  ``overlap`` is ``ring_scan``'s.
    """
    ring = ring_of(mesh, axes)
    eps2 = float(eps) ** 2

    def local(d_block):
        q = d_block

        def body(_, counts, e):
            return counts + _local_counts(q, e, eps2, row_block)

        counts0 = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        return ring_scan(ring, body, counts0, q, overlap=overlap)

    return local


def ring_self_join_counts(
    d: np.ndarray,
    eps: float,
    mesh,
    axes: AxisNames = "data",
    row_block: int = 1024,
    *,
    device="cuda",
    overlap: bool = False,
) -> np.ndarray:
    """Driver, called by every rank of the ring with the whole ``d``: pad to
    the partition size, run this rank's shard around the ring on
    ``device``, gather every shard's counts, unpad.

    Padding points sit at coordinate 3 + i(2 eps + 1) per row -- farther
    than any possible eps-match to data in [0,1] and to each other, so they
    contribute nothing to real counts and their own counts are sliced away.
    ``mesh`` is a ``ProcessGroup`` or a ``DeviceMesh`` (see ``ring_of``);
    ``device`` is where this rank computes (``"cuda"``: the current card;
    the group's backend must carry tensors of that device); ``overlap`` is
    ``ring_scan``'s.  Returns int64 counts in ``d``'s row order on every
    rank.
    """
    dev = resolve_device(device)
    pts = np.asarray(d, dtype=np.float32)
    n_pts, n_dims = pts.shape
    ring = ring_of(mesh, axes)
    psize = ring.size
    pad = (-n_pts) % psize
    if pad:
        sentinel = 3.0 + (np.arange(pad, dtype=np.float32) * (2.0 * eps + 1.0))
        pts = np.concatenate(
            [pts, np.tile(sentinel[:, None], (1, n_dims))], axis=0
        )
    per = pts.shape[0] // psize
    mine = torch.from_numpy(
        np.ascontiguousarray(pts[ring.position * per:(ring.position + 1) * per])
    ).to(dev)
    counts = make_ring_counts_fn(mesh, axes, eps, row_block, overlap=overlap)(mine)
    full = ring_all_gather(ring, counts).reshape(-1)
    return full.cpu().numpy()[:n_pts].astype(np.int64)


def ring_comm_elements(num_points: int, num_workers: int) -> int:
    """Paper Sec. 6.3: total elements communicated = (|p| - 1) |D|."""
    return (num_workers - 1) * num_points
