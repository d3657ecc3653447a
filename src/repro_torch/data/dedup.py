"""Near-duplicate detection over example embeddings -- the paper's self-join
as a first-class framework feature (DESIGN.md #3).

Training pipelines embed examples (any encoder; here a deterministic hashed
n-gram projection so the pipeline is self-contained) and run the distance
self-join with eps as the near-dup radius.  Connected pairs are grouped
greedily and only one representative per group is kept -- the standard
embedding-dedup stage of LM data pipelines, powered by GPU-Join instead of
an LSH approximation (exact within eps).

A copy of the JAX package's ``repro.data.dedup`` over the port's
``self_join``: the join runs on ``device`` (default ``"cuda"``; without a
card the entry points raise unless ``device="cpu"`` is given), the
embedding and the union-find on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import SelfJoinConfig, resolve_device, self_join


def hashed_ngram_embed(
    token_ids: np.ndarray, dim: int = 32, n: int = 3, seed: int = 0
) -> np.ndarray:
    """(num_examples, seq) int tokens -> (num_examples, dim) float32 in [0,1].

    Deterministic hashed n-gram count projection, L2-ish normalized then
    squashed into the unit cube (the join's expected domain).
    """
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(64, dim)).astype(np.float32)
    out = np.zeros((token_ids.shape[0], dim), np.float32)
    for i, row in enumerate(np.asarray(token_ids)):
        acc = np.zeros(dim, np.float32)
        for j in range(len(row) - n + 1):
            h = hash(tuple(int(x) for x in row[j : j + n])) % 64
            acc += proj[h]
        norm = np.linalg.norm(acc)
        if norm > 0:
            acc /= norm
        out[i] = acc
    return ((out + 1.0) * 0.5).astype(np.float32)


@dataclasses.dataclass
class DedupResult:
    keep: np.ndarray            # indices of retained examples
    group_of: np.ndarray        # (N,) group id per example
    num_duplicate_pairs: int
    stats: object               # SelfJoinStats of the underlying join


def find_near_duplicates(
    embeddings: np.ndarray,
    eps: float,
    *,
    config: Optional[SelfJoinConfig] = None,
    device="cuda",
) -> DedupResult:
    """Group examples whose embeddings are within eps; keep the first of
    each group (greedy union-find over the join's pair output)."""
    n = embeddings.shape[0]
    cfg = config or SelfJoinConfig(
        eps=eps, k=min(6, embeddings.shape[1]), tile_size=32
    )
    res = self_join(embeddings, cfg, return_pairs=True, device=device)

    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    dup_pairs = 0
    for a, b in res.pairs:
        if a == b:
            continue
        dup_pairs += 1
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    group_of = np.array([find(i) for i in range(n)])
    keep = np.unique(group_of)
    return DedupResult(
        keep=keep, group_of=group_of,
        num_duplicate_pairs=dup_pairs // 2, stats=res.stats,
    )


def dedup_token_dataset(
    examples: np.ndarray, eps: float = 0.05, embed_dim: int = 16, *, device="cuda"
) -> np.ndarray:
    """Convenience: embed token examples, join, return deduped examples."""
    resolve_device(device)  # raise before the embedding, not after it
    emb = hashed_ngram_embed(examples, dim=embed_dim)
    res = find_near_duplicates(emb, eps, device=device)
    return examples[res.keep]
