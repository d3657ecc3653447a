"""PyTorch port vs the JAX package: the downstream paths on the CPU.

The EGO baseline (``repro_torch.core.ego``, numpy in both packages), the
token pipeline (``repro_torch.data.tokens``) and near-duplicate dedup
(``repro_torch.data.dedup`` over the port's ``self_join``, run with
``device="cpu"``) against ``repro``'s copies on the same inputs, with
``==``: EGO counts on 1/64-quantized points, token batches, embeddings bit
for bit, and dedup's keep / group_of / pair counts.
"""
import numpy as np
import pytest
import torch

from oracles import brute_counts, make_dataset, quantize
from repro.core import SelfJoinConfig as RefConfig
from repro.core import ego as ref_ego
from repro.data import dedup as ref_dedup
from repro.data import tokens as ref_tokens
from repro_torch.core import SelfJoinConfig, ego
from repro_torch.data import dedup
from repro_torch.data.tokens import TokenPipeline


@pytest.mark.parametrize("reorder", [True, False])
def test_ego_matches_reference_and_brute(dataset_case, reorder):
    name, d, eps = dataset_case
    np.testing.assert_array_equal(ego.ego_sort(d, eps, reorder), ref_ego.ego_sort(d, eps, reorder))
    got = ego.ego_join_counts(d, eps, reorder)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref_ego.ego_join_counts(d, eps, reorder), err_msg=name)
    np.testing.assert_array_equal(got, brute_counts(d, eps), err_msg=name)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(1000, 4, 16, 3), (50, 3, 7, 0), (2, 1, 1, 9)])
def test_token_pipeline_matches_reference(vocab, batch, seq, seed):
    port = TokenPipeline(vocab=vocab, batch=batch, seq=seq, seed=seed)
    ref = ref_tokens.TokenPipeline(vocab=vocab, batch=batch, seq=seq, seed=seed)
    it, ref_it = iter(port), iter(ref)
    for step in range(6):
        got, want = next(it), next(ref_it)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for key in got:
            assert got[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(port.batch_at(step)["tokens"], got["tokens"])  # resume = same stream
    assert got["tokens"].max() < vocab


def _planted(n_base, n_dups, seq=64, seed=0):
    """``tests/test_system.py``'s recipe: copies of the first ``n_dups``
    examples with every 17th token edited."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, (n_base, seq))
    dups = base[:n_dups].copy()
    dups[:, ::17] += 1
    return np.concatenate([base, dups])


@pytest.mark.parametrize("dim,n,seed", [(16, 3, 0), (32, 3, 1), (8, 2, 5)])
def test_hashed_ngram_embed_bit_for_bit(dim, n, seed):
    ex = _planted(30, 6, seed=seed)
    got = dedup.hashed_ngram_embed(ex, dim=dim, n=n, seed=seed)
    want = ref_dedup.hashed_ngram_embed(ex, dim=dim, n=n, seed=seed)
    assert got.dtype == np.float32 and got.shape == (ex.shape[0], dim)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("eps,exact", [(0.35, False), (0.2, False), (0.5, False), (0.0, True)])
def test_find_near_duplicates_matches_reference(eps, exact):
    """Raw embeddings away from eps = 0; at eps = 0 exact copies on the
    1/64 lattice, where every self pair's d2 is exactly 0 in fp32 (on raw
    floats it sits on the eps boundary, DESIGN.md #6)."""
    ex = _planted(60, 15, seed=2)
    if exact:
        ex = np.concatenate([ex, ex[:7], ex[:3]])
    emb = dedup.hashed_ngram_embed(ex, dim=16)
    if exact:
        emb = quantize(emb)
    got = dedup.find_near_duplicates(emb, eps, device="cpu")
    want = ref_dedup.find_near_duplicates(emb, eps)
    np.testing.assert_array_equal(got.keep, want.keep)
    np.testing.assert_array_equal(got.group_of, want.group_of)
    assert got.num_duplicate_pairs == want.num_duplicate_pairs
    assert got.stats.num_results == want.stats.num_results
    assert got.stats.num_candidates == want.stats.num_candidates
    if exact:
        assert got.num_duplicate_pairs == 7 + 2 * 3


def test_find_near_duplicates_with_a_config_matches_reference():
    emb = dedup.hashed_ngram_embed(_planted(50, 10, seed=6), dim=8)
    kw = dict(eps=0.3, k=3, tile_size=16, dim_block=8)
    got = dedup.find_near_duplicates(emb, 0.3, config=SelfJoinConfig(**kw), device="cpu")
    want = ref_dedup.find_near_duplicates(emb, 0.3, config=RefConfig(**kw))
    np.testing.assert_array_equal(got.group_of, want.group_of)
    assert got.num_duplicate_pairs == want.num_duplicate_pairs


def test_dedup_token_dataset_matches_reference():
    ex = _planted(40, 10, seed=7)
    got = dedup.dedup_token_dataset(ex, eps=0.35, embed_dim=16, device="cpu")
    np.testing.assert_array_equal(got, ref_dedup.dedup_token_dataset(ex, eps=0.35, embed_dim=16))


def test_dedup_finds_planted_duplicates():
    """``tests/test_system.py``'s planted-duplicate case, on the port."""
    examples = _planted(40, 10)
    emb = dedup.hashed_ngram_embed(examples, dim=16)
    res = dedup.find_near_duplicates(emb, eps=0.35, device="cpu")
    assert res.num_duplicate_pairs >= 8
    assert len(res.keep) <= 45
    deduped = dedup.dedup_token_dataset(examples, eps=0.35, embed_dim=16, device="cpu")
    assert deduped.shape[0] == len(res.keep)


def test_dedup_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    examples = _planted(10, 2)
    emb = dedup.hashed_ngram_embed(examples, dim=8)
    for call in (lambda: dedup.find_near_duplicates(emb, 0.3),
                 lambda: dedup.dedup_token_dataset(examples, eps=0.3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ego_on_larger_raw_data_matches_reference():
    """Unquantized points: both packages run the same numpy, so equal."""
    d = make_dataset("exponential", 1500, 16, seed=11).astype(np.float32)
    d = d + np.random.default_rng(1).random(d.shape, dtype=np.float32) * 1e-3
    np.testing.assert_array_equal(ego.ego_join_counts(d, 0.06), ref_ego.ego_join_counts(d, 0.06))
