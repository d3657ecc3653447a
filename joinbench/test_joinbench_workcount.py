"""The work counts against hand counts."""
from joinbench import workcount


def test_two_tiles_by_hand():
    # T = 2, 3 real dims in n_pad = 4 (two blocks of 2); pairs (0,0), (0,1), (1,1);
    # SHORTC skipped the second block of one pair: 6 blocks, 1 skipped
    flop, nbytes = workcount.join_work(pairs=3, tiles=2, blocks_total=6, blocks_skipped=1, num_dims=3, n_pad=4,
                                       dim_block=2, tile_size=2, out_bytes=5 * 4)
    # two pairs computed both blocks (3 real dims each), one the first (2 dims):
    # a pair is (2 T^2 + 4 T) per dim + 4 T^2 per block = 16 per dim + 16 per block
    assert flop == (16 * 3 + 16 * 2) * 2 + (16 * 2 + 16 * 1)
    # tiles: 2 x T x 3 dims x 4 B + lengths 2 x 4 B; pairs 3 x 8 B; 5 counts x 4 B
    assert nbytes == 2 * 2 * 3 * 4 + 2 * 4 + 3 * 8 + 5 * 4


def test_computed_dims_are_never_counted_high():
    assert workcount.computed_dims(5, 5, 16, 32, 32) == 5 * 16            # one block
    assert workcount.computed_dims(4, 8, 64, 64, 32) == 4 * 64            # nothing skipped
    assert workcount.computed_dims(4, 12, 90, 96, 32) == 4 * 90           # all three blocks, last partial
    # 4 pairs, 9 blocks of 3: at most 2 pairs ran all three (2 x 90 + 2 x 64 <= truth)
    assert workcount.computed_dims(4, 9, 90, 96, 32) == 9 * 32 - 2 * 6


def test_least_time_names_its_bound():
    assert workcount.least_time(67e12, 1.0) == (1.0, "operations")
    assert workcount.least_time(1.0, 3.35e12) == (1.0, "bytes")


def test_stats_of_a_count_and_a_pairs_join():
    st = {"num_dims": 16, "num_points": 1000, "execution": "indexed", "num_tiles": 20, "num_results": 0,
          "num_tile_pairs_evaluated": 50, "dim_blocks_total": 50, "dim_blocks_skipped": 0}
    flop, nbytes = workcount.stats_work(st, tile_size=64, dim_block=32, mode="count")
    assert flop == 50 * ((2 * 4096 + 256) * 16 + 4 * 4096)
    assert nbytes == 20 * 64 * 16 * 4 + 20 * 4 + 50 * 8 + 1002 * 4
    dense = dict(st, execution="dense", num_results=7)
    assert workcount.stats_work(dense, tile_size=64, dim_block=32, mode="pairs")[1] == \
        16 * 64 * 16 * 4 + 16 * 4 + 50 * 8 + 7 * 8
