// K2 (and K1's earlier kernel): candidate tile-pair evaluation with SHORTC,
// mask and counts mode.
//
// Replaces the TPU kernel src/repro/kernels/distance_tile.py:tile_pair_distance
// (body `_mask_kernel`; and `_kernel` until distance_tile_counts.cu took
// K1's counts: `distance_tile_counts` below stays to compare the two on the
// card, and nothing on the main path launches it).  One thread block per
// candidate tile pair; the dim-block grid axis of the Pallas kernel becomes a loop inside the
// block that stops early once the block-wide min of d2 over valid lanes
// exceeds eps^2 (see tile_eval.cuh for the layout and the numerics).
//
// Bound on an H100: at T = 64 and n_pad = 32 a tile pair reads 2 x 8 KB of
// tiles (mostly from L2: consecutive pairs share the A tile) and does
// 2 T^2 n_pad = 262k flop per computed block, so the whole call is bound by
// fp32 CUDA-core throughput (67 TFLOP/s), not by HBM (3.35 TB/s).  The design
// keeps the d2 tile in registers, reads each staged slice from shared memory
// once per 16 x 16 thread grid step, and never writes d2 to memory; only
// counts (P x T int32), skipped (P int32) and, in mask mode, the P x T x T
// int8 mask are written to device memory.  The loop runs over all n_pad dims,
// zero padding included: at the 16 real dims of Syn16D2M half the FMAs are
// spent on padding, which the bound in chip_smoke.py does not count.
#include "tile_eval.cuh"

extern "C" int distance_tile_counts(const float* tiles, const int* tile_len,
                                    const int* pair_a, const int* pair_b,
                                    int num_pairs, int t, int n_pad,
                                    int dim_block, float eps2, int* counts,
                                    int* skipped, void* stream) {
  return tile_eval::launch<true, false, false>(
      tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, dim_block, eps2,
      counts, skipped, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int distance_tile_mask(const float* tiles, const int* tile_len,
                                  const int* pair_a, const int* pair_b,
                                  int num_pairs, int t, int n_pad,
                                  int dim_block, float eps2, int* counts,
                                  int* skipped, int8_t* mask, void* stream) {
  return tile_eval::launch<true, false, true>(
      tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, dim_block, eps2,
      counts, skipped, mask, static_cast<cudaStream_t>(stream));
}
