// K3 / K4: dense tile-pair evaluation, counts and mask mode.
//
// Replaces the TPU kernel src/repro/kernels/dense_tile.py:dense_tile_distance
// (bodies `_kernel` and `_mask_kernel`).  The same block-per-tile-pair body as
// distance_tile.cu (tile_eval.cuh) with no SHORTC branch: every dim block is
// accumulated, and d2 is clamped at 0 before the eps test (the clamped matmul
// identity, dense_tile.py:78), which keeps self and duplicate pairs at tiny
// eps on raw fp32 data.
//
// Bound on an H100: the dense tier lists the full tile cross product, so every
// pair costs 2 T^2 n_pad flop on the fp32 CUDA cores (67 TFLOP/s) against
// 2 T n_pad x 4 bytes of tile reads, most of which hit L2 because the plan
// walks all B tiles for one A tile in a row: operation-bound.  The design
// keeps d2 in registers and writes only counts (and the int8 mask).  As in
// distance_tile.cu, the zero-padded dims past the real n are computed too.
#include "tile_eval.cuh"

extern "C" int dense_tile_counts(const float* tiles, const int* tile_len,
                                 const int* pair_a, const int* pair_b,
                                 int num_pairs, int t, int n_pad, int dim_block,
                                 float eps2, int* counts, void* stream) {
  return tile_eval::launch<false, true, false>(
      tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, dim_block, eps2,
      counts, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int dense_tile_mask(const float* tiles, const int* tile_len,
                               const int* pair_a, const int* pair_b,
                               int num_pairs, int t, int n_pad, int dim_block,
                               float eps2, int* counts, int8_t* mask,
                               void* stream) {
  return tile_eval::launch<false, true, true>(
      tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, dim_block, eps2,
      counts, nullptr, mask, static_cast<cudaStream_t>(stream));
}
