// The self-join's candidate tile-pair list, written in its final order.
//
// Replaces no TPU kernel: the JAX package builds this list on the host
// (src/repro/core/grid.py:build_tile_plan, numpy expansion of cell pairs into
// tile pairs, the SORTIDU mask, then a lexsort by (A tile, B tile)).  The port
// builds it here because the host version was two thirds of an index build's
// set-up at a million points.
//
// No sort: cells are numbered in order and each cell's tiles are contiguous,
// so when each A tile walks the B tiles of its cell's adjacent cells in cell
// order (the CSR `adj_ptr` / `adj`, sorted by (cell, adjacent cell)), the
// pairs come out in (pair_a, pair_b) order.  The cell pairs are unique, so
// the tile pairs are too, and that order is the sorted one.
//
// One warp per A tile, its lanes over 32 B tiles at a time.  Pass 1
// (`tile_plan_count`) writes each A tile's kept count and its
// sum(len_a * len_b); the caller scans the counts into offsets; pass 2
// (`tile_plan_write`) walks the same B tiles again and writes the kept
// pairs at the offsets, keeping the walk's order inside the warp with a
// ballot prefix.  SORTIDU is numpy's test in float32 with the same
// operations: max(u_lo[b] - u_hi[a], u_lo[a] - u_hi[b]) <= eps, written as
// two comparisons (the same result, NaN included: a NaN gap prunes).
//
// Bound on an H100: the bytes written.  Pass 2 writes 8 bytes a kept pair
// (1.4 GB for Syn16D2M's 175M pairs at a million points, ~0.42 ms at
// 3.35 TB/s); the tables it reads (two floats and a length a tile) stay in
// L1 / L2, and pass 1 writes 16 bytes an A tile.  Lanes past the end of a
// small cell idle, which costs issue slots, not bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kWrite>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tile_plan_kernel(const int* __restrict__ tile_cell, const int* __restrict__ tile_len,
                 const float* __restrict__ u_lo, const float* __restrict__ u_hi,
                 const int* __restrict__ cell_tile_first, const int* __restrict__ cell_tiles,
                 const long long* __restrict__ adj_ptr, const int* __restrict__ adj,
                 int num_tiles, int sortidu, float eps,
                 long long* __restrict__ kept, long long* __restrict__ cand,
                 const long long* __restrict__ offsets,
                 int* __restrict__ pair_a, int* __restrict__ pair_b) {
  const int a = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (a >= num_tiles) return;  // the whole warp: `a` is uniform across it
  const int c = tile_cell[a];
  const float a_lo = u_lo[a], a_hi = u_hi[a];
  const unsigned below = (1u << lane) - 1u;
  long long out = kWrite ? offsets[a] : 0;
  long long len_b = 0;
  for (long long j = adj_ptr[c]; j < adj_ptr[c + 1]; ++j) {
    const int cb = adj[j];
    const int b0 = cell_tile_first[cb], nb = cell_tiles[cb];
    for (int base = 0; base < nb; base += 32) {  // uniform bounds: every lane votes
      const int i = base + lane;
      const int b = b0 + i;
      bool keep = i < nb;
      if (keep && sortidu) keep = (u_lo[b] - a_hi <= eps) && (a_lo - u_hi[b] <= eps);
      const unsigned vote = __ballot_sync(0xffffffffu, keep);
      if (kWrite) {
        if (keep) {
          const long long at = out + __popc(vote & below);
          pair_a[at] = a;
          pair_b[at] = b;
        }
      } else if (keep) {
        len_b += tile_len[b];
      }
      out += __popc(vote);
    }
  }
  if (!kWrite) {
    for (int s = 16; s > 0; s >>= 1) len_b += __shfl_down_sync(0xffffffffu, len_b, s);
    if (lane == 0) {
      kept[a] = out;
      cand[a] = len_b * tile_len[a];
    }
  }
}

template <bool kWrite>
int launch(const int* tile_cell, const int* tile_len, const float* u_lo, const float* u_hi,
           const int* cell_tile_first, const int* cell_tiles, const long long* adj_ptr, const int* adj,
           int num_tiles, int sortidu, float eps, long long* kept, long long* cand,
           const long long* offsets, int* pair_a, int* pair_b, cudaStream_t stream) {
  const int blocks = (num_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tile_plan_kernel<kWrite><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj, num_tiles, sortidu, eps,
      kept, cand, offsets, pair_a, pair_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1: kept[a] (pairs of A tile a that SORTIDU keeps) and
// cand[a] = len_a * sum of len_b over them, both int64.
extern "C" int tile_plan_count(const int* tile_cell, const int* tile_len, const float* u_lo,
                               const float* u_hi, const int* cell_tile_first, const int* cell_tiles,
                               const long long* adj_ptr, const int* adj, int num_tiles, int sortidu,
                               float eps, long long* kept, long long* cand, void* stream) {
  return launch<false>(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj,
                       num_tiles, sortidu, eps, kept, cand, nullptr, nullptr, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// Pass 2: the kept pairs of A tile a at pair_a / pair_b[offsets[a] ...], in
// the walk's order.
extern "C" int tile_plan_write(const int* tile_cell, const int* tile_len, const float* u_lo,
                               const float* u_hi, const int* cell_tile_first, const int* cell_tiles,
                               const long long* adj_ptr, const int* adj, int num_tiles, int sortidu,
                               float eps, const long long* offsets, int* pair_a, int* pair_b,
                               void* stream) {
  return launch<true>(tile_cell, tile_len, u_lo, u_hi, cell_tile_first, cell_tiles, adj_ptr, adj,
                      num_tiles, sortidu, eps, nullptr, nullptr, offsets, pair_a, pair_b,
                      static_cast<cudaStream_t>(stream));
}
