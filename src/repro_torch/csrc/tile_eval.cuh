// Shared body of the tile-pair distance kernels (distance_tile.cu, dense_tile.cu).
//
// One thread block evaluates one candidate tile pair (A, B) of T points each:
// d2 = |a|^2 + |b|^2 - 2 a.b^T accumulated over `dim_block`-wide blocks of the
// n_pad coordinate dimensions, then per-row neighbour counts (and, in mask
// mode, the T x T int8 hit mask) under a runtime eps^2.  Three compile-time
// switches give the four kernels of the two Pallas sources:
//
//   SHORTC  after every computed dim block, a block-wide min of d2 over valid
//           lanes; once it exceeds eps^2 every pair is decided and the block
//           stops (the indexed tier; `skipped` = blocks never computed).
//   CLAMP   d2 = max(d2, 0) before the eps test (the dense tier's clamped
//           matmul identity).
//   MASK    also write the (T, T) int8 hit mask (pairs mode).
//
// Layout: 256 threads as a 16 x 16 grid; thread (ty, tx) owns the d2
// elements (ty + 16 i, tx + 16 j) for i, j < R, with R = ceil(T / 16), in
// registers.  Each dim block is staged through shared memory in slices of at
// most kStage dimensions (any dim_block works; shared memory stays static),
// stored dimension-major with a padded pitch so the transposing store is free
// of bank conflicts and the reads broadcast (A) or hit 16 distinct banks (B).
// The products run in fp32 FMA on the CUDA cores: no tensor cores and no
// TF32, because the exactness contract (DESIGN.md #6) needs IEEE fp32.
//
// Numerics: per block the fold is ((d2 + na) + nb) - 2 prod in that order,
// with the intrinsics below so nvcc cannot contract it into an FMA -- the
// order of the Pallas kernel (distance_tile.py:82).  On 1/64-quantized data
// every term is exact and the result equals the reference bit for bit; on raw
// fp32 data the dot products sum in another order than XLA's, so a count may
// differ only for pairs whose float64 d2 lies within a relative 1e-5 of eps^2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_eval {

constexpr int kThreads = 256;
constexpr int kSide = 16;          // thread grid is kSide x kSide
constexpr int kMaxT = 128;         // largest tile size (R = 8)
constexpr int kStage = 32;         // dims per shared-memory slice
constexpr float kNegLarge = 3.0e38f;  // invalid lanes in the SHORTC min (distance_tile.py:34)

template <int R, bool SHORTC, bool CLAMP, bool MASK>
__global__ void __launch_bounds__(kThreads)
tile_pair_kernel(const float* __restrict__ tiles,     // (num_tiles, t, n_pad)
                 const int* __restrict__ tile_len,    // (num_tiles,)
                 const int* __restrict__ pair_a,      // (P,)
                 const int* __restrict__ pair_b,      // (P,)
                 int t, int n_pad, int dim_block, float eps2,
                 int* __restrict__ counts,            // (P, t)
                 int* __restrict__ skipped,           // (P,), SHORTC only
                 int8_t* __restrict__ mask)           // (P, t, t), MASK only
{
  constexpr int RS = R * kSide;  // rows/cols covered by the thread grid (>= t)
  static_assert(2 * kStage * (RS + 1) * sizeof(float) >= RS * RS, "mask staging");
  __shared__ __align__(16) float ab_s[2][kStage][RS + 1];
  __shared__ float na_s[RS];
  __shared__ float nb_s[RS];
  __shared__ float red_s[kThreads / 32];
  float(*a_s)[RS + 1] = ab_s[0];
  float(*b_s)[RS + 1] = ab_s[1];
  // the mask is staged in the slice buffers once the last slice has been read
  int8_t* m_s = reinterpret_cast<int8_t*>(&ab_s[0][0][0]);

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const int p = blockIdx.x;
  const int ta = pair_a[p];
  const int tb = pair_b[p];
  const int la = min(tile_len[ta], t);
  const int lb = min(tile_len[tb], t);
  const float* A = tiles + (size_t)ta * t * n_pad;
  const float* B = tiles + (size_t)tb * t * n_pad;

  float d2[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) d2[i][j] = 0.f;

  const int num_blocks = n_pad / dim_block;
  int computed = 0;
  for (int blk = 0; blk < num_blocks; ++blk) {
    float prod[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) prod[i][j] = 0.f;
    float norm = 0.f;  // |row|^2 over this block: A row `tid` or B row `tid - t`

    const int d_end = (blk + 1) * dim_block;
    for (int k0 = blk * dim_block; k0 < d_end; k0 += kStage) {
      const int kn = min(kStage, d_end - k0);
      __syncthreads();  // previous slice fully read
      for (int idx = tid; idx < RS * kn; idx += kThreads) {
        const int r = idx / kn;
        const int k = idx - r * kn;
        const bool in = r < t;
        a_s[k][r] = in ? A[(size_t)r * n_pad + k0 + k] : 0.f;
        b_s[k][r] = in ? B[(size_t)r * n_pad + k0 + k] : 0.f;
      }
      __syncthreads();
      if (tid < t) {
        for (int k = 0; k < kn; ++k) norm += a_s[k][tid] * a_s[k][tid];
      } else if (tid < 2 * t) {
        for (int k = 0; k < kn; ++k) norm += b_s[k][tid - t] * b_s[k][tid - t];
      }
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        float av[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) av[i] = a_s[k][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = b_s[k][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) prod[i][j] = fmaf(av[i], bv[j], prod[i][j]);
      }
    }
    if (tid < t) {
      na_s[tid] = norm;
    } else if (tid < 2 * t) {
      nb_s[tid - t] = norm;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        d2[i][j] = __fsub_rn(
            __fadd_rn(__fadd_rn(d2[i][j], na_s[ty + kSide * i]), nb_s[tx + kSide * j]),
            __fmul_rn(2.f, prod[i][j]));
    ++computed;

    if (SHORTC) {
      float m = kNegLarge;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (ty + kSide * i < la && tx + kSide * j < lb) m = fminf(m, d2[i][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((tid & 31) == 0) red_s[tid >> 5] = m;
      __syncthreads();
      float bm = red_s[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) bm = fminf(bm, red_s[w]);
      // every thread reads the same bm, so the break is uniform; red_s is
      // rewritten only after the next slice's __syncthreads
      if (bm > eps2) break;
    }
  }

  if (SHORTC && tid == 0) skipped[p] = num_blocks - computed;

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + kSide * i;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + kSide * j;
      const float v = CLAMP ? fmaxf(d2[i][j], 0.f) : d2[i][j];
      const bool hit = r < la && c < lb && v <= eps2;
      cnt += hit ? 1 : 0;
      // safe: every read of a_s/b_s precedes the __syncthreads before the last fold
      if (MASK && r < t && c < t) m_s[r * t + c] = hit ? 1 : 0;
    }
    // the 16 threads of one row are one aligned half-warp
#pragma unroll
    for (int off = kSide / 2; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (tx == 0 && r < t) counts[(size_t)p * t + r] = cnt;
  }

  if (MASK) {
    __syncthreads();
    const int tt = t * t;
    int8_t* out = mask + (size_t)p * tt;
    if (tt % 16 == 0) {  // 16-byte stores, consecutive threads on consecutive words
      const uint4* src = reinterpret_cast<const uint4*>(m_s);
      uint4* dst = reinterpret_cast<uint4*>(out);
      for (int w = tid; w < tt / 16; w += kThreads) dst[w] = src[w];
    } else {
      for (int w = tid; w < tt; w += kThreads) out[w] = m_s[w];
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() as an int (0 on success).
template <bool SHORTC, bool CLAMP, bool MASK>
int launch(const float* tiles, const int* tile_len, const int* pair_a,
           const int* pair_b, int num_pairs, int t, int n_pad, int dim_block,
           float eps2, int* counts, int* skipped, int8_t* mask,
           cudaStream_t stream) {
  if (t < 1 || t > kMaxT || dim_block < 1 || n_pad % dim_block != 0)
    return (int)cudaErrorInvalidValue;
  if (num_pairs == 0) return 0;
  const dim3 grid(num_pairs);
  if (t <= 16) {
    tile_pair_kernel<1, SHORTC, CLAMP, MASK><<<grid, kThreads, 0, stream>>>(
        tiles, tile_len, pair_a, pair_b, t, n_pad, dim_block, eps2, counts, skipped, mask);
  } else if (t <= 32) {
    tile_pair_kernel<2, SHORTC, CLAMP, MASK><<<grid, kThreads, 0, stream>>>(
        tiles, tile_len, pair_a, pair_b, t, n_pad, dim_block, eps2, counts, skipped, mask);
  } else if (t <= 64) {
    tile_pair_kernel<4, SHORTC, CLAMP, MASK><<<grid, kThreads, 0, stream>>>(
        tiles, tile_len, pair_a, pair_b, t, n_pad, dim_block, eps2, counts, skipped, mask);
  } else {
    tile_pair_kernel<8, SHORTC, CLAMP, MASK><<<grid, kThreads, 0, stream>>>(
        tiles, tile_len, pair_a, pair_b, t, n_pad, dim_block, eps2, counts, skipped, mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace tile_eval
