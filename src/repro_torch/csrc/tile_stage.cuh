// Tile staging and accumulation shared by the persistent tile-pair kernels:
// distance_tile_counts.cu (K1) and dense_tile_fused.cu (K3 / K4).
//
// 256 threads as a 16 x 16 grid; thread (ty, tx) owns the MT x MT d2
// elements (ty + 16 i, tx + 16 j).  Tiles sit row-major in shared memory at a
// pitch of 4 (odd) floats (`tile_pitch`), so the 16-byte reads along k of 8
// consecutive rows hit 8 distinct bank quads.  Copies go by cp.async, 16 bytes
// where rows allow, 4 otherwise.  Products and norms are sequential fmaf
// chains over k in increasing order (fp32 on the CUDA cores: no tensor cores,
// no TF32; DESIGN.md #6), the order of the tile_eval.cuh body, so every kernel
// built from these pieces computes the same d2 bit for bit.
//
// `Args` is the including kernel's argument struct: load_dims reads its t,
// n_pad, num_dims and vec_copy; flush_run its tile_start, counts_sorted and
// n_sorted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_stage {

constexpr int kThreads = 256;
constexpr int kSide = 16;              // thread grid is kSide x kSide
constexpr int kMaxT = 128;
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr int kSlab = 32;              // dims per slice where whole rows do not fit

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows [0, t), dims [k_lo, k_hi) of one tile into dst, dim k at column
// k - base (row pitch `pitch`; base % 4 == 0).  KD > 0 (the fast path): rows
// of KD / 4 16-byte chunks, of which the first ceil(num_dims / 4) are copied
// (the rest stay zero).
template <int KD, class Args>
__device__ __forceinline__ void load_dims(float* dst, const float* src, const Args& a, int pitch, int k_lo,
                                          int k_hi, int base) {
  if (KD > 0) {
    constexpr int kChunks = KD / 4;
    const int chunks = (a.num_dims + 3) >> 2;
    for (int idx = threadIdx.x; idx < a.t * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      if (c < chunks) cp_async16(dst + r * pitch + 4 * c, src + (size_t)r * a.n_pad + 4 * c);
    }
  } else if (a.vec_copy) {  // n_pad % 4 == 0, k_lo % 4 == 0: 16-byte chunks; the last may run past k_hi
    const int c0 = k_lo >> 2;
    const int chunks = ((k_hi + 3) >> 2) - c0;
    for (int idx = threadIdx.x; idx < a.t * chunks; idx += kThreads) {
      const int r = idx / chunks;
      const int k = 4 * (c0 + idx - r * chunks);
      cp_async16(dst + r * pitch + k - base, src + (size_t)r * a.n_pad + k);
    }
  } else {
    const int w = k_hi - k_lo;
    for (int idx = threadIdx.x; idx < a.t * w; idx += kThreads) {
      const int r = idx / w;
      const int k = k_lo + idx - r * w;
      cp_async4(dst + r * pitch + k - base, src + (size_t)r * a.n_pad + k);
    }
  }
  cp_async_commit();
}

// One whole tile: dims [0, num_dims).
template <int KD, class Args>
__device__ __forceinline__ void load_tile(float* dst, const float* src, const Args& a, int pitch) {
  load_dims<KD>(dst, src, a, pitch, 0, a.num_dims, 0);
}

// s + sum_k row[k]^2 over [k0, k1), one fmaf chain in k order (KD > 0: [0, KD))
template <int KD>
__device__ __forceinline__ float row_norm(const float* row, int k0, int k1, float s) {
  if (KD > 0) {
#pragma unroll
    for (int k = 0; k < KD; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    return s;
  }
  int k = k0;
  for (; k < k1 && (k & 3); ++k) s = fmaf(row[k], row[k], s);
  for (; k + 4 <= k1; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  for (; k < k1; ++k) s = fmaf(row[k], row[k], s);
  return s;
}

// the 16-byte step of accumulate: k .. k + 3 into every prod[i][j], in order
template <int MT>
__device__ __forceinline__ void fma_step4(float (&prod)[MT][MT], const float* a0, const float* b0, int step,
                                          int k) {
  float4 bv[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) bv[j] = *reinterpret_cast<const float4*>(b0 + j * step + k);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float4 av = *reinterpret_cast<const float4*>(a0 + i * step + k);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      float p = prod[i][j];
      p = fmaf(av.x, bv[j].x, p);
      p = fmaf(av.y, bv[j].y, p);
      p = fmaf(av.z, bv[j].z, p);
      p = fmaf(av.w, bv[j].w, p);
      prod[i][j] = p;
    }
  }
}

// prod[i][j] += sum_k A[ty + 16 i][k] B[tx + 16 j][k] over [k0, k1), k in
// order (KD > 0: over [0, KD), fully unrolled)
template <int MT, int KD>
__device__ __forceinline__ void accumulate(float (&prod)[MT][MT], const float* a_s, const float* b_s,
                                           int pitch, int k0, int k1, int ty, int tx) {
  const float* a0 = a_s + ty * pitch;
  const float* b0 = b_s + tx * pitch;
  const int step = kSide * pitch;
  if (KD > 0) {
#pragma unroll
    for (int k = 0; k < KD; k += 4) fma_step4<MT>(prod, a0, b0, step, k);
    return;
  }
  int k = k0;
  for (; k < k1 && (k & 3); ++k) {
    float bv[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) bv[j] = b0[j * step + k];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float av = a0[i * step + k];
#pragma unroll
      for (int j = 0; j < MT; ++j) prod[i][j] = fmaf(av, bv[j], prod[i][j]);
    }
  }
  for (; k + 4 <= k1; k += 4) fma_step4<MT>(prod, a0, b0, step, k);
  for (; k < k1; ++k) {
    float bv[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) bv[j] = b0[j * step + k];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float av = a0[i * step + k];
#pragma unroll
      for (int j = 0; j < MT; ++j) prod[i][j] = fmaf(av, bv[j], prod[i][j]);
    }
  }
}

// A fused count step's epilogue: the run's row counts, reduced over the 16
// threads of a row (one aligned half-warp), one atomic per nonzero valid row
// into a.counts_sorted[a.tile_start[ta] + r] (rows at or past a.n_sorted drop).
template <int MT, class Args>
__device__ __forceinline__ void flush_run(int (&cnt)[MT], int ta, int la, const Args& a, int ty, int tx) {
  const int base = a.tile_start[ta];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int v = cnt[i];
#pragma unroll
    for (int off = kSide / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int r = ty + kSide * i;
    const int idx = base + r;
    if (tx == i && r < la && v != 0 && idx < a.n_sorted) atomicAdd(a.counts_sorted + idx, v);
    cnt[i] = 0;
  }
}

// Row pitch of the staged tiles, in floats: a multiple of 4 whose quarter is
// odd, so 16-byte reads of 8 consecutive rows fall in 8 distinct bank quads.
inline int tile_pitch(int num_dims) {
  int p = (num_dims + 3) / 4 * 4;
  if ((p / 4) % 2 == 0) p += 4;
  return p;
}

}  // namespace tile_stage
