// Tile staging, accumulation and epilogues shared by the persistent tile-pair
// kernels: distance_tile_counts.cu (K1 / K2) and dense_tile_fused.cu (K3 / K4).
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
// The epilogues take the kernel's eps test as `hit(d2)` (the indexed tier's
// d2 <= eps^2, the dense tier's max(d2, 0) <= eps^2).  The pairs chunk step
// (Mode kHits, then kWrite) is two launches with no mask in device memory:
// pass 1 stores each pair's row counts and hit total, pass 2 recomputes d2
// for the pairs with a hit whose rank can land below hit_cap and writes each
// hit at its rank in the chunk's row-major (p, i, j) order (`write_hits`).
//
// `Args` is the including kernel's argument struct: load_dims reads its t,
// n_pad, num_dims and vec_copy; flush_run its tile_start, counts_sorted and
// n_sorted; next_landing and write_hits the pairs step's state (hit_cap,
// pair_hits, counts, tile_start, point_order, buf).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_stage {

constexpr int kThreads = 256;
constexpr int kSide = 16;              // thread grid is kSide x kSide
constexpr int kMaxT = 128;
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on sm_90
constexpr int kSlab = 32;              // dims per slice where whole rows do not fit
constexpr unsigned kFull = 0xffffffffu;

enum Mode : int {
  kPerPair = 0,  // (a): counts (P, t), optional mask (P, t, t)
  kScatter = 1,  // (b): the count chunk step
  kHits = 2,     // (c) pass 1: row counts and hits per pair
  kWrite = 3,    // (c) pass 2: the hits, in rank order, into buf
};

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

// Epilogue (a)'s mask: row r's hits from one ballot per (i, j), written as
// 4-byte words by the 16 threads of the row (byte stores where t % 4 != 0).
template <int MT, class Hit>
__device__ __forceinline__ void write_mask(const float (&d2)[MT][MT], int8_t* mask_p, int t, int la, int lb,
                                           Hit hit, int ty, int tx) {
  constexpr int kWordsPerThread = (MT + 3) / 4;  // a row has t / 4 <= 4 MT words
  const unsigned shift = kSide * (ty & 1);       // the two rows of a warp are its two half-warps
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = ty + kSide * i;
    unsigned hb[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j)
      hb[j] = (__ballot_sync(kFull, r < la && tx + kSide * j < lb && hit(d2[i][j])) >> shift) & 0xffffu;
    if (r >= t) continue;
    int8_t* row = mask_p + (size_t)r * t;
    if ((t & 3) == 0) {
#pragma unroll
      for (int k = 0; k < kWordsPerThread; ++k) {
        const int w = tx + kSide * k;  // cols 4 w .. 4 w + 3: bits 4 (w & 3).. of hb[w / 4]
        if (w < t / 4) {
          unsigned h = 0;
#pragma unroll
          for (int j = 0; j < MT; ++j)
            if (j == (w >> 2)) h = hb[j];
          h = (h >> (4 * (tx & 3))) & 0xfu;
          reinterpret_cast<unsigned*>(row)[w] = (h & 1u) | ((h & 2u) << 7) | ((h & 4u) << 14) | ((h & 8u) << 21);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int c = tx + kSide * j;
        if (c < t) row[c] = (int8_t)((hb[j] >> tx) & 1u);
      }
    }
  }
}

// Pass 2: the first pair at or after q with a hit, while the chunk rank
// `base` of its first hit is below hit_cap (pairs without hits move no rank).
template <class Args>
__device__ __forceinline__ int next_landing(const Args& a, int q, int end, int base) {
  if (base >= a.hit_cap) return end;
  while (q < end && a.pair_hits[q] == 0) ++q;
  return q;
}

// Pass 2's epilogue for pair p (B tile tb): each hit's chunk rank is `base`
// (the hits of the pairs before p) plus the hits of the rows before its row
// (an exclusive scan of pass 1's row counts, which every warp runs itself)
// plus a ballot/popc over the 16 threads of its row; a hit of rank r <
// hit_cap lands at buf[woff + r] as (a_id[i], point_order[tile_start[tb] +
// c]).  a_id: the original ids of this thread's A rows.
template <int MT, class Args, class Hit>
__device__ __forceinline__ void write_hits(const float (&d2)[MT][MT], const Args& a, int p, int tb, int t, int la,
                                           int lb, const int (&a_id)[MT], int base, int woff, Hit hit, int ty,
                                           int tx, int lane) {
  constexpr int kSeg = (MT * kSide + 31) / 32;  // 32-row segments of a tile
  const int* rc = a.counts + (size_t)p * t;
  int ex[kSeg];
  int run = 0;
#pragma unroll
  for (int e = 0; e < kSeg; ++e) {
    const int r = 32 * e + lane;
    const int v = r < t ? rc[r] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    ex[e] = run + incl - v;
    run += __shfl_sync(kFull, incl, 31);
  }
  const int sb = a.tile_start[tb];
  const unsigned shift = kSide * (ty & 1);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    // row ty + 16 i is lane ty + 16 (i & 1) of segment i / 2
    int rank = base + __shfl_sync(kFull, ex[i >> 1], ty + kSide * (i & 1));
    const bool row_ok = ty + kSide * i < la;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int c = tx + kSide * j;
      const bool h = row_ok && c < lb && hit(d2[i][j]);
      const unsigned half = (__ballot_sync(kFull, h) >> shift) & 0xffffu;
      const int r_hit = rank + __popc(half & ((1u << tx) - 1u));
      if (h && r_hit < a.hit_cap) a.buf[woff + r_hit] = make_int2(a_id[i], a.point_order[sb + c]);
      rank += __popc(half);
    }
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
