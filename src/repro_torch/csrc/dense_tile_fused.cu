// K3 / K4 redesigned for Hopper: dense tile-pair evaluation, with the dense
// tier's count scatter and pairs compaction fused into its epilogues.
//
// Replaces the TPU kernel src/repro/kernels/dense_tile.py:dense_tile_distance
// (bodies `_kernel`, counts, and `_mask_kernel`, mask), and with epilogues (b)
// and (c) also the XLA chunk programs around it with the dense backend:
// src/repro/core/engine.py:count_chunk_step (evaluate, scatter-add every valid
// row's count into the grid-sorted counts vector) and pairs_chunk_step
// (evaluate, rank-select compaction of the hit mask into the pair buffer).
//
// What bounds it on an H100: the dense plan lists the full tile cross product,
// so at T = 64 and 16 real dims a pair is 64 x 64 x 16 fp32 FMAs (IEEE, CUDA
// cores: no tensor cores, no TF32; DESIGN.md #6) plus a fold and a compare per
// d2 element, against 2 x 4 KB of tiles that L2 holds (the plan walks every B
// tile for one A tile in a row): fp32 issue, not HBM, except where a mask or
// many hits are written.  The design is K1's (distance_tile_counts.cu; its
// staging, accumulation, mask and pass-2 writes live in tile_stage.cuh)
// without SHORTC:
//
//   * real dims only: each dim block's k loop runs over [k0, min(k0 +
//     dim_block, num_dims)); blocks wholly in the padding fold to d2
//     unchanged and are not run.  Block count and fold points are the
//     reference's.
//   * persistent CTAs over contiguous pair ranges (CTA b of G takes
//     [P b / G, P (b + 1) / G)); the dense plan lists pair_a in runs of
//     num_tiles equal values, so the A tile is staged once per run and B
//     tiles stream through a double-buffered cp.async ring.  Rows too wide
//     for an A tile and two B tiles in 227 KB are staged in kSlab-dim slices
//     per pair and dim block, one CTA per pair.
//   * no SHORTC: no min-reduction and no barrier for it.  Per dim block the
//     fold is ((d2 + na) + nb) - 2 prod through __fadd_rn / __fsub_rn /
//     __fmul_rn (dense_tile.py:69), then max(d2, 0) <= eps^2 (:78).  The row
//     norms of a block are double-buffered by block parity, so one barrier
//     per block orders them.  On 1/64-quantized data every result equals the
//     tile_eval.cuh dense kernel (dense_tile.cu) bit for bit.
//   * epilogue (a), per pair: counts (P, T) (packed 4 to a word for one
//     shuffle reduction) and, given a mask pointer, the (P, T, T) int8 hit
//     mask from warp ballots, 4 bytes a store.
//   * epilogue (b), the dense count chunk step: pairs [0, real); each thread
//     keeps its rows' counts over a run of equal pair_a and flushes them with
//     one atomicAdd per nonzero valid row into counts_sorted[tile_start[pa] +
//     r] (rows at or past n_sorted drop).  The dense tier skips no block, so
//     there is no skipped total.
//   * epilogue (c), the dense pairs chunk step, two launches of this body and
//     no mask in HBM.  Pass 1 (kHits) writes each pair's row counts and hit
//     total to scratch and saves the offset before the chunk.  Pass 2
//     (kWrite) recomputes d2 (cheaper than a mask round trip at these
//     widths) for the pairs with a hit whose rank can land below hit_cap: a
//     hit's rank in the chunk's row-major (p, i, j) order is the hits of the
//     pairs before p (a block sum over pass 1's totals, then a running sum)
//     plus the hits of rows before i (a warp scan of pass 1's row counts)
//     plus a ballot/popc over the 16 threads of row i.  Hits of rank r <
//     hit_cap land at buf[min(offset, cap) + r] as (point_order[tile_start[pa]
//     + i], point_order[tile_start[pb] + j]), so buf[:offset] equals the
//     reference's buffer in order; CTA 0 adds the chunk's hits to offset and
//     raises max_chunk_hits, on the device, with no host read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace dense {

using namespace tile_stage;

struct Args {
  const float* tiles;        // (num_tiles, t, n_pad)
  const int* tile_len;       // (num_tiles,)
  const int* pair_a;         // (P,)
  const int* pair_b;         // (P,)
  int num_pairs;             // pairs evaluated: P (a) or real (b, c)
  int t, n_pad, num_dims, dim_block, pitch, vec_copy;
  int slab;                  // 0: whole rows staged; else dims per staged slice
  int max_ctas;              // 0: the card's full persistent grid; else its cap
  float eps2;
  int* counts;               // (a): (P, t); (c): the chunk's row counts (real, t), pass 1 -> 2
  int8_t* mask;              // (a): (P, t, t), or null
  const int* tile_start;     // (b), (c): (num_tiles,) grid-sorted position of each tile's row 0
  int* counts_sorted;        // (b): (n_sorted + 1,)
  int n_sorted;
  const int* point_order;    // (c): (N,) grid-sorted position -> original id
  int2* buf;                 // (c): (cap + hit_cap,) rows (a, b)
  int cap, hit_cap;
  int* offset;               // (c): () hits so far; may pass cap
  int* max_hits;             // (c): () largest hit count of one chunk
  int* off0;                 // (c): () offset before this chunk, pass 1 -> 2
  int* pair_hits;            // (c): (real,) hits of each pair, pass 1 -> 2
};

// the dense tier's eps test: the clamped matmul identity (dense_tile.py:78)
struct Within {
  float eps2;
  __device__ __forceinline__ bool operator()(float d2) const { return fmaxf(d2, 0.f) <= eps2; }
};

// KD = 0: any shape (a.slab > 0: staged in slices).  KD = 16, the fast path
// (MT = 4): one dim block (n_pad == dim_block) holding num_dims <= 16, 16-byte
// rows; pitch and k bounds are compile-time and every loop unrolls.  The dims
// from num_dims to 16 are zeros, and fmaf(0, 0, x) == x.
template <int MT, int MODE, int KD>
__global__ void __launch_bounds__(kThreads) dense_kernel(const Args a) {
  constexpr int RS = MT * kSide;  // rows / cols covered by the thread grid (>= t)
  constexpr int kWords = (MT + 3) / 4;
  extern __shared__ __align__(16) float smem[];
  const int pitch = KD > 0 ? KD + 4 : a.pitch;
  float* a_s = smem;                      // (RS, pitch): the run's A tile
  float* b_ring = a_s + RS * pitch;       // 2 x (RS, pitch): B tiles
  float* na_s = b_ring + 2 * RS * pitch;  // 2 x (RS,): a block's A row norms, by block parity
  float* nb_s = na_s + 2 * RS;            // 2 x (RS,): B row norms
  int* sum_s = reinterpret_cast<int*>(nb_s + 2 * RS);  // (kThreads / 32,): pass 2's prologue sums
  int* hit_s = sum_s + kThreads / 32;     // 2: pass 1's hits of a pair, by pair parity

  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const int lane = tid & 31;
  const int t = a.t;
  const bool sliced = KD == 0 && a.slab > 0;
  const int beg = (int)((long long)a.num_pairs * blockIdx.x / gridDim.x);
  const int end = (int)((long long)a.num_pairs * (blockIdx.x + 1) / gridDim.x);
  if (beg >= end) return;

  int base = 0;  // pass 2: the chunk rank of the current pair's first hit
  int woff = 0;  // pass 2: the buffer row of rank 0
  if (MODE == kHits && tid == 0) {
    hit_s[0] = 0;
    hit_s[1] = 0;
    if (blockIdx.x == 0) *a.off0 = *a.offset;  // pass 2 moves offset; it reads this copy
  }
  if (MODE == kWrite) {  // the hits before this CTA's range; CTA 0: the chunk's total
    const int n = blockIdx.x == 0 ? a.num_pairs : beg;
    int s = 0;
    for (int q = tid; q < n; q += kThreads) s += a.pair_hits[q];
    s = __reduce_add_sync(kFull, s);
    if (lane == 0) sum_s[tid >> 5] = s;
    __syncthreads();
    s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += sum_s[w];
    const int off0 = *a.off0;
    woff = min(off0, a.cap);  // past cap, blocks land in the padding rows
    if (blockIdx.x == 0) {
      if (tid == 0) {
        *a.offset = off0 + s;
        *a.max_hits = max(*a.max_hits, s);
      }
    } else {
      base = s;
    }
  }

  // rows t..RS-1 (and on the fast path the chunks past num_dims) are never
  // loaded: zero them once in A and both ring slots
  const int copied = KD > 0 ? ((a.num_dims + 3) & ~3) : pitch;
  for (int idx = tid; idx < RS * pitch; idx += kThreads) {
    if (idx >= t * pitch || idx % pitch >= copied) {
      a_s[idx] = 0.f;
      b_ring[idx] = 0.f;
      b_ring[RS * pitch + idx] = 0.f;
    }
  }

  const int db = a.dim_block;
  const int real_blocks = KD > 0 ? 1 : (a.num_dims + db - 1) / db;
  const Within hit{a.eps2};
  const size_t tile_elems = (size_t)t * a.n_pad;

  int cur_a = -1;
  int la = 0;
  int cnt[MT];   // (b): the run's row counts
  int a_id[MT];  // pass 2: original ids of the run's A rows
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    cnt[i] = 0;
    a_id[i] = 0;
  }

  int p = MODE == kWrite ? next_landing(a, beg, end, base) : beg;
  if (!sliced && p < end) load_tile<KD>(b_ring, a.tiles + (size_t)a.pair_b[p] * tile_elems, a, pitch);
  int prev = -1;  // pass 1: the last pair evaluated, its hits in hit_s[prev_slot]
  int prev_slot = 0;
  for (int it = 0; p < end; ++it) {
    const int slot = sliced ? 0 : it & 1;  // sliced: B's slices all go to slot 0
    const float* b_s = b_ring + slot * RS * pitch;
    const int ta = a.pair_a[p];
    const int tb = a.pair_b[p];
    const int next_base = MODE == kWrite ? base + a.pair_hits[p] : 0;
    const int nxt = MODE == kWrite ? next_landing(a, p + 1, end, next_base) : p + 1;
    if (ta != cur_a) {  // a new run: flush the last one, stage its A tile
      if (MODE == kScatter && cur_a >= 0) flush_run<MT>(cnt, cur_a, la, a, ty, tx);
      if (!sliced) {
        __syncthreads();  // every thread is done reading the old A
        load_tile<KD>(a_s, a.tiles + (size_t)ta * tile_elems, a, pitch);
      }
      cur_a = ta;
      la = min(a.tile_len[ta], t);
      if (MODE == kWrite) {
        const int sa = a.tile_start[ta];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = ty + kSide * i;
          a_id[i] = r < la ? a.point_order[sa + r] : 0;
        }
      }
    }
    if (!sliced) {
      cp_async_wait_all();
      __syncthreads();  // this pair's tiles are visible; the last pair is done with the other slot
      if (nxt < end)
        load_tile<KD>(b_ring + (slot ^ 1) * RS * pitch, a.tiles + (size_t)a.pair_b[nxt] * tile_elems, a, pitch);
    }
    const int lb = min(a.tile_len[tb], t);

    float d2[MT][MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) d2[i][j] = 0.f;
    for (int blk = 0; blk < real_blocks; ++blk) {
      const int k0 = KD > 0 ? 0 : blk * db;
      const int k1 = KD > 0 ? KD : min(k0 + db, a.num_dims);
      // block blk + 1 writes the buffer block blk - 1 read, which block blk's barrier has retired
      float* na_b = na_s + (blk & 1) * RS;
      float* nb_b = nb_s + (blk & 1) * RS;
      float prod[MT][MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) prod[i][j] = 0.f;
      if (sliced) {  // the slices [sb, sb + slab) of the slab grid that meet [k0, k1)
        const float* A = a.tiles + (size_t)ta * tile_elems;
        const float* B = a.tiles + (size_t)tb * tile_elems;
        float norm = 0.f;
        for (int sb = k0 - k0 % a.slab; sb < k1; sb += a.slab) {
          const int lo = max(k0, sb);
          const int hi = min(k1, sb + a.slab);
          __syncthreads();  // every thread is done reading the last slice
          load_dims<KD>(a_s, A, a, pitch, lo & ~3, hi, sb);
          load_dims<KD>(b_ring, B, a, pitch, lo & ~3, hi, sb);  // slot 0: b_s
          cp_async_wait_all();
          __syncthreads();
          if (tid < RS) {
            norm = row_norm<KD>(b_s + tid * pitch, lo - sb, hi - sb, norm);
          } else if (tid < 2 * RS) {
            norm = row_norm<KD>(a_s + (tid - RS) * pitch, lo - sb, hi - sb, norm);
          }
          accumulate<MT, KD>(prod, a_s, b_s, pitch, lo - sb, hi - sb, ty, tx);
        }
        if (tid < RS) {
          nb_b[tid] = norm;
        } else if (tid < 2 * RS) {
          na_b[tid - RS] = norm;
        }
      } else {
        if (tid < RS) {
          nb_b[tid] = row_norm<KD>(b_s + tid * pitch, k0, k1, 0.f);
        } else if (tid < 2 * RS) {
          na_b[tid - RS] = row_norm<KD>(a_s + (tid - RS) * pitch, k0, k1, 0.f);
        }
        accumulate<MT, KD>(prod, a_s, b_s, pitch, k0, k1, ty, tx);
      }
      __syncthreads();  // norms visible
      // pass 1: every thread's atomics of the last pair precede this barrier
      if (MODE == kHits && blk == 0 && tid == 0 && prev >= 0) {
        a.pair_hits[prev] = hit_s[prev_slot];
        hit_s[prev_slot] = 0;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float na = na_b[ty + kSide * i];
#pragma unroll
        for (int j = 0; j < MT; ++j)
          d2[i][j] = __fsub_rn(__fadd_rn(__fadd_rn(d2[i][j], na), nb_b[tx + kSide * j]),
                               __fmul_rn(2.f, prod[i][j]));
      }
    }

    if (MODE == kScatter) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) cnt[i] += (tx + kSide * j < lb && hit(d2[i][j])) ? 1 : 0;
    } else if (MODE == kPerPair || MODE == kHits) {
      unsigned packed[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) packed[w] = 0u;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned c = 0;
#pragma unroll
        for (int j = 0; j < MT; ++j) c += (tx + kSide * j < lb && hit(d2[i][j])) ? 1u : 0u;
        packed[i / 4] += c << (8 * (i % 4));
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w)
#pragma unroll
        for (int off = kSide / 2; off > 0; off >>= 1) packed[w] += __shfl_xor_sync(kFull, packed[w], off);
      int total = 0;  // this thread's rows' hits (each of the row's 16 threads holds them)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = ty + kSide * i;
        const int c = r < la ? (int)((packed[i / 4] >> (8 * (i % 4))) & 0xffu) : 0;
        if (tx == i && r < t) a.counts[(size_t)p * t + r] = c;
        total += c;
      }
      if (MODE == kHits) {
        total = __reduce_add_sync(kFull, tx == 0 ? total : 0);
        if (lane == 0 && total != 0) atomicAdd(hit_s + (it & 1), total);
        prev = p;
        prev_slot = it & 1;
      }
      if (MODE == kPerPair && a.mask != nullptr)
        write_mask<MT>(d2, a.mask + (size_t)p * t * t, t, la, lb, hit, ty, tx);
    } else {  // kWrite
      write_hits<MT>(d2, a, p, tb, t, la, lb, a_id, base, woff, hit, ty, tx, lane);
    }
    p = nxt;
    base = next_base;
  }
  if (MODE == kScatter) flush_run<MT>(cnt, cur_a, la, a, ty, tx);
  if (MODE == kHits) {
    __syncthreads();  // the last pair's atomics are done
    if (tid == 0) a.pair_hits[prev] = hit_s[prev_slot];
  }
}

inline size_t smem_bytes(int rs, int pitch) {
  return ((size_t)3 * rs * pitch + 4 * rs) * sizeof(float) + (kThreads / 32 + 2) * sizeof(int);
}

// Whole rows where an A tile and two B tiles of them fit, else slices of
// kSlab dims: sets a.slab and a.pitch.
inline void choose_staging(Args& a, int rs) {
  a.pitch = tile_pitch(a.num_dims);
  a.slab = 0;
  if (smem_bytes(rs, a.pitch) > kMaxSmem) {
    a.slab = kSlab;
    a.pitch = tile_pitch(kSlab);
  }
}

template <int MT, int MODE, int KD>
int launch_mt(Args a, cudaStream_t stream) {
  constexpr int RS = MT * kSide;
  auto kernel = dense_kernel<MT, MODE, KD>;
  const size_t smem = smem_bytes(RS, KD > 0 ? KD + 4 : a.pitch);
  // the grid: every SM times the CTAs it holds at this shared memory size,
  // looked up once per (device, size)
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  static int cached_grid = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev || smem != cached_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_grid = per_sm * sms;
  }
  // sliced staging reuses nothing across pairs: one CTA per pair
  int grid = a.slab > 0 || a.num_pairs < cached_grid ? a.num_pairs : cached_grid;
  if (a.max_ctas > 0 && a.max_ctas < grid) grid = a.max_ctas;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(Args a, cudaStream_t stream) {
  if (a.t < 1 || a.t > kMaxT || a.dim_block < 1 || a.n_pad % a.dim_block != 0 || a.num_dims < 1 ||
      a.num_dims > a.n_pad || a.max_ctas < 0)
    return (int)cudaErrorInvalidValue;
  a.vec_copy = (a.n_pad % 4 == 0 && reinterpret_cast<uintptr_t>(a.tiles) % 16 == 0) ? 1 : 0;
  const int mt = a.t <= 16 ? 1 : a.t <= 32 ? 2 : a.t <= 64 ? 4 : 8;
  choose_staging(a, mt * kSide);
  if (a.num_pairs <= 0) return 0;
  switch (mt) {
    case 1: return launch_mt<1, MODE, 0>(a, stream);
    case 2: return launch_mt<2, MODE, 0>(a, stream);
    case 4:  // T = 64, the paper's default; CoocTexture's dense tier takes the fast path
      if (a.vec_copy && a.num_dims <= 16 && a.n_pad == a.dim_block) return launch_mt<4, MODE, 16>(a, stream);
      return launch_mt<4, MODE, 0>(a, stream);
    default: return launch_mt<8, MODE, 0>(a, stream);
  }
}

inline Args tile_args(const float* tiles, const int* tile_len, const int* pair_a, const int* pair_b,
                      int num_pairs, int t, int n_pad, int num_dims, int dim_block, float eps2, int max_ctas) {
  Args a = {};
  a.tiles = tiles;
  a.tile_len = tile_len;
  a.pair_a = pair_a;
  a.pair_b = pair_b;
  a.num_pairs = num_pairs;
  a.t = t;
  a.n_pad = n_pad;
  a.num_dims = num_dims;
  a.dim_block = dim_block;
  a.eps2 = eps2;
  a.max_ctas = max_ctas;
  return a;
}

}  // namespace dense

// (a) per pair: counts (P, t) int32 and, where mask is not null, the (P, t, t)
// int8 hit mask.  max_ctas > 0 caps the grid; 0 takes the full grid.
extern "C" int dense_tile_pair_eval(const float* tiles, const int* tile_len, const int* pair_a,
                                    const int* pair_b, int num_pairs, int t, int n_pad, int num_dims,
                                    int dim_block, float eps2, int* counts, int8_t* mask, int max_ctas,
                                    void* stream) {
  dense::Args a = dense::tile_args(tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, num_dims, dim_block,
                                   eps2, max_ctas);
  a.counts = counts;
  a.mask = mask;
  return dense::launch<dense::kPerPair>(a, static_cast<cudaStream_t>(stream));
}

// (b) the dense count chunk step over pairs [0, real): counts_sorted[tile_start[pa] + r]
// += count of row r < tile_len[pa] (rows at or past n_sorted drop).
extern "C" int dense_tile_count_scatter(const float* tiles, const int* tile_len, const int* tile_start,
                                        const int* pair_a, const int* pair_b, int real, int t, int n_pad,
                                        int num_dims, int dim_block, float eps2, int* counts_sorted, int n_sorted,
                                        int max_ctas, void* stream) {
  dense::Args a = dense::tile_args(tiles, tile_len, pair_a, pair_b, real, t, n_pad, num_dims, dim_block, eps2,
                                   max_ctas);
  a.tile_start = tile_start;
  a.counts_sorted = counts_sorted;
  a.n_sorted = n_sorted;
  return dense::launch<dense::kScatter>(a, static_cast<cudaStream_t>(stream));
}

// (c) the dense pairs chunk step over pairs [0, real), two launches: the hits
// of rank r < hit_cap go to buf[min(*offset, cap) + r] (buf: (cap + hit_cap, 2)
// int32), then *offset += the chunk's hits and *max_hits = max(*max_hits, them).
// scratch: 1 + real + real * t int32 (offset before the chunk, hits per pair,
// row counts), written by pass 1 and read by pass 2.
extern "C" int dense_tile_pairs_compact(const float* tiles, const int* tile_len, const int* tile_start,
                                        const int* point_order, const int* pair_a, const int* pair_b, int real,
                                        int t, int n_pad, int num_dims, int dim_block, float eps2, int* buf,
                                        int cap, int hit_cap, int* offset, int* max_hits, int* scratch,
                                        int max_ctas, void* stream) {
  if (cap < 0 || hit_cap < 1) return (int)cudaErrorInvalidValue;
  dense::Args a = dense::tile_args(tiles, tile_len, pair_a, pair_b, real, t, n_pad, num_dims, dim_block, eps2,
                                   max_ctas);
  a.tile_start = tile_start;
  a.point_order = point_order;
  a.buf = reinterpret_cast<int2*>(buf);
  a.cap = cap;
  a.hit_cap = hit_cap;
  a.offset = offset;
  a.max_hits = max_hits;
  a.off0 = scratch;
  a.pair_hits = scratch + 1;
  a.counts = scratch + 1 + real;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dense::launch<dense::kHits>(a, s);
  if (err != 0) return err;
  return dense::launch<dense::kWrite>(a, s);
}
