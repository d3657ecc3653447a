// K1 / K2 redesigned for Hopper: candidate tile-pair evaluation with SHORTC,
// with the indexed tier's count scatter and pairs compaction fused into its
// epilogues.
//
// Replaces the TPU kernel src/repro/kernels/distance_tile.py:tile_pair_distance
// (bodies `_kernel`, counts, and `_mask_kernel`, mask), and with epilogues (b)
// and (c) also the XLA chunk programs around it: src/repro/core/engine.py:
// count_chunk_step (evaluate, then scatter-add every valid row's count into
// the grid-sorted counts vector) and pairs_chunk_step (evaluate, then the
// rank-select compaction of the hit mask into the pair buffer).
//
// What bounds it on an H100: at T = 64 and 16 real dims a pair is 64 x 64 x 16
// fp32 FMAs (IEEE, CUDA cores: no tensor cores, no TF32; DESIGN.md #6) plus a
// fold and a compare per d2 element, against 2 x 4 KB of tiles that L2 holds
// (consecutive pairs share A), so a chunk is bound by fp32 issue, not by HBM,
// except where a mask or many hits are written.  The design follows from that
// (staging, accumulation and epilogues live in tile_stage.cuh, shared with
// K3 / K4's dense_tile_fused.cu):
//
//   * real dims only: each dim block's k loop runs over [k0, min(k0 + dim_block,
//     num_dims)); the zero padding up to n_pad is neither staged nor
//     multiplied (fmaf(0, 0, x) == x, so this is exact).  Block count, fold
//     points, SHORTC checks and `skipped` are the reference's.
//   * persistent CTAs (a grid of the SMs times the CTAs one SM holds, or
//     fewer where the caller caps it), each walking a contiguous range of the
//     pair list (CTA b of G takes [P b / G, P (b + 1) / G)).  The plan sorts
//     pairs by (pair_a, pair_b), so a range holds few distinct A tiles: A is
//     staged once per run of equal pair_a, in shared memory, and B tiles
//     stream through a double-buffered shared-memory ring filled by cp.async
//     (16-byte copies where rows allow, 4-byte otherwise), the next pair's B
//     in flight while this pair computes.
//   * rows too wide for that (an A tile and two B tiles of T x num_dims
//     floats above the 227 KB of a block: at T = 64 past 300 dims, at T = 128
//     past 148) are staged in slices instead: per pair and dim block, A and B
//     pass through shared memory kSlab dims at a time, without the ring or a
//     resident A, one CTA per pair.  Slices lie on a grid of kSlab dims, so
//     their 16-byte alignment is the whole row's, and the fmaf chains run
//     over the same k in the same order: the result is the same bit for bit.
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) owns the MT x MT d2
//     elements (ty + 16 i, tx + 16 j).  Tiles sit row-major in shared memory
//     with a pitch of 4 (odd) floats, so the 16-byte reads along k of 8
//     consecutive rows hit 8 distinct bank quads: per 4 k-steps a thread
//     issues 2 MT 16-byte reads for 4 MT^2 FMAs (A reads are broadcasts).
//   * numerics of the tile_eval.cuh body: per element a sequential fmaf
//     chain over k in increasing order, row norms as sequential fmaf chains,
//     and the fold ((d2 + na) + nb) - 2 prod through __fadd_rn / __fsub_rn /
//     __fmul_rn, so the result equals it bit for bit; the eps test is the
//     reference's d2 <= eps^2 with no clamp (distance_tile.py:91).
//   * SHORTC: the valid-lane min after every block but the last (a check
//     there cannot change `skipped`); the break is uniform.  Blocks that lie
//     wholly in the padding fold to d2 unchanged and cannot break, so they are
//     counted as computed without running.
//   * epilogue (a), per pair: counts (P, T) and skipped (P,) (K1) and, given
//     a mask pointer, the (P, T, T) int8 hit mask from warp ballots, 4 bytes
//     a store (K2).  Row counts are packed 4 to a word (each <= 128) for one
//     shuffle reduction.
//   * epilogue (b), fused count chunk step: pairs [0, real) only; each thread
//     keeps its rows' counts in registers over a run of equal pair_a and
//     flushes them with one atomicAdd per nonzero valid row into
//     counts_sorted[tile_start[pa] + r] (rows at or past n_sorted drop, as
//     the reference's mode="drop"); `skipped` sums per CTA, one atomic.
//     Integer atomics are exact and order-free.
//   * epilogue (c), fused pairs chunk step, two launches and no mask in HBM.
//     Pass 1 (kHits) runs the SHORTC loop above, writes each pair's row
//     counts and hit total to scratch and saves the offset before the chunk;
//     it adds no skipped total (the reference's pairs step drops `skipped`).
//     Pass 2 (kWrite) recomputes d2 for the pairs with a hit whose first
//     rank is below hit_cap, over all their real blocks and without SHORTC:
//     a pair with a hit never broke in pass 1 (a break means its valid-lane
//     min was above eps^2, and no later block runs), so its d2 is pass 1's
//     bit for bit.  Each hit's rank in the chunk's row-major (p, i, j) order
//     comes from pass 1's totals and row counts and a half-warp ballot
//     (tile_stage.cuh: write_hits); hits of rank r < hit_cap land at
//     buf[min(offset, cap) + r] as (point_order[tile_start[pa] + i],
//     point_order[tile_start[pb] + j]), so buf[:offset] equals the
//     reference's buffer in order, and CTA 0 adds the chunk's hits to offset
//     and raises max_chunk_hits, on the device, with no host read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace k1 {

using namespace tile_stage;

constexpr float kNegLarge = 3.0e38f;   // invalid lanes in the SHORTC min (distance_tile.py:34)

struct Args {
  const float* tiles;     // (num_tiles, t, n_pad)
  const int* tile_len;    // (num_tiles,)
  const int* pair_a;      // (P,)
  const int* pair_b;      // (P,)
  int num_pairs;          // pairs evaluated: P (a) or real (b, c)
  int t, n_pad, num_dims, dim_block, pitch, vec_copy;
  int slab;               // 0: whole rows staged; else dims per staged slice
  int max_ctas;           // 0: the card's full persistent grid; else its cap
  float eps2;
  int* counts;            // (a): (P, t); (c): the chunk's row counts (real, t), pass 1 -> 2
  int* skipped;           // (a): (P,)
  int* counts_sorted;     // (b): (n_sorted + 1,)
  int n_sorted;
  const int* tile_start;  // (b), (c): (num_tiles,) grid-sorted position of each tile's row 0
  int* skipped_tot;       // (b): ()
  int shortc;             // (b): add skipped blocks to skipped_tot
};

// K2's mask and the pairs step's state: a second parameter block, so that
// Args stays at 128 bytes (past that the compiler reads a kernel's
// parameters through their address, which moved the count instantiations'
// registers).  num_pairs, counts and tile_start repeat Args's, for pass 2's
// pieces (pass2_start, tile_stage.cuh's write_hits) that read this block.
struct Pairs {
  int8_t* mask;             // kMask: (P, t, t)
  int num_pairs;            // (c): real
  int cap, hit_cap;
  int* counts;              // (c): the chunk's row counts (real, t), pass 1 -> 2
  const int* tile_start;    // (c): (num_tiles,)
  const int* point_order;   // (c): grid-sorted position -> original id
  int2* buf;                // (c): (cap + hit_cap,) rows (a, b)
  int* offset;              // (c): () hits so far; may pass cap
  int* max_hits;            // (c): () largest hit count of one chunk
  int* off0;                // (c): () offset before this chunk, pass 1 -> 2
  int* pair_hits;           // (c): (real,) hits of each pair, pass 1 -> 2
};

// Epilogue (a) with the mask (K2): compiled apart from kPerPair, so that K1's
// counts instantiation carries no mask code
constexpr int kMask = 4;

// the indexed tier's eps test, with no clamp (distance_tile.py:91)
struct Within {
  float eps2;
  __device__ __forceinline__ bool operator()(float d2) const { return d2 <= eps2; }
};

// Epilogue (a) and pass 1: each row's hits, reduced over the row's 16
// threads (one aligned half-warp) packed 4 to a word (each <= 128), stored at
// counts[p t + r] for r < t (0 at or past la).  Returns this thread's rows'
// hits (each of a row's 16 threads holds them; only pass 1 reads them).
template <int MT>
__device__ __forceinline__ int store_row_counts(const float (&d2)[MT][MT], int* counts, int p, int t, int la,
                                                int lb, Within hit, int ty, int tx) {
  constexpr int kWords = (MT + 3) / 4;
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
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = ty + kSide * i;
    if (tx == i && r < t) counts[(size_t)p * t + r] = r < la ? (int)((packed[i / 4] >> (8 * (i % 4))) & 0xffu) : 0;
  }
  int total = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (ty + kSide * i < la) total += (int)((packed[i / 4] >> (8 * (i % 4))) & 0xffu);
  return total;
}

// Pass 2's start: base = the chunk rank of the first hit of this CTA's
// range [beg, ..), a block sum of pass 1's totals before it (sum_s:
// kThreads / 32 ints); CTA 0 sums the whole chunk and moves offset and
// max_hits.  woff = the buffer row of rank 0 (past cap, blocks land in the
// padding rows).
__device__ __forceinline__ void pass2_start(const Pairs& q, int beg, int* sum_s, int tid, int lane, int& base,
                                            int& woff) {
  const int n = blockIdx.x == 0 ? q.num_pairs : beg;
  int s = 0;
  for (int r = tid; r < n; r += kThreads) s += q.pair_hits[r];
  s = __reduce_add_sync(kFull, s);
  if (lane == 0) sum_s[tid >> 5] = s;
  __syncthreads();
  s = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += sum_s[w];
  const int off0 = *q.off0;
  woff = min(off0, q.cap);
  if (blockIdx.x == 0) {
    if (tid == 0) {
      *q.offset = off0 + s;
      *q.max_hits = max(*q.max_hits, s);
    }
  } else {
    base = s;
  }
}

// KD = 0: any shape (a.slab > 0: staged in slices).  KD = 16, the fast
// path (MT = 4, i.e. 32 < T <= 64):
// one dim block (n_pad == dim_block) holding num_dims <= 16, 16-byte rows;
// pitch and k bounds are then compile-time and every loop unrolls.  The
// dims from num_dims to 16 are zeros (the tiles' padding, or never-copied
// chunks zeroed once), and fmaf(0, 0, x) == x, so it computes the same.
template <int MT, int MODE, int KD>
__global__ void __launch_bounds__(kThreads) k1_kernel(const Args a, const Pairs q) {
  constexpr int RS = MT * kSide;  // rows / cols covered by the thread grid (>= t)
  extern __shared__ __align__(16) float smem[];
  const int pitch = KD > 0 ? KD + 4 : a.pitch;
  float* a_s = smem;                     // (RS, pitch): the run's A tile
  float* b_ring = a_s + RS * pitch;      // 2 x (RS, pitch): B tiles
  float* na_s = b_ring + 2 * RS * pitch; // (RS,) this block's A row norms
  float* nb_s = na_s + RS;               // (RS,) this block's B row norms
  float* red_s = nb_s + RS;              // (kThreads / 32,) SHORTC partial mins; pass 2's prologue sums
  int* hit_s = reinterpret_cast<int*>(red_s + kThreads / 32);  // 2: pass 1's hits of a pair, by pair parity

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
    if (blockIdx.x == 0) *q.off0 = *q.offset;  // pass 2 moves offset; it reads this copy
  }
  if (MODE == kWrite) pass2_start(q, beg, reinterpret_cast<int*>(red_s), tid, lane, base, woff);

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
  const int num_blocks = KD > 0 ? 1 : a.n_pad / db;
  const int real_blocks = KD > 0 ? 1 : (a.num_dims + db - 1) / db;
  const float eps2 = a.eps2;
  const Within hit{eps2};
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
  int skipped_sum = 0;

  int p = MODE == kWrite ? next_landing(q, beg, end, base) : beg;
  if (!sliced && (MODE != kWrite || p < end))
    load_tile<KD>(b_ring, a.tiles + (size_t)a.pair_b[p] * tile_elems, a, pitch);
  int prev = -1;  // pass 1: the last pair evaluated, its hits in hit_s[prev_slot]
  int prev_slot = 0;
  for (int it = 0; p < end; ++it) {
    // the pair's parity in this CTA's walk (pass 2 skips pairs: it counts those it visits)
    const int par = (MODE == kWrite ? it : p - beg) & 1;
    const int slot = sliced ? 0 : par;  // sliced: B's slices all go to slot 0
    const float* b_s = b_ring + slot * RS * pitch;
    const int ta = a.pair_a[p];
    const int tb = a.pair_b[p];
    const int next_base = MODE == kWrite ? base + q.pair_hits[p] : 0;
    const int nxt = MODE == kWrite ? next_landing(q, p + 1, end, next_base) : p + 1;
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
          a_id[i] = r < la ? q.point_order[sa + r] : 0;
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
    int computed = 0;
    bool broke = false;
    for (int blk = 0; blk < real_blocks; ++blk) {
      const int k0 = KD > 0 ? 0 : blk * db;
      const int k1 = KD > 0 ? KD : min(k0 + db, a.num_dims);
      // this block's row norms: thread tid < RS of B row tid, the next RS of A's rows
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
          nb_s[tid] = norm;
        } else if (tid < 2 * RS) {
          na_s[tid - RS] = norm;
        }
      } else {
        if (tid < RS) {
          nb_s[tid] = row_norm<KD>(b_s + tid * pitch, k0, k1, 0.f);
        } else if (tid < 2 * RS) {
          na_s[tid - RS] = row_norm<KD>(a_s + (tid - RS) * pitch, k0, k1, 0.f);
        }
        accumulate<MT, KD>(prod, a_s, b_s, pitch, k0, k1, ty, tx);
      }
      __syncthreads();  // norms visible
      // pass 1: every thread's atomics of the last pair precede this barrier
      if (MODE == kHits && blk == 0 && tid == 0 && prev >= 0) {
        q.pair_hits[prev] = hit_s[prev_slot];
        hit_s[prev_slot] = 0;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float na = na_s[ty + kSide * i];
#pragma unroll
        for (int j = 0; j < MT; ++j)
          d2[i][j] = __fsub_rn(__fadd_rn(__fadd_rn(d2[i][j], na), nb_s[tx + kSide * j]),
                               __fmul_rn(2.f, prod[i][j]));
      }
      ++computed;
      if (MODE == kWrite) {
        // no SHORTC: pass 2 visits only pairs with a hit, and a pair that
        // broke in pass 1 has none (its valid-lane min was above eps^2 and
        // no later block ran), so every pair here ran all blocks in pass 1
        if (KD == 0 && blk < real_blocks - 1) __syncthreads();  // the norms are read; the next block rewrites them
      } else if (KD == 0 && blk < num_blocks - 1) {
        float m = kNegLarge;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j)
            if (ty + kSide * i < la && tx + kSide * j < lb) m = fminf(m, d2[i][j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
        if ((tid & 31) == 0) red_s[tid >> 5] = m;
        __syncthreads();
        float bm = red_s[0];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w) bm = fminf(bm, red_s[w]);
        // every thread reads the same bm: the break is uniform.  red_s, na_s
        // and nb_s are rewritten only after this barrier.
        if (bm > eps2) {
          broke = true;
          break;
        }
      }
    }
    const int skipped_p = broke ? num_blocks - computed : 0;

    if (MODE == kScatter) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) cnt[i] += (tx + kSide * j < lb && hit(d2[i][j])) ? 1 : 0;
      skipped_sum += skipped_p;
    } else if (MODE == kWrite) {
      write_hits<MT>(d2, q, p, tb, t, la, lb, a_id, base, woff, hit, ty, tx, lane);
    } else {  // kPerPair, kMask, kHits
      const int total = store_row_counts<MT>(d2, a.counts, p, t, la, lb, hit, ty, tx);
      if (MODE == kHits) {  // the pair's hits into hit_s[par], one atomic per warp that has any
        const int w = __reduce_add_sync(kFull, tx == 0 ? total : 0);
        if (lane == 0 && w != 0) atomicAdd(hit_s + par, w);
        prev = p;
        prev_slot = par;
      } else {
        if (tid == 0) a.skipped[p] = skipped_p;
        if (MODE == kMask) write_mask<MT>(d2, q.mask + (size_t)p * t * t, t, la, lb, hit, ty, tx);
      }
    }
    p = nxt;
    base = next_base;
  }
  if (MODE == kScatter) {
    flush_run<MT>(cnt, cur_a, la, a, ty, tx);
    if (a.shortc && tid == 0 && skipped_sum != 0) atomicAdd(a.skipped_tot, skipped_sum);
  }
  if (MODE == kHits) {
    __syncthreads();  // the last pair's atomics are done
    if (tid == 0) q.pair_hits[prev] = hit_s[prev_slot];
  }
}

inline size_t smem_bytes(int rs, int pitch) {
  return ((size_t)3 * rs * pitch + 2 * rs + kThreads / 32) * sizeof(float) + 2 * sizeof(int);
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
int launch_mt(Args a, const Pairs& q, cudaStream_t stream) {
  constexpr int RS = MT * kSide;
  auto kernel = k1_kernel<MT, MODE, KD>;
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
  // sliced staging reuses nothing across pairs: one CTA per pair, so that
  // the block scheduler balances pairs whose SHORTC breaks at different blocks
  int grid = a.slab > 0 || a.num_pairs < cached_grid ? a.num_pairs : cached_grid;
  if (a.max_ctas > 0 && a.max_ctas < grid) grid = a.max_ctas;
  kernel<<<grid, kThreads, smem, stream>>>(a, q);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(Args a, const Pairs& q, cudaStream_t stream) {
  if (a.t < 1 || a.t > kMaxT || a.dim_block < 1 || a.n_pad % a.dim_block != 0 || a.num_dims < 1 ||
      a.num_dims > a.n_pad || a.max_ctas < 0)
    return (int)cudaErrorInvalidValue;
  a.vec_copy = (a.n_pad % 4 == 0 && reinterpret_cast<uintptr_t>(a.tiles) % 16 == 0) ? 1 : 0;
  const int mt = a.t <= 16 ? 1 : a.t <= 32 ? 2 : a.t <= 64 ? 4 : 8;
  choose_staging(a, mt * kSide);
  if (a.num_pairs <= 0) return 0;
  switch (mt) {
    case 1: return launch_mt<1, MODE, 0>(a, q, stream);
    case 2: return launch_mt<2, MODE, 0>(a, q, stream);
    case 4:  // T = 64, the paper's default; Syn16D2M and CoocTexture take the fast path
      if (a.vec_copy && a.num_dims <= 16 && a.n_pad == a.dim_block) return launch_mt<4, MODE, 16>(a, q, stream);
      return launch_mt<4, MODE, 0>(a, q, stream);
    default: return launch_mt<8, MODE, 0>(a, q, stream);
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

}  // namespace k1

// (a) per pair: counts (P, t) int32, skipped (P,) int32 and, where mask is
// not null, the (P, t, t) int8 hit mask (K2).  max_ctas > 0 caps the grid
// (each CTA then walks a longer range); 0 takes the full grid.
extern "C" int distance_tile_pair_counts(const float* tiles, const int* tile_len, const int* pair_a,
                                         const int* pair_b, int num_pairs, int t, int n_pad, int num_dims,
                                         int dim_block, float eps2, int* counts, int* skipped, int8_t* mask,
                                         int max_ctas, void* stream) {
  k1::Args a = k1::tile_args(tiles, tile_len, pair_a, pair_b, num_pairs, t, n_pad, num_dims, dim_block, eps2,
                             max_ctas);
  a.counts = counts;
  a.skipped = skipped;
  k1::Pairs q = {};
  q.mask = mask;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask != nullptr ? k1::launch<k1::kMask>(a, q, s) : k1::launch<tile_stage::kPerPair>(a, q, s);
}

// (b) the fused chunk step over pairs [0, real): counts_sorted[tile_start[pa] + r]
// += count of row r < tile_len[pa] (rows at or past n_sorted drop), and, when
// shortc, skipped_tot += the pairs' skipped blocks.
extern "C" int distance_tile_count_scatter(const float* tiles, const int* tile_len, const int* tile_start,
                                           const int* pair_a, const int* pair_b, int real, int t, int n_pad,
                                           int num_dims, int dim_block, float eps2, int* counts_sorted,
                                           int n_sorted, int* skipped_tot, int shortc, int max_ctas,
                                           void* stream) {
  k1::Args a = k1::tile_args(tiles, tile_len, pair_a, pair_b, real, t, n_pad, num_dims, dim_block, eps2,
                             max_ctas);
  a.counts_sorted = counts_sorted;
  a.n_sorted = n_sorted;
  a.tile_start = tile_start;
  a.skipped_tot = skipped_tot;
  a.shortc = shortc;
  return k1::launch<tile_stage::kScatter>(a, k1::Pairs{}, static_cast<cudaStream_t>(stream));
}

// (c) the indexed pairs chunk step over pairs [0, real), two launches: the
// hits of rank r < hit_cap go to buf[min(*offset, cap) + r] (buf: (cap +
// hit_cap, 2) int32) in the reference's row-major (p, i, j) order, then
// *offset += the chunk's hits and *max_hits = max(*max_hits, them).
// scratch: 1 + real + real * t int32 (offset before the chunk, hits per
// pair, row counts), written by pass 1 and read by pass 2.
extern "C" int distance_tile_pairs_compact(const float* tiles, const int* tile_len, const int* tile_start,
                                           const int* point_order, const int* pair_a, const int* pair_b, int real,
                                           int t, int n_pad, int num_dims, int dim_block, float eps2, int* buf,
                                           int cap, int hit_cap, int* offset, int* max_hits, int* scratch,
                                           int max_ctas, void* stream) {
  if (cap < 0 || hit_cap < 1) return (int)cudaErrorInvalidValue;
  k1::Args a = k1::tile_args(tiles, tile_len, pair_a, pair_b, real, t, n_pad, num_dims, dim_block, eps2,
                             max_ctas);
  a.tile_start = tile_start;
  a.counts = scratch + 1 + real;
  k1::Pairs q = {};
  q.num_pairs = real;
  q.cap = cap;
  q.hit_cap = hit_cap;
  q.counts = a.counts;
  q.tile_start = tile_start;
  q.point_order = point_order;
  q.buf = reinterpret_cast<int2*>(buf);
  q.offset = offset;
  q.max_hits = max_hits;
  q.off0 = scratch;
  q.pair_hits = scratch + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = k1::launch<tile_stage::kHits>(a, q, s);
  if (err != 0) return err;
  return k1::launch<tile_stage::kWrite>(a, q, s);
}
