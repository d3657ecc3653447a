// K5: forward flash attention with an fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:81
// `flash_attention` (body `_kernel`).  For q (BH, Sq, dh), k (BH, Sk, dh) and
// v (BH, Sk, dv), in f32 or bf16 and computed in f32, it writes
// o = softmax((q k^T) scale) v in q's type; with `causal`, key col is seen by
// query row only where col <= row (positional, top-left aligned, -1e30 as
// the masked score).
//
// Layout: one thread block per (bh, 64-row q-tile), 256 threads as a 16 x 16
// grid.  A loop over 64-key k-tiles inside the block takes the place of the
// Pallas grid's sequential k axis; with `causal` the loop stops before the
// first k-tile wholly above the diagonal (at this kernel's own tile size).
// Per k-tile: the V tile goes to shared memory; Q and K go through shared
// memory in 32-dim slices (any dh works), dimension-major with the 4-float
// groups XOR-swizzled by the dim, so the transposing store hits 32 banks and
// thread (ty, tx) reads its 4 query rows and 4 keys at one dim as two float4.
// The 4 x 4 score block stays in registers; row max and row sum are reduced
// over the 16 threads of a row (one half-warp) with shuffles; m, l and the
// thread's 4 x (4 NV) slice of the accumulator stay in registers, in fp32.
// P goes through shared memory for the second product.  Both products are
// fp32 FMA on the CUDA cores, exponentials are `expf` (not `__expf`), the
// score is (q . k) * scale as in the Pallas body, and the result is
// acc / max(l, 1e-37), rounded once to bf16 with __float2bfloat16_rn.
//
// The tile sizes are the kernel's own: q_chunk / k_chunk only fix which
// lengths the wrapper accepts (the Pallas kernel's ValueError), since the
// result does not depend on the chunking beyond fp rounding.
//
// Bound on an H100: 2 live(row, col) (dh + dv) flop per head against q, k, v
// read once and o written once: at the qwen3-32b shape (BH 64, S 8192,
// 128/128, causal) 1.10e12 flop and 537 MB, so operations bound it (1.11 ms
// at the 989 TFLOP/s bf16 tensor-core peak, 16.4 ms at the 67 TFLOP/s fp32
// CUDA-core peak this design runs on).  bf16 calls whose head widths are
// multiples of 8 up to 256 run csrc/flash_attention_wgmma.cu on the tensor
// cores instead; this kernel keeps f32 (held to 2e-5) and the other widths.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_attn {

constexpr int kThreads = 256;        // 16 x 16 thread grid
constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per k-tile
constexpr int kDS = 32;              // head dims per Q / K slice
constexpr int kMaxDV = 256;          // value width: at most 4 groups of 64
constexpr float kNegInf = -1.0e30f;  // flash_attention.py:27
constexpr float kMinL = 1e-37f;      // flash_attention.py:77
static_assert(kBQ == 64 && kBK == 64, "the swizzles assume 64-float rows");

// shared memory: Q slice, K slice, P tile, V tile (64 x 64 NV)
constexpr int smem_floats(int nv) { return 2 * kDS * 64 + kBK * kBQ + kBK * 64 * nv; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void outer_fma(float (&c)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
}

// Rows row0.. of a (nrows, dh) matrix, dims d0..d0+31, into dst[d][r] with
// r's 4-groups XOR-swizzled by d & 7; zero past nrows and dh.  A warp loads
// 4 rows x 8 consecutive dims per step.
template <typename T>
__device__ __forceinline__ void load_slice(float* dst, const T* __restrict__ src, int row0,
                                           int nrows, int d0, int dh, int warp, int lane) {
  const int rr = lane >> 3, dd = lane & 7;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int combo = warp + 8 * it;  // 16 row groups x 4 dim groups
    const int r = 4 * (combo & 15) + rr;
    const int d = 8 * (combo >> 4) + dd;
    const int row = row0 + r, dim = d0 + d;
    dst[d * 64 + (r ^ (dd << 2))] =
        (row < nrows && dim < dh) ? to_f32(src[(size_t)row * dh + dim]) : 0.f;
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q,  // (bh, sq, dh)
                 const T* __restrict__ k,  // (bh, sk, dh)
                 const T* __restrict__ v,  // (bh, sk, dv)
                 T* __restrict__ o,        // (bh, sq, dv)
                 int bh, int sq, int sk, int dh, int dv, float scale, int causal) {
  constexpr int DVP = 64 * NV;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [kDS][64], swizzled
  float* k_s = q_s + kDS * 64;    // [kDS][64], swizzled
  float* p_s = k_s + kDS * 64;    // [kBK][kBQ], swizzled by key / 4
  float* v_s = p_s + kBK * kBQ;   // [kBK][DVP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  // the last q-tiles (the most k-tiles under `causal`) are scheduled first
  const int nq = (sq + kBQ - 1) / kBQ;
  const int b = blockIdx.x % bh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh)) * kBQ;
  const T* qb = q + (size_t)b * sq * dh;
  const T* kb = k + (size_t)b * sk * dh;
  const T* vb = v + (size_t)b * sk * dv;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / kBK + 1);

  float m[4], l[4], acc[NV][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NV; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][i][c] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    for (int e = tid; e < kBK * DVP; e += kThreads) {
      const int r = e / DVP, c = e - r * DVP;
      v_s[e] = (k0 + r < sk && c < dv) ? to_f32(vb[(size_t)(k0 + r) * dv + c]) : 0.f;
    }

    // scores of rows q0 + 4 ty + i against keys k0 + 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDS) {
      load_slice(q_s, qb, q0, sq, d0, dh, warp, lane);
      load_slice(k_s, kb, k0, sk, d0, dh, warp, lane);
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kDS; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(q_s + d * 64 + 4 * (ty ^ (d & 7)));
        const float4 bk = *reinterpret_cast<const float4*>(k_s + d * 64 + 4 * (tx ^ (d & 7)));
        outer_fma(s, a, bk);
      }
      __syncthreads();
    }

    // online softmax, as the Pallas body: masked scores are -1e30, and
    // p = exp(s - m_new) for every lane (keys past sk are masked too and
    // meet zero rows of V)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool live = col < sk && (!causal || col <= row);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int g = 0; g < NV; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][i][c] *= corr;
      m[i] = m_new;
    }

    // P[key][row]: key 4 tx + j, rows 4 ty.., 4-groups swizzled by key / 4 = tx
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (4 * tx + j) * 64 + 4 * (ty ^ tx)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(p_s + kk * 64 + 4 * (ty ^ (kk >> 2)));
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + kk * DVP + 64 * g + 4 * tx);
        outer_fma(acc[g], pp, vv);
      }
    }
    __syncthreads();  // p_s and v_s are rewritten by the next k-tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], kMinL);
    T* orow = o + ((size_t)b * sq + row) * dv;
#pragma unroll
    for (int g = 0; g < NV; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * g + 4 * tx + c;
        if (col < dv) store(orow + col, acc[g][i][c] / denom);
      }
  }
}

template <typename T, int NV>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
           int dh, int dv, float scale, int causal, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats(NV);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((sq + kBQ - 1) / kBQ) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, NV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bh, sq, sk, dh, dv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
              int dh, int dv, float scale, int causal, cudaStream_t stream) {
  switch ((dv + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    case 2: return launch<T, 2>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    case 3: return launch<T, 3>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    default: return launch<T, 4>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
  }
}

}  // namespace flash_attn

// Launch on `stream`; `bf16` selects bfloat16 q, k, v and o (else float32).
// Returns cudaGetLastError() as an int (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int sq, int sk, int dh, int dv, float scale,
                                   int causal, int bf16, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || dh < 1 || dv < 1 || dv > flash_attn::kMaxDV)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? flash_attn::launch_dv<__nv_bfloat16>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st)
              : flash_attn::launch_dv<float>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st);
}
