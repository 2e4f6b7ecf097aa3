// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` in comfyui_distributed_tpu/ops/pallas/flash_attention.py:
// non-causal multi-head attention, q [B, N, H, D] against k/v [B, M, H, D]
// (M != N for cross-attention), scale 1/sqrt(D) unless given, online softmax
// in fp32 (running max, running sum, fp32 accumulator), output
// acc / max(l, 1e-20) in the input type.
//
// Bound on the card.  At the SDXL shapes (B = 2, D = 64) self-attention does
// 4*B*H*N*M*D operations on 8*B*H*N*D bytes (bf16 Q, K, V, O): 85.9 GFLOP on
// 42 MB at N = M = 4096, so it is bound by the tensor cores (87 us at
// 989 TFLOP/s against 12.5 us at 3.35 TB/s).  Cross-attention (M = 77) reads
// and writes the long Q and O and is bound by memory (6.3 us at N = 4096).
// The SD1.5 shapes (B = 32, 8 heads, D = 40/80/160) split the same way:
// self-attention at N = 4096, D = 40 is 687 GFLOP (0.69 ms at 989 TFLOP/s),
// cross-attention reads Q and writes O (50 us at N = 4096).
//
// Design.  The TPU kernel held one head's whole padded K/V in VMEM and padded
// D to 128 lanes; neither carries over.  Here one CTA of four warps owns a
// 64-row Q tile of one (batch, head) and streams K/V through shared memory
// in 64-row tiles, so the [N, M] score matrix never reaches device memory
// and K/V are read once per Q tile.  Each warp owns 16 query rows: the
// products QK^T and PV run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), the online-softmax state stays in fp32 registers, and
// the probabilities are re-packed from the score accumulators into the A
// operand of the PV product without touching shared memory.  Shared rows are
// padded by 8 elements so the fragment loads are free of bank conflicts; V is
// stored transposed so its fragments are single 32-bit loads.  A head dim
// that is not a multiple of the 16-deep k-step (D = 40) runs Q K^T over Q and
// K zero-filled to the next multiple of 16 in shared memory; P V needs only
// D % 8 == 0.  Q's tile is dead once its fragments sit in registers, so each
// K tile reuses its shared memory, which keeps D = 160 (66 KB otherwise)
// within the 48 KB of static shared memory.  fp32 input takes a plain FMA
// path (one query row per one, two or four threads, so that no thread holds
// more than 64 of a row's columns), kept for exact fp32 comparisons.  Ragged
// edges of N and M are masked in the kernel.  The loads are synchronous (no
// cp.async/TMA pipeline) and the products are mma.sync, not wgmma: the
// design is simple first, and falls short of the tensor-core bound by the
// latency those leave exposed.
//
// Layout: q, k, v and o are read and written in place as contiguous
// [B, rows, H, D] through the row stride H*D; no transpose is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int F32_BLOCK_K = 32;
constexpr int F32_CHUNK = 16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16: one CTA per (batch*head, 64-row Q tile), four warps of 16 rows each.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int N, int M, int H, float scale_log2, int q_tiles) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static_assert(BLOCK_Q == BLOCK_K, "each K tile reuses the Q tile's shared memory");
  constexpr int DK = (D + 15) / 16 * 16;  // Q/K columns in shared memory, zero past D
  constexpr int DP = DK + 8;              // padded Q/K row
  constexpr int KP = BLOCK_K + 8;         // padded V^T row
  constexpr int CH = DK / 8;              // 16-byte chunks per shared Q/K row
  constexpr int KC = DK / 16;             // k-steps of QK^T
  constexpr int NB = BLOCK_K / 8;         // 8-key column blocks of S
  constexpr int ND = D / 8;               // 8-wide column blocks of O
  // the Q tile until its fragments are in registers, then each K tile
  __shared__ __align__(16) __nv_bfloat16 qk[BLOCK_Q][DP];
  __shared__ __align__(16) __nv_bfloat16 vt[D][KP];

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = (int64_t)H * D;
  const __nv_bfloat16* qb = q + (int64_t)b * N * stride + (int64_t)h * D;
  const __nv_bfloat16* kb = k + (int64_t)b * M * stride + (int64_t)h * D;
  const __nv_bfloat16* vb = v + (int64_t)b * M * stride + (int64_t)h * D;
  __nv_bfloat16* ob = o + (int64_t)b * N * stride + (int64_t)h * D;
  const int q0 = tile * BLOCK_Q;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BLOCK_Q * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (c < D && q0 + r < N) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&qk[r][c]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    qa[kc][0] = ld32(&qk[r0][kc * 16 + t * 2]);
    qa[kc][1] = ld32(&qk[r0 + 8][kc * 16 + t * 2]);
    qa[kc][2] = ld32(&qk[r0][kc * 16 + 8 + t * 2]);
    qa[kc][3] = ld32(&qk[r0 + 8][kc * 16 + 8 + t * 2]);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int k0 = 0; k0 < M; k0 += BLOCK_K) {
    // every warp is done with the previous K/V tile (or, first, with Q)
    __syncthreads();
    for (int i = tid; i < BLOCK_K * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (c < D && k0 + r < M) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * stride + c);
      }
      *reinterpret_cast<uint4*>(&qk[r][c]) = kv;
      if (c < D) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt[c + j][r] = ve[j];
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16_16816(s[nb], qa[kc], ld32(&qk[nb * 8 + g][kc * 16 + t * 2]),
                       ld32(&qk[nb * 8 + g][kc * 16 + 8 + t * 2]));
    }

    // scale into the log2 domain, mask keys past M, row max over the tile
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + t * 2 + (e & 1);
        const float x = col < M ? s[nb][e] * scale_log2 : NEG_INF;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);
      const float corr = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_run[r] *= corr;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * r] *= corr;
        acc[nd][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m_new[e >> 1]);
        s[nb][e] = p;
        l_run[e >> 1] += p;
      }

    // O += P V: the score accumulators of two 8-key blocks form the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        mma_bf16_16816(acc[nd], pa, ld32(&vt[nd * 8 + g][kk * 16 + t * 2]),
                       ld32(&vt[nd * 8 + g][kk * 16 + 8 + t * 2]));
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row < N) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<uint32_t*>(ob + row * stride + nd * 8 + t * 2) =
            pack_bf16(acc[nd][2 * r] * inv[r], acc[nd][2 * r + 1] * inv[r]);
    }
  }
}

// fp32: TPR threads per query row, each holding DS = D / TPR of its columns
// (at most 64, so D = 80 and 160 do not spill), K/V tiles in shared memory,
// FMA products; the TPR partial dot products meet by warp shuffles.
template <int D>
struct F32Layout {
  static constexpr int TPR = D <= 64 ? 1 : (D <= 128 ? 2 : 4);
  static constexpr int DS = D / TPR;
  static constexpr int THREADS = BLOCK_Q * TPR;
  static_assert(D % TPR == 0, "head dim must split evenly over a row's threads");
};

template <int D>
__global__ void __launch_bounds__(F32Layout<D>::THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int N, int M, int H, float scale_log2, int q_tiles) {
  constexpr int TPR = F32Layout<D>::TPR;
  constexpr int DS = F32Layout<D>::DS;
  constexpr int NT = F32Layout<D>::THREADS;
  __shared__ float ks[F32_BLOCK_K][D];
  __shared__ float vs[F32_BLOCK_K][D];
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int64_t stride = (int64_t)H * D;
  const float* kb = k + (int64_t)b * M * stride + (int64_t)h * D;
  const float* vb = v + (int64_t)b * M * stride + (int64_t)h * D;
  const int row = tile * BLOCK_Q + tid / TPR;
  const int d0 = (tid % TPR) * DS;  // this thread's first column
  const bool live = row < N;
  const float* qr = q + ((int64_t)b * N + (live ? row : 0)) * stride + (int64_t)h * D + d0;

  float qv[DS], acc[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    qv[d] = live ? qr[d] : 0.f;
    acc[d] = 0.f;
  }
  float m_run = NEG_INF, l_run = 0.f;

  for (int k0 = 0; k0 < M; k0 += F32_BLOCK_K) {
    __syncthreads();
    for (int i = tid; i < F32_BLOCK_K * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < M;
      ks[r][c] = in ? kb[(k0 + r) * stride + c] : 0.f;
      vs[r][c] = in ? vb[(k0 + r) * stride + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < F32_BLOCK_K; c0 += F32_CHUNK) {
      float s[F32_CHUNK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DS; ++d) dot = fmaf(qv[d], ks[c0 + j][d0 + d], dot);
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[j] = k0 + c0 + j < M ? dot * scale_log2 : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float corr = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= corr;
#pragma unroll
      for (int d = 0; d < DS; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        const float p = exp2f(s[j] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < DS; ++d) acc[d] = fmaf(p, vs[c0 + j][d0 + d], acc[d]);
      }
    }
  }
  if (live) {
    const float inv = 1.f / fmaxf(l_run, 1e-20f);
    float* orow = o + ((int64_t)b * N + row) * stride + (int64_t)h * D + d0;
#pragma unroll
    for (int d = 0; d < DS; ++d) orow[d] = acc[d] * inv;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int N, int M, int H,
            float scale_log2, int dtype, cudaStream_t stream) {
  const int q_tiles = (N + BLOCK_Q - 1) / BLOCK_Q;
  const dim3 grid((unsigned)B * H * q_tiles);
  if (dtype == 1) {
    flash_fwd_bf16<D><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, M, H,
        scale_log2, q_tiles);
  } else {
    flash_fwd_f32<D><<<grid, F32Layout<D>::THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), N, M, H, scale_log2, q_tiles);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a dtype or head dim the kernel does not take).
extern "C" int dtpu_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int batch, int n, int m, int heads, int head_dim,
                                        float scale, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || n <= 0 || m <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    case 32: launch<32>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    case 40: launch<40>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    case 64: launch<64>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    case 80: launch<80>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    case 160: launch<160>(q, k, v, o, batch, n, m, heads, scale_log2, dtype, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
