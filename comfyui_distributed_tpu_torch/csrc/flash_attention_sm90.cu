// Flash attention forward for Hopper (sm_90a): bf16, head dim 64, built
// from TMA, a ring of K/V stages in shared memory, wgmma and warp
// specialisation.  Plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (launched by
// `flash_attention` in comfyui_distributed_tpu/ops/pallas/flash_attention.py)
// for bf16 with D = 64, which is every attention of the SDXL UNet:
// non-causal multi-head attention, q [B, N, H, D] against k/v [B, M, H, D],
// scale 1/sqrt(D) unless given, online softmax in fp32, output
// acc / max(l, 1e-20) in bf16.  csrc/flash_attention.cu keeps the other
// head dims (mma.sync) and fp32 (FMA).
//
// What bounds it on the card.  Self-attention does 4*B*H*N*M*D operations
// on 8*B*H*N*D bytes: at (2, 4096, 4096, 10, 64) that is 85.9 GFLOP, 86.9 us
// at 989 TFLOP/s against 12.5 us for the bytes at 3.35 TB/s, and at
// (2, 1024, 1024, 20, 64) 10.9 us against 6.3 us: both are bound by the
// tensor cores.  Cross-attention (M = 77) reads and writes the long Q and
// O and is bound by memory (6.4 us and 3.4 us).  Inside the tensor-core
// bound a second limit sits close behind: for D = 64 every score needs one
// exp2 on the SFUs (16 per clock per SM), which takes as many cycles as
// the two products of its 128 x 128 tile on the tensor cores.
//
// Design, and what each part does about that:
// - Work is a 128-row Q tile of one (head, batch), BLOCK_Q = 128 and
//   BLOCK_K = 128 keys per K/V stage (the widest S tile whose accumulators,
//   64 fp32 a thread, fit beside O and P; it halves the barrier round trips
//   of 64-key tiles).  The grid is persistent: min(tiles, SMs) CTAs of 384
//   threads, one per SM, each walking every gridDim.x-th tile, so one
//   tile's epilogue and the next tile's loads overlap and K/V stay hot in
//   L2 across the CTAs working on one head.  Warpgroups 0 and 1 are
//   consumers, 64 query rows each (wgmma takes 64-row tiles), after
//   setmaxnreg.inc to 232 registers; warpgroup 2 is the producer, after
//   setmaxnreg.dec to 40, and one elected thread of it issues every copy.
// - TMA with 4-D tensor maps over [B, rows, H, D] read in place: dims
//   (D, H, rows, B), innermost first, boxes (64, 1, 128 or 64, 1), 128-byte
//   swizzle (a D = 64 bf16 row is 128 bytes).  Rows past N or M load as
//   zeros per batch, so ragged edges never bleed into the next batch, and
//   rows past N are clipped on the TMA store of O.  The maps are built on
//   the host for each call and passed as __grid_constant__ parameters.
// - Q has two buffers and K/V a ring of three stages (K and V,
//   16 KB each per 128 keys; 144 KB of shared memory with the O staging),
//   each with a full and an empty mbarrier: the producer waits on empty,
//   arms full with the bytes it will deliver and issues the copies;
//   consumers wait on full and release a buffer once their products on it
//   have completed.  Loads run ahead of the products, into the CTA's next
//   Q tile, instead of between two block barriers.
// - S = Q K^T is wgmma m64n128k16 with Q and K both read from shared
//   memory through descriptors of the 128-byte swizzle (K is K-major as it
//   lies).  O += P V is wgmma m64n64k16 with P in registers: the S
//   accumulators, scaled, exponentiated and packed to bf16 pairs, already
//   lie in the layout of the register A operand.  V is read MN-major
//   through the descriptor's transpose bit, so no transpose is made.
// - The exp2 time hides behind the tensor cores twice over.  Within a
//   warpgroup, tile i's Q K^T and tile i-1's P V are issued together and
//   tile i's softmax runs while P V does.  Between the two warpgroups,
//   named barriers make them take turns issuing (ping-pong), so one's
//   softmax runs beside the other's products.  Holding a stage across
//   that overlap is why the ring has three stages: with two the producer
//   waits for a stage that a product still reads.
// - Online softmax in the log2 domain with scale*log2(e) folded in, a
//   running max and sum per row in fp32; the column mask past M runs only
//   on the last K tile when M % 128 != 0, so the main loop has no compare.
// - Epilogue: O / max(l, 1e-20) in bf16 into shared memory in the TMA's
//   swizzle (conflict-free 4-byte stores), then one TMA store per
//   warpgroup that runs on while the CTA's next tile starts.
// Not done here, and next: the wave tail at 1024 tokens (320 tiles over
// 132 SMs: 2.4 tiles per CTA, so the last round is 40% full), which needs
// finer work units than a whole 128-row tile; cross-attention (M = 77) is
// bound by each tile's chain of load, two products and store, not by the
// bytes.
//
// ptxas (nvcc -Xptxas -v on the card, CUDA 12.9): 168 registers at entry
// (setmaxnreg moves them to 232 per consumer thread and 40 per producer
// thread), no spills, no serialized wgmma; PERF.md has the full report.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int D = 64;
constexpr int BLOCK_Q = 128;           // query rows per work tile
constexpr int BLOCK_K = 128;           // keys per K/V stage
constexpr int WG_ROWS = 64;            // query rows per consumer warpgroup
constexpr int CONSUMERS = 2;           // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 3;              // K/V ring depth
constexpr int ROW_BYTES = D * 2;       // 128: one swizzle row
constexpr int TILE_BYTES = BLOCK_K * ROW_BYTES;   // 16 KB (= BLOCK_Q rows)
constexpr int WG_BYTES = WG_ROWS * ROW_BYTES;     // 8 KB
// shared memory: Q | K stages | V stages | O staging | barriers
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + 2 * TILE_BYTES;  // two Q buffers
constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
constexpr int OFF_O = OFF_V + STAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_O + TILE_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 4) + 1024;  // + alignment
constexpr int BAR_STORE = 1;   // named barriers 1, 2: a warpgroup before its store
constexpr int BAR_SCHED = 3;   // named barriers 3, 4: the warpgroups' turns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wait that outlasts 2^28 polls (seconds; a real one takes microseconds)
// is a broken ring: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// ---- TMA -----------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Matrix descriptor of a tile in the 128-byte swizzle TMA writes: rows of
// 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset); the
// leading byte offset is unused by these layouts.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in
// shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the consumer warpgroups ---------------------------------------------

// Accumulator layout of a 64-row wgmma (each warp owns 16 rows): element
// 4*j + e of a thread is row g + 8*(e >> 1), column 8*j + 2*t + (e & 1),
// with g = lane / 4, t = lane % 4.  For 16 consecutive columns it is also
// the register A operand's layout, so P never leaves the registers.
struct Consumer {
  uint64_t dq;  // descriptor of this warpgroup's 64 Q rows
  uint32_t sk, sv, bar_full, bar_empty;
  int kv0;      // K/V tiles this CTA consumed before the current Q tile
  float scale_log2;
  int wg, t, lane;
  float o[32];               // O accumulator
  float sc[64];              // S of the newest tile, then its probabilities
  uint32_t pa[32];           // P of the tile whose P V is issued next, bf16 pairs
  float m_run[2], l_run[2];  // running max (log2 domain), this thread's share of the row sums

  __device__ __forceinline__ int stage(int it) const { return (kv0 + it) % STAGES; }
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(bar_full + 8 * stage(it), ((kv0 + it) / STAGES) & 1);
  }
  // this warp is done with the stage of K/V tile `it`
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage(it));
  }
  // The two consumer warpgroups take turns issuing their products (named
  // barriers BAR_SCHED + wg), so one's softmax runs beside the other's
  // products instead of both contending for the tensor cores at once.
  __device__ __forceinline__ void sched_wait() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(BAR_SCHED + wg) : "memory");
  }
  __device__ __forceinline__ void sched_pass() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(BAR_SCHED + (wg ^ 1)) : "memory");
  }

  // S = Q K^T over tile it's 128 keys: four k-steps of 16 along D
  __device__ __forceinline__ void issue_qk(int it) {
    const uint64_t dk = smem_desc(sk + stage(it) * TILE_BYTES);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) wgmma_m64n128k16_ss(sc, dq + 2 * kc, dk + 2 * kc, kc > 0);
  }
  // O += P V over tile it: k-step kk takes keys 16*kk .. 16*kk + 15, i.e.
  // the 8-column blocks 2*kk and 2*kk + 1 of S, and V's rows from 16*kk
  // on (2048 bytes each)
  __device__ __forceinline__ void issue_pv(int it) {
    const uint64_t dv = smem_desc(sv + stage(it) * TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk)
      wgmma_m64n64k16_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         dv + (uint64_t)((kk * 16 * ROW_BYTES) >> 4));
  }

  // online softmax in the log2 domain: S -> P in place, the running max
  // and sums updated, corr the factor that rescales O to the new max.
  // Columns at or past `valid` are masked (the last tile only).
  template <bool MASK>
  __device__ __forceinline__ void softmax(int valid, float (&corr)[2]) {
    if (MASK) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= valid) sc[4 * j + e] = NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r] * scale_log2);
      corr[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -m_new[e >> 1]));
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], corr[r], sum[r]);
  }

  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }

  // Tile it >= 1: S_it = Q K_it^T and O += P_{it-1} V_{it-1} are issued
  // together; the softmax of S_it runs while the second product does.
  template <bool MASK>
  __device__ __forceinline__ void step(int it, int valid) {
    wait_full(it);
    fence_regs(pa);
    fence_regs(o);
    sched_wait();
    wgmma_fence();
    issue_qk(it);
    wgmma_commit();
    issue_pv(it - 1);
    wgmma_commit();
    sched_pass();
    wgmma_wait<1>();
    fence_regs(sc);
    float corr[2];
    softmax<MASK>(valid, corr);
    wgmma_wait<0>();
    fence_regs(o);
    release(it - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
    pack();
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                   int N, int M, int H, int B, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1024
  const uint32_t sq = base + OFF_Q, sk = base + OFF_K, sv = base + OFF_V, so = base + OFF_O;
  const uint32_t bar_full = base + OFF_BAR;          // + 8 * K/V stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 * K/V stage
  const uint32_t bar_qfull = bar_empty + 8 * STAGES;  // + 8 * Q buffer
  const uint32_t bar_qempty = bar_qfull + 16;         // + 8 * Q buffer

  // Q tiles in order (tile, head, batch); this CTA takes every gridDim.x-th
  const int q_tiles = (N + BLOCK_Q - 1) / BLOCK_Q;
  const int n_work = q_tiles * H * B;
  const int n_tiles = (M + BLOCK_K - 1) / BLOCK_K;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the Q buffers and the K/V ring full,
    // running ahead into the CTA's next Q tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      int kv = 0;
      for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        const int q0 = (w % q_tiles) * BLOCK_Q, h = (w / q_tiles) % H, b = w / (q_tiles * H);
        const int qb = j & 1;
        mbar_wait(bar_qempty + 8 * qb, ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(bar_qfull + 8 * qb, TILE_BYTES);
        tma_load(sq + qb * TILE_BYTES, &tm_q, bar_qfull + 8 * qb, 0, h, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(bar_empty + 8 * s, ((kv / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * TILE_BYTES);
          tma_load(sk + s * TILE_BYTES, &tm_k, bar_full + 8 * s, 0, h, it * BLOCK_K, b);
          tma_load(sv + s * TILE_BYTES, &tm_v, bar_full + 8 * s, 0, h, it * BLOCK_K, b);
        }
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32;
    Consumer c;
    c.sk = sk;
    c.sv = sv;
    c.bar_full = bar_full;
    c.bar_empty = bar_empty;
    c.scale_log2 = scale_log2;
    c.wg = wg;
    c.lane = tid % 32;
    c.t = c.lane % 4;
    c.kv0 = 0;
    const int g = c.lane / 4;
    const int n_full = M / BLOCK_K;  // K/V tiles with no key past M
    const uint32_t so_wg = so + wg * WG_BYTES;
    // warpgroup 0 takes the first turn
    if (wg == 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(BAR_SCHED) : "memory");
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
      const int q0 = (w % q_tiles) * BLOCK_Q, h = (w / q_tiles) % H, b = w / (q_tiles * H);
      const bool last_work = w + (int)gridDim.x >= n_work;
      const int qb = j & 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) c.o[i] = 0.f;
      c.m_run[0] = c.m_run[1] = NEG_INF;
      c.l_run[0] = c.l_run[1] = 0.f;
      c.dq = smem_desc(sq + qb * TILE_BYTES + wg * WG_BYTES);
      mbar_wait(bar_qfull + 8 * qb, (j >> 1) & 1);

      // K/V tile 0: S and its softmax; O is still zero
      c.wait_full(0);
      c.sched_wait();
      wgmma_fence();
      c.issue_qk(0);
      wgmma_commit();
      c.sched_pass();
      wgmma_wait<0>();
      fence_regs(c.sc);
      float corr[2];
      if (n_full == 0)
        c.softmax<true>(M, corr);
      else
        c.softmax<false>(BLOCK_K, corr);
      c.pack();
      for (int it = 1; it < n_full; ++it) c.step<false>(it, BLOCK_K);
      if (n_full >= 1 && n_full < n_tiles) c.step<true>(n_full, M - n_full * BLOCK_K);
      // the last K/V tile's P V; Q is free once it is issued
      fence_regs(c.pa);
      fence_regs(c.o);
      c.sched_wait();
      wgmma_fence();
      c.issue_pv(n_tiles - 1);
      wgmma_commit();
      if (wg == 0 || !last_work) c.sched_pass();  // warpgroup 1's very last turn: nobody waits
      __syncwarp();
      if (c.lane == 0) mbar_arrive(bar_qempty + 8 * qb);
      wgmma_wait<0>();
      fence_regs(c.o);
      c.release(n_tiles - 1);
      c.kv0 += n_tiles;

      // epilogue: O / l in bf16, staged in shared memory in the TMA's
      // swizzle once the previous tile's store has read it, then stored by
      // TMA while the next tile runs
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = c.l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-20f);
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_STORE + wg) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const uint32_t addr = so_wg + row * ROW_BYTES + ((jj ^ (row & 7)) << 4) + (c.t << 2);
          const uint32_t val =
              pack_bf16(c.o[4 * jj + 2 * r] * inv[r], c.o[4 * jj + 2 * r + 1] * inv[r]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_STORE + wg) : "memory");
      if (tid == 0 && q0 + wg * WG_ROWS < N) {
        tma_store(&tm_o, so_wg, 0, h, q0 + wg * WG_ROWS, b);
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library need not link
// libcuda itself
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, rows, H, D] bf16 as a 4-D map (D, H, rows, B), box (D, 1, box_rows, 1)
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int rows,
              int heads, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ROW_BYTES, (cuuint64_t)ROW_BYTES * heads,
                                 (cuuint64_t)ROW_BYTES * heads * rows};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// bf16 q [B, N, H, 64], k/v [B, M, H, 64], o [B, N, H, 64], contiguous and
// 16-byte aligned.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take,
// cudaErrorMisalignedAddress for a base that is not 16-byte aligned).
extern "C" int dtpu_flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                             int batch, int n, int m, int heads, int head_dim,
                                             float scale, void* stream) {
  // the mask folds the scale into the running max, so it must be positive
  if (head_dim != D || batch <= 0 || n <= 0 || m <= 0 || heads <= 0 || !(scale > 0.f) ||
      (long long)((n + BLOCK_Q - 1) / BLOCK_Q) * heads * batch > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(encode, &tq, q, batch, n, heads, BLOCK_Q) ||
      !make_map(encode, &tk, k, batch, m, heads, BLOCK_K) ||
      !make_map(encode, &tv, v, batch, m, heads, BLOCK_K) ||
      !make_map(encode, &to, o, batch, n, heads, WG_ROWS))
    return (int)cudaErrorInvalidValue;
  // once per process: the shared-memory opt-in and the SM count
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  // persistent: one CTA per SM at most, each walking its share of Q tiles
  const long long work = (long long)((n + BLOCK_Q - 1) / BLOCK_Q) * heads * batch;
  const unsigned grid = (unsigned)(work < sms ? work : sms);
  flash_fwd_sm90<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, n, m, heads, batch, scale * LOG2E);
  return (int)cudaGetLastError();
}
