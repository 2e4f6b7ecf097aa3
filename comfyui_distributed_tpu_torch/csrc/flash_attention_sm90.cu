// Flash attention forward for Hopper (sm_90a): bf16 at head dims 40, 64,
// 80 and 160, built from TMA, a ring of K/V stages in shared memory, wgmma
// and warp specialisation.  Plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (launched by
// `flash_attention` in comfyui_distributed_tpu/ops/pallas/flash_attention.py)
// for bf16 with D in {40, 64, 80, 160}: every attention of the SDXL UNet
// (D = 64) and of the SD1.5 UNet (eight heads at widths 320, 640 and 1280:
// D = 40, 80, 160).  Non-causal multi-head attention, q [B, N, H, D]
// against k/v [B, M, H, D], scale 1/sqrt(D) unless given, online softmax
// in fp32, output acc / max(l, 1e-20) in bf16.  csrc/flash_attention.cu
// keeps the tiny family's head dims (16, 32; mma.sync) and fp32 (FMA).
//
// What bounds it on the card (published peaks: 989 TFLOP/s bf16, 3.35
// TB/s, and 16 exp2 per clock per SM on the SFUs, 3.865e12 a second at the
// 1.83 GHz behind the tensor-core peak).  Self-attention does 4*B*H*N*M*D
// operations on 8*B*H*N*D bytes and needs one exp2 per score:
// - D = 64 (SDXL, (2, 4096, 4096, 10)): the tensor cores, with the SFUs
//   close behind: each score's exp2 takes as many cycles as the two
//   products of its 128 x 128 tile.
// - D = 40 (SD1.5, (32, 4096, 4096, 8)): the SFUs.  The products are
//   shorter than the exp2s: 4.295e9 exp2 need 1.111 ms against 0.695 ms
//   on the tensor cores, so no design with one hardware exp2 per score
//   goes below that.
// - D = 80 ((32, 1024, 1024, 8)): the tensor cores (86.9 us; the SFUs
//   69.5 us).
// - Cross-attention (M = 77) and D = 160 (N <= 256): the bytes of the long
//   Q and O, and each work tile's chain of load, products and store.
//
// Design, and what each part does about that:
// - Work is a Q tile of 64 rows per consumer warpgroup of one (head,
//   batch) against K/V stages of BLOCK_K = 128 keys (64 at D = 160, where
//   O takes 80 registers a thread).  The grid is persistent: min(tiles,
//   SMs) CTAs, one per SM, each walking every gridDim.x-th tile, so one
//   tile's epilogue and the next tile's loads overlap and K/V stay hot in
//   L2 across the CTAs working on one head.  The last warpgroup is the
//   producer, after setmaxnreg.dec, and one elected thread of it issues
//   every copy; the consumers take the registers it gives up.
// - Consumers (Geometry::CONSUMERS).  At D = 64, 80 and 160 two warpgroups
//   (a 128-row tile, 232 registers a thread) overlap within themselves:
//   tile i's Q K^T and tile i-1's P V are issued together and tile i's
//   softmax runs while P V does, and named barriers make the two take
//   turns issuing (ping-pong), so one's softmax runs beside the other's
//   products.  Holding a stage across that overlap is why the ring has
//   three stages: with two the producer waits for a stage that a product
//   still reads.  At D = 40 the products are short and each warpgroup's
//   chain of Q K^T, softmax and P V is what takes the time, so three
//   warpgroups (a 192-row tile, 160 registers a thread) each run that
//   chain in sequence and the overlap comes from the other two; S and P
//   are then never live together, which is what lets three fit.
// - Head dims (Geometry).  A row of D bf16 values lies in shared memory as
//   column blocks, each a [rows x width] tile in the swizzle of its width
//   in bytes: 64-column blocks with the 128-byte swizzle, then a tail of
//   32 columns (64-byte swizzle, D = 160) or 16 (32-byte, D = 80).  Each
//   block has its own tensor maps, so every wgmma reads within one block
//   and the descriptors need no leading byte offset.  D = 40 takes one
//   64-column block whose columns 40-63 the TMA fills with zeros (the map's
//   innermost dim is 40): Q K^T runs three 16-deep k-steps (48 columns)
//   instead of four, P V computes N = 40, and the TMA store of O clips the
//   columns past 40.  Shared memory is 144 KB at D = 64, 168 KB at D = 40,
//   180 KB at D = 80 and 200 KB at D = 160, where O is staged in its
//   tile's own Q buffer (a separate staging tile would not fit).
// - TMA with 4-D tensor maps over [B, rows, H, D] read in place: dims
//   (D, H, rows, B), innermost first, boxes (block width, 1, rows, 1).
//   Rows past N or M load as zeros per batch, so ragged edges never bleed
//   into the next batch, and rows past N are clipped on the TMA store of
//   O.  The maps are built on the host for each call and passed as a
//   __grid_constant__ parameter.
// - Q has two buffers and K/V a ring of three stages, each with a full and
//   an empty mbarrier: the producer waits on empty, arms full with the
//   bytes it will deliver and issues the copies; consumers wait on full
//   and release a buffer once their products on it have completed.  Loads
//   run ahead of the products, into the CTA's next Q tile, instead of
//   between two block barriers.
// - S = Q K^T is wgmma m64n128k16 (m64n64k16 at D = 160) with Q and K both
//   read from shared memory through descriptors of their block's swizzle
//   (K is K-major as it lies).  O += P V is one wgmma m64nWk16 per column
//   block with P in registers: the S accumulators, scaled, exponentiated
//   and packed to bf16 pairs, already lie in the layout of the register A
//   operand.  V is read MN-major through the descriptor's transpose bit,
//   so no transpose is made.
// - Online softmax in the log2 domain with scale*log2(e) folded in, a
//   running max and sum per row in fp32, exp2 on the SFUs with subnormal
//   results flushed; the column mask past M runs only on the last K tile
//   when M % BLOCK_K != 0, so the main loop has no compare.
// - Epilogue: O / max(l, 1e-20) in bf16 into shared memory in the TMA's
//   swizzle (4-byte stores), then one TMA store per column block and
//   warpgroup that runs on while the CTA's next tile starts.
// Tried on the card and not kept (PERF.md): a cubic exp2 on the FMA
// pipes for one score in four or eight, since at D = 40 the SFUs are not
// yet the limit (removing the exp2 altogether barely moved the time); four
// partial maxima and sums a row (slower); skipping the exp2s of 8-column
// blocks wholly past M (no faster, and ptxas spilled); four consumer
// warpgroups at D = 40 (no faster with 64-key stages; with 128-key stages
// they spill).  Not done here, and next: the wave tail (at 1024 tokens 320
// or 2048 tiles over 132 SMs), which needs finer work units than a whole
// tile; cross-attention (M = 77) is bound by each tile's chain of load,
// two products and store, not by the bytes; at D = 40 the softmax of
// each warpgroup still takes longer than its exp2s on the SFUs would.
//
// ptxas (nvcc -Xptxas -v on the card): 168 registers at entry at D = 64,
// 80 and 160 (setmaxnreg moves them to 232 a consumer thread and 40 a
// producer thread), 128 at D = 40 (to 160 and 32); no spills, no
// serialized wgmma; PERF.md has every instantiation's report.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>


namespace {

constexpr int WG_ROWS = 64;            // query rows per consumer warpgroup
constexpr int STAGES = 3;              // K/V ring depth
constexpr int BAR_STORE = 1;   // named barriers 1-3: a warpgroup before its store
constexpr int BAR_SCHED = 4;   // named barriers 4, 5: the warpgroups' turns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// How rows of head dim D lie in shared memory, and the tile sizes.
template <int D>
struct Geometry {
  // Consumer warpgroups of 64 query rows each.  Two overlap their own
  // products with their softmax (OVERLAP: tile i's Q K^T issued with tile
  // i-1's P V, which keeps S and P live at once) and take turns issuing.
  // At D = 40 three run each tile's product, softmax and product in
  // sequence instead: the registers of S and P are never live together,
  // so three fit, and the overlap comes from the other warpgroups.
  static constexpr int CONSUMERS = D == 40 ? 3 : 2;
  static constexpr bool OVERLAP = CONSUMERS == 2;
  static constexpr int BLOCK_Q = WG_ROWS * CONSUMERS;  // query rows per work tile
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  // Registers a thread after setmaxnreg, the producer's and the
  // consumers'.  setmaxnreg only moves registers within the block's launch
  // allocation (65536 / THREADS a thread, in steps of 8): a consumer
  // warpgroup that asks for more than the producer gave up waits forever.
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                    (CONSUMERS + 1) * (65536 / THREADS / 8 * 8),
                "setmaxnreg asks for more registers than the launch holds");
  static constexpr int NB = D == 160 ? 3 : D == 80 ? 2 : 1;  // column blocks
  // columns of block c: 64 (128-byte swizzle), the tail 32 or 16
  __host__ __device__ static constexpr int width(int c) {
    return D == 40 ? 64 : (c + 1) * 64 <= D ? 64 : D - 64 * c;
  }
  // first column of block c (every block but the last is 64 wide)
  __host__ __device__ static constexpr int col0(int c) { return 64 * c; }
  // columns of O that block c's P V computes
  __host__ __device__ static constexpr int pv_cols(int c) { return D == 40 ? 40 : width(c); }
  // O accumulators of a consumer thread before block c's
  __host__ __device__ static constexpr int o_off(int c) {
    return c == 0 ? 0 : o_off(c - 1) + pv_cols(c - 1) / 2;
  }
  static constexpr int COLS = D == 40 ? 64 : D;  // columns in shared memory
  static constexpr int QK_STEPS = (D + 15) / 16;  // 16-deep k-steps of Q K^T
  static constexpr int O_REGS = D / 2;            // O accumulators a thread
  static constexpr int BLOCK_K = D == 160 ? 64 : 128;  // keys per K/V stage
  static constexpr bool O_IN_Q = D == 160;  // O staged in its Q buffer
  static constexpr int Q_BYTES = BLOCK_Q * COLS * 2;
  static constexpr int KV_BYTES = BLOCK_K * COLS * 2;
  // shared memory: Q buffers | K stages | V stages | O staging | barriers
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_O = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_O + (O_IN_Q ? 0 : Q_BYTES);
  static constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 4) + 1024;  // + alignment
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(o_off(NB) == O_REGS, "O accumulators");
};

// f(integral_constant<int, I>), ..., f(integral_constant<int, N - 1>)
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

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

// Matrix descriptor of a tile in the swizzle TMA writes for rows of RB
// bytes (128, 64 or 32): 8-row groups 8 * RB bytes apart (the stride byte
// offset).  The leading byte offset is unused: a K-major k-step lies
// within one row, and an MN-major V block within one swizzle atom.
template <int RB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * RB >> 4) << 32) | (layout << 62);
}

// the 16-byte chunk of a row that chunk j lands in under the swizzle of
// RB-byte rows: address bits 4.. take the XOR of bits 7.. (row index bits)
template <int RB>
__device__ __forceinline__ int swizzle_chunk(int row, int j) {
  return RB == 128 ? j ^ (row & 7) : RB == 64 ? j ^ ((row >> 1) & 3) : j ^ ((row >> 2) & 1);
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

// d[64 x N] (+)= A[64 x 16] * B[N x 16]^T, A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);
// d[64 x N] += A[64 x 16] * B[16 x N], A in registers, B MN-major in shared
// memory (transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


// 2^x on the SFU with results below 2^-126 flushed to zero: exp2f's
// subnormal handling costs three more instructions a score, and a
// probability that small is far below bf16's resolution of its row sum
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the consumer warpgroups ---------------------------------------------

// Accumulator layout of a 64-row wgmma (each warp owns 16 rows): element
// 4*j + e of a thread is row g + 8*(e >> 1), column 8*j + 2*t + (e & 1),
// with g = lane / 4, t = lane % 4.  For 16 consecutive columns it is also
// the register A operand's layout, so P never leaves the registers.  O is
// the column blocks' accumulators one after another (Geometry::o_off);
// each holds a multiple of 4, so element i of O is row g + 8*((i & 3) >> 1)
// of its block.
template <int D>
struct Consumer {
  using G = Geometry<D>;
  static constexpr int BLOCK_K = G::BLOCK_K, BLOCK_Q = G::BLOCK_Q;
  uint32_t sq;  // the current Q buffer (all 128 rows)
  uint32_t sk, sv, bar_full, bar_empty;
  int kv0;      // K/V tiles this CTA consumed before the current Q tile
  float scale_log2;
  int wg, t, lane;
  uint64_t dq[G::NB];              // descriptors of this warpgroup's 64 Q rows, by block
  float o[G::O_REGS];              // O accumulator
  float sc[BLOCK_K / 2];           // S of the newest tile, then its probabilities
  uint32_t pa[BLOCK_K / 4];        // P of the tile whose P V is issued next, bf16 pairs
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
  // The consumer warpgroups take turns issuing their products (named
  // barriers BAR_SCHED + wg, passed round the warpgroups), so one's
  // softmax runs beside another's products instead of all contending for
  // the tensor cores at once.
  __device__ __forceinline__ void sched_wait() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(BAR_SCHED + wg) : "memory");
  }
  __device__ __forceinline__ void sched_pass() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(BAR_SCHED + (wg + 1) % G::CONSUMERS) : "memory");
  }

  // the Q buffer's descriptors: this warpgroup's rows of each block
  __device__ __forceinline__ void set_q(uint32_t q_buffer) {
    sq = q_buffer;
    static_for<0, G::NB>([&](auto ic) {
      constexpr int c = decltype(ic)::value;
      constexpr int rb = G::width(c) * 2;
      dq[c] = smem_desc<rb>(q_buffer + BLOCK_Q * G::col0(c) * 2 + wg * WG_ROWS * rb);
    });
  }

  // S = Q K^T over tile it's keys: k-step kc takes columns 16*kc ..
  // 16*kc + 15, 32 bytes a step into the rows of their column block
  __device__ __forceinline__ void issue_qk(int it) {
    const uint32_t k_tile = sk + stage(it) * G::KV_BYTES;
    static_for<0, G::QK_STEPS>([&](auto ikc) {
      constexpr int kc = decltype(ikc)::value;
      constexpr int c = kc / 4;
      constexpr int rb = G::width(c) * 2;
      constexpr uint64_t step = (kc * 16 - G::col0(c)) * 2 / 16;  // in 16-byte units
      const uint64_t dk = smem_desc<rb>(k_tile + BLOCK_K * G::col0(c) * 2);
      wgmma_ss<BLOCK_K>(sc, dq[c] + step, dk + step, kc > 0);
    });
  }
  // O += P V over tile it, one product per column block: k-step kk takes
  // keys 16*kk .. 16*kk + 15, i.e. the 8-column blocks 2*kk and 2*kk + 1
  // of S, and V's rows from 16*kk on
  __device__ __forceinline__ void issue_pv(int it) {
    const uint32_t v_tile = sv + stage(it) * G::KV_BYTES;
    static_for<0, G::NB>([&](auto ic) {
      constexpr int c = decltype(ic)::value;
      constexpr int rb = G::width(c) * 2;
      constexpr int n = G::pv_cols(c);
      const uint64_t dv = smem_desc<rb>(v_tile + BLOCK_K * G::col0(c) * 2);
      float(&oc)[n / 2] = *reinterpret_cast<float(*)[n / 2]>(o + G::o_off(c));
#pragma unroll
      for (int kk = 0; kk < BLOCK_K / 16; ++kk)
        wgmma_rs<n>(oc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                    dv + (uint64_t)((kk * 16 * rb) >> 4));
    });
  }

  // online softmax in the log2 domain: S -> P in place, the running max
  // and sums updated, corr the factor that rescales O to the new max.
  // Columns at or past `valid` are masked (the last tile only).
  template <bool MASK>
  __device__ __forceinline__ void softmax(int valid, float (&corr)[2]) {
    if (MASK) {
#pragma unroll
      for (int j = 0; j < BLOCK_K / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= valid) sc[4 * j + e] = NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r] * scale_log2);
      corr[r] = exp2_ftz(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -m_new[e >> 1]));
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], corr[r], sum[r]);
  }

  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
      pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }

  // The tiles of one Q tile in sequence (no OVERLAP): S = Q K^T, its
  // softmax, O rescaled, O += P V, and the stage released.
  __device__ __forceinline__ void run_sequential(int n_full, int n_tiles, int M) {
    for (int it = 0; it < n_tiles; ++it) {
      wait_full(it);
      wgmma_fence();
      issue_qk(it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float corr[2];
      if (it < n_full)
        softmax<false>(BLOCK_K, corr);
      else
        softmax<true>(M - it * BLOCK_K, corr);
#pragma unroll
      for (int i = 0; i < G::O_REGS; ++i) o[i] *= corr[(i & 3) >> 1];
      pack();
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
      issue_pv(it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(it);
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
    for (int i = 0; i < G::O_REGS; ++i) o[i] *= corr[(i & 3) >> 1];
    pack();
  }
};

// the tensor maps of q, k, v and o, one per column block
template <int NB>
struct Maps {
  CUtensorMap q[NB], k[NB], v[NB], o[NB];
};

template <int D>
__global__ void __launch_bounds__(Geometry<D>::THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ Maps<Geometry<D>::NB> maps, int N, int M, int H,
                   int B, float scale_log2) {
  using G = Geometry<D>;
  constexpr int BLOCK_K = G::BLOCK_K, BLOCK_Q = G::BLOCK_Q, CONSUMERS = G::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1024
  const uint32_t sq = base + G::OFF_Q, sk = base + G::OFF_K, sv = base + G::OFF_V;
  const uint32_t so = base + G::OFF_O;
  const uint32_t bar_full = base + G::OFF_BAR;       // + 8 * K/V stage
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
      // one arrival per consumer warp, or per warpgroup once its store of
      // O out of the buffer has read it
      mbar_init(bar_qempty + 8 * s, G::O_IN_Q ? CONSUMERS : CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the Q buffers and the K/V ring full,
    // running ahead into the CTA's next Q tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PRODUCER_REGS) : "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      static_for<0, G::NB>([&](auto ic) {
        constexpr int c = decltype(ic)::value;
        prefetch_map(&maps.q[c]);
        prefetch_map(&maps.k[c]);
        prefetch_map(&maps.v[c]);
      });
      int kv = 0;
      for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        const int q0 = (w % q_tiles) * BLOCK_Q, h = (w / q_tiles) % H, b = w / (q_tiles * H);
        const int qb = j & 1;
        mbar_wait(bar_qempty + 8 * qb, ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(bar_qfull + 8 * qb, G::Q_BYTES);
        static_for<0, G::NB>([&](auto ic) {
          constexpr int c = decltype(ic)::value;
          tma_load(sq + qb * G::Q_BYTES + BLOCK_Q * G::col0(c) * 2, &maps.q[c],
                   bar_qfull + 8 * qb, G::col0(c), h, q0, b);
        });
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(bar_empty + 8 * s, ((kv / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * G::KV_BYTES);
          static_for<0, G::NB>([&](auto ic) {
            constexpr int c = decltype(ic)::value;
            const uint32_t off = s * G::KV_BYTES + BLOCK_K * G::col0(c) * 2;
            tma_load(sk + off, &maps.k[c], bar_full + 8 * s, G::col0(c), h, it * BLOCK_K, b);
            tma_load(sv + off, &maps.v[c], bar_full + 8 * s, G::col0(c), h, it * BLOCK_K, b);
          });
        }
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS) : "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32;
    Consumer<D> c;
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
    // warpgroup 0 takes the first turn
    if (G::OVERLAP && wg == CONSUMERS - 1)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(BAR_SCHED) : "memory");
    for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
      const int q0 = (w % q_tiles) * BLOCK_Q, h = (w / q_tiles) % H, b = w / (q_tiles * H);
      const int qb = j & 1;
#pragma unroll
      for (int i = 0; i < G::O_REGS; ++i) c.o[i] = 0.f;
      c.m_run[0] = c.m_run[1] = NEG_INF;
      c.l_run[0] = c.l_run[1] = 0.f;
      c.set_q(sq + qb * G::Q_BYTES);
      mbar_wait(bar_qfull + 8 * qb, (j >> 1) & 1);
      if constexpr (!G::OVERLAP) {
        c.run_sequential(n_full, n_tiles, M);
        if constexpr (!G::O_IN_Q) {
          __syncwarp();
          if (c.lane == 0) mbar_arrive(bar_qempty + 8 * qb);
        }
      } else {
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
          c.template softmax<true>(M, corr);
        else
          c.template softmax<false>(BLOCK_K, corr);
        c.pack();
        for (int it = 1; it < n_full; ++it) c.template step<false>(it, BLOCK_K);
        if (n_full >= 1 && n_full < n_tiles) c.template step<true>(n_full, M - n_full * BLOCK_K);
        // the last K/V tile's P V; Q is free once it is issued, unless O is
        // to be staged in it
        fence_regs(c.pa);
        fence_regs(c.o);
        c.sched_wait();
        wgmma_fence();
        c.issue_pv(n_tiles - 1);
        wgmma_commit();
        // the last warpgroup's very last turn: nobody waits
        const bool last_work = w + (int)gridDim.x >= n_work;
        if (wg != CONSUMERS - 1 || !last_work) c.sched_pass();
        if constexpr (!G::O_IN_Q) {
          __syncwarp();
          if (c.lane == 0) mbar_arrive(bar_qempty + 8 * qb);
        }
        wgmma_wait<0>();
        fence_regs(c.o);
        c.release(n_tiles - 1);
      }
      c.kv0 += n_tiles;

      // epilogue: O / l in bf16, staged in shared memory in the TMA's
      // swizzle, then stored by TMA while the next tile runs.  The staging
      // tile is the Q buffer at D = 160 (this warpgroup's rows of it, which
      // its last Q K^T has read), else a tile of its own that the previous
      // store must have read first.
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = c.l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-20f);
      }
      const uint32_t so_tile = G::O_IN_Q ? c.sq : so;
      if constexpr (!G::O_IN_Q) {
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_STORE + wg) : "memory");
      }
      static_for<0, G::NB>([&](auto ic) {
        constexpr int cb = decltype(ic)::value;
        constexpr int rb = G::width(cb) * 2;
        const uint32_t so_wg = so_tile + BLOCK_Q * G::col0(cb) * 2 + wg * WG_ROWS * rb;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;
#pragma unroll
          for (int jj = 0; jj < G::pv_cols(cb) / 8; ++jj) {
            const int i = G::o_off(cb) + 4 * jj + 2 * r;
            const uint32_t addr = so_wg + row * rb + (swizzle_chunk<rb>(row, jj) << 4) + (c.t << 2);
            const uint32_t val = pack_bf16(c.o[i] * inv[r], c.o[i + 1] * inv[r]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
          }
        }
      });
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(BAR_STORE + wg) : "memory");
      if (tid == 0) {
        if (q0 + wg * WG_ROWS < N) {
          static_for<0, G::NB>([&](auto ic) {
            constexpr int cb = decltype(ic)::value;
            tma_store(&maps.o[cb], so_tile + BLOCK_Q * G::col0(cb) * 2 + wg * WG_ROWS * G::width(cb) * 2,
                      G::col0(cb), h, q0 + wg * WG_ROWS, b);
          });
        }
        if constexpr (G::O_IN_Q) {
          // the Q buffer is free once the store has read it
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(bar_qempty + 8 * qb);
        }
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

// [B, rows, H, D] bf16 as a 4-D map (D, H, rows, B), box (width, 1,
// box_rows, 1) in the swizzle of `width` columns (64: 128 bytes, 32: 64,
// 16: 32).  A box wider than D reads zeros past it and stores nothing there.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int batch, int rows,
              int heads, int head_dim, int width, int box_rows) {
  const cuuint64_t row_bytes = (cuuint64_t)head_dim * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int m,
           int heads, float scale, cudaStream_t stream) {
  using G = Geometry<D>;
  const long long work = (long long)((n + G::BLOCK_Q - 1) / G::BLOCK_Q) * heads * batch;
  if (work > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  Maps<G::NB> maps;
  for (int c = 0; c < G::NB; ++c) {
    const int w = G::width(c);
    if (!make_map(encode, &maps.q[c], q, batch, n, heads, D, w, G::BLOCK_Q) ||
        !make_map(encode, &maps.k[c], k, batch, m, heads, D, w, G::BLOCK_K) ||
        !make_map(encode, &maps.v[c], v, batch, m, heads, D, w, G::BLOCK_K) ||
        !make_map(encode, &maps.o[c], o, batch, n, heads, D, w, WG_ROWS))
      return (int)cudaErrorInvalidValue;
  }
  // once per process and head dim: the shared-memory opt-in (each
  // instantiation needs its own) and the SM count
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 G::SMEM_BYTES);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  // persistent: one CTA per SM at most, each walking its share of Q tiles
  const unsigned grid = (unsigned)(work < sms ? work : sms);
  flash_fwd_sm90<D><<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(maps, n, m, heads, batch,
                                                                 scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, N, H, D], k/v [B, M, H, D], o [B, N, H, D] with D in {40, 64,
// 80, 160}, contiguous and 16-byte aligned.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape the kernel does not take,
// cudaErrorMisalignedAddress for a base that is not 16-byte aligned).
extern "C" int dtpu_flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                             int batch, int n, int m, int heads, int head_dim,
                                             float scale, void* stream) {
  // the mask folds the scale into the running max, so it must be positive
  if (batch <= 0 || n <= 0 || m <= 0 || heads <= 0 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 40:
      return launch<40>(q, k, v, o, batch, n, m, heads, scale, s);
    case 64:
      return launch<64>(q, k, v, o, batch, n, m, heads, scale, s);
    case 80:
      return launch<80>(q, k, v, o, batch, n, m, heads, scale, s);
    case 160:
      return launch<160>(q, k, v, o, batch, n, m, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
