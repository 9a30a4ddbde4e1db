// A transformer layer's MLP branch, y = fc2(GELU(fc1(h))), as one kernel
// on Hopper (sm_90a), with the hidden activations kept on chip.  SwinIR
// (arXiv 2108.10257, models/swinir.py) runs it once per Swin layer: 54
// times a SwinIR-L forward, on every token of the map.
//
// No TPU kernel of the JAX package computes this: the JAX package has no
// SwinIR.  The kernel takes the place of PyTorch's three calls on the
// port's SwinIR path (F.linear, F.gelu, F.linear), which write the hidden
// (rE channels a token, 2E bf16 for SwinIR-L) to device memory and read it
// back twice: 4,800 bytes a token of which 3,840 carry the hidden between
// kernels.
//
// Math, per token (row) of E channels; h, the weights and biases bf16:
//   u = h . W1^T + b1             float32 sums over E
//   g = bf16(0.5 u (1 + erff(u / sqrt 2)))      the exact erf form
//   y = bf16(g . W2^T + b2)       float32 sums over the hidden
// The hidden is rounded once, as the second product's operand (PyTorch's
// three calls round it after fc1 and again after GELU).
//
// Bound.  4 E rE FLOP a token (460,800 at E = 240, r = 2) against 4 E
// bytes of h and y: 480 FLOP/B, above the card's ridge of 295, so bound by
// operations: 0.466 ns a token at 989 TFLOP/s, 0.489 ms for a 1024^2 map.
// What the design does about it:
//
// - One tile of 128 tokens at a time per persistent block (one block per
//   SM).  The tile's h lands in four swizzled K blocks of 64 channels,
//   zero past E and past the last token: by TMA where a row of E bf16 is
//   a whole number of 16 bytes (E a multiple of 8, SwinIR-L's 240), else
//   (SwinIR-M's 180, the lightweight 60: rows of 360 and 120 bytes, no
//   tensor map) by three producer warps in 8-byte cp.async copies.  One
//   producer thread streams W1 and W2 in hidden chunks of 64 through a
//   ring of two stages: W1's 64 rows as up to four K blocks, W2 as E rows
//   of the chunk's 64 columns.  W1 comes padded with zero columns to E8,
//   E rounded up to 8, and the hidden width to a multiple of 8
//   (ops/swin_mlp.kernel_weights, once when the model is prepared), so
//   both weights have tensor maps.  W1 and W2 have barriers of their own,
//   so a stage's W1 is reloaded as soon as fc1 has read it.
// - Two consumer warpgroups, 64 tokens each.  Per chunk: fc1 by wgmma
//   m64n64k16 with both operands in shared memory, K = E in steps of 16
//   (15 at E = 240: the fourth K block holds 48 channels and 16 zeros
//   that are never read); b1 and GELU on the float32 accumulators, packed
//   to bf16 A fragments in registers (the accumulator of two n8 blocks is
//   the A fragment of one k16 step: FlashAttention-3's P.V, with GELU in
//   softmax's place); fc2 by wgmma with A from those registers into a
//   64 x E8 float32 accumulator that lives across every chunk.  fc2's N
//   is E8 as a sum of distinct widths 128, 64, 32, 16, 8, the bits of
//   E8 / 8 (240 = 128 + 64 + 32 + 16, 184 = 128 + 32 + 16 + 8, 64 one
//   part), so one code path takes every E that is a multiple of 4 up to
//   240, SwinIR-L's and the widest SwinIR release; E = 240 is compiled
//   with its widths as constants.
// - Each warpgroup issues fc2 of chunk c and fc1 of chunk c + 1 as one
//   turn, then runs GELU of chunk c + 1; the two warpgroups take turns
//   (named barriers), so one's GELU runs while the other's products do.
// - Epilogue: b2 added, rounded once, staged per warp in shared memory and
//   stored as whole 16-byte pieces of each row (8-byte pieces of the first
//   E columns where E is no multiple of 8).  The h tile's buffer is
//   handed back as soon as its last fc1 has read it, so the next tile's
//   load overlaps the last fc2 and the stores.
// - No programmatic dependent launch: the profiler's kernel durations
//   then never overlap, which the roofline reader sums.
//
// What holds it back (an H100 at 700 W, 1024^2 tokens, PERF.md): power.
// The card runs this kernel at its 700 W limit, at a lower clock than
// its peak, so the work a token sets the time, not the order of it: with
// GELU left out the kernel took 0.80-0.92 ms, with it 1.21-1.35, and no
// order tried hid it.  CUDA's erff is about 20 instructions a value, and
// fc1 reads both of its operands from shared memory.  Tried and dropped:
// turns of fc1 and fc2 apart (1.45 ms), FlashAttention-3's order with two
// fragment sets (1.25-1.42), each k16 step's fc2 issued as soon as its
// GELU is packed (1.26-1.43), fc2 as one m64n240k16 (no change), clusters
// of two blocks sharing each weight chunk by TMA multicast (0.3 ms slower;
// the weights' L2 traffic was not the limit), stores of 4 bytes a lane
// straight from registers (0.52 ms with neither product nor GELU run).

#include "conv3x3_wgmma.cuh"   // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {
namespace smlp {

using wgc::fence_operand;
using wgc::mbar_arrive;
using wgc::mbar_expect_tx;
using wgc::mbar_init;
using wgc::mbar_wait;
using wgc::smem_desc;
using wgc::smem_u32;
using wgc::wgmma_commit;
using wgc::wgmma_fence;
using wgc::wgmma_rs;
using wgc::wgmma_wait;

constexpr int kRows = 128;                  // tokens a tile
constexpr int kChunk = 64;                  // hidden channels a chunk
constexpr int kKBlock = 64;                 // channels of a K block (128 B)
constexpr int kMaxE = 240;                  // fc2's widest N
constexpr int kMaxKBlocks = (kMaxE + kKBlock - 1) / kKBlock;
constexpr int kAccRegs = 124;               // fc2's parts' accumulators
constexpr int kMaxHidden = 2048;
constexpr int kStages = 2;                  // the weight ring
constexpr int kThreads = 384;               // two consumer warpgroups + one
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;
constexpr uint32_t kAlign = 1024;
constexpr uint32_t kXBlockBytes = kRows * kKBlock * 2;       // 16 KB
constexpr uint32_t kXBytes = kMaxKBlocks * kXBlockBytes;     // 64 KB
constexpr uint32_t kW1BlockBytes = kChunk * kKBlock * 2;     // 8 KB
constexpr uint32_t kW1Bytes = kMaxKBlocks * kW1BlockBytes;   // 32 KB
constexpr uint32_t kW2Bytes = kMaxE * kChunk * 2;            // 30 KB
constexpr uint32_t kStageBytes = kW1Bytes + kW2Bytes;
constexpr int kStagePitch = 72;             // a staged row: 64 bf16 + 16 B
constexpr uint32_t kWarpStageBytes = 16 * kStagePitch * 2;
// [h tile][stage 0][stage 1][per warp: 16 staged rows][b2, float]
// [barriers][b1, float, by chunks]
constexpr uint32_t kStagingAt = kXBytes + kStages * kStageBytes;
constexpr uint32_t kB2At = kStagingAt + 8 * kWarpStageBytes;
constexpr uint32_t kBarsAt = kB2At + kMaxE * 4;
constexpr uint32_t kB1At = kBarsAt + 128;
constexpr uint32_t kBarWG0 = 1, kBarWG1 = 2;   // named barriers: the turns
static_assert(kAlign + kB1At + 4 * kMaxHidden <= kMaxSmem, "shared memory");

struct Params {
  long long m;                  // tokens
  int e, hidden;                // hidden: W1's rows, a multiple of 8
  int ew;                       // E8: W1's row, fc2's N
  int n_chunks, n_kblocks, n_ksteps;
  int tiles;
  int w2_box_rows;              // W2 rows a box: two boxes cover E
  const __nv_bfloat16* b1;
  const __nv_bfloat16* b2;
  __nv_bfloat16* y;
};

// fc2's N as parts of widths 128 >> i; part i's accumulators start at
// register part_reg(i) of the kAccRegs
__host__ __device__ constexpr int part_n(int i) { return 128 >> i; }
__host__ __device__ constexpr int part_reg(int i) {
  return i == 0 ? 0 : i == 1 ? 64 : i == 2 ? 96 : i == 3 ? 112 : 120;
}
// the first output column of part i at width e (a multiple of 8), or -1
// where e takes no part i (each part that still fits)
__host__ __device__ constexpr int part_col(int e, int i) {
  int rem = e, col = 0;
  for (int j = 0; j < i; ++j)
    if (rem >= part_n(j)) {
      rem -= part_n(j);
      col += part_n(j);
    }
  return rem >= part_n(i) ? col : -1;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the tile's h by 8-byte copies of `threads` threads (t this one's
// index), for rows of E bf16 that are no whole number of 16 bytes: each
// 4 channels of a row up to fc1's last k16 step into the swizzled K
// blocks, zeros past E and past the last token (a copy of 0 source bytes)
__device__ __forceinline__ void load_x_narrow(const Params& p,
                                              const __nv_bfloat16* h,
                                              uint32_t x, long long row0,
                                              int t, int threads) {
  const int per_row = 4 * p.n_ksteps;
  for (int i = t; i < kRows * per_row; i += threads) {
    const int r = i / per_row, ch = 4 * (i % per_row);
    const bool live = row0 + r < p.m && ch < p.e;
    const __nv_bfloat16* src = live ? h + (row0 + r) * p.e + ch : h;
    const uint32_t dst = x + (ch >> 6) * kXBlockBytes +
                         wgc::swizzle<64>(r * 128 + (ch & 63) * 2);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(live ? 8 : 0)
                 : "memory");
  }
  // the copies done, and seen by wgmma's proxy, before the tile is full
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(uint32_t id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// m64n64k16, both operands from shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[j][q])::"memory");
}

// fc1 of one chunk: this warpgroup's 64 rows of the h tile (descriptor
// dx) against the chunk's W1 blocks (dw1), K = E in steps of 16.  A step's
// descriptors are the bases plus a constant (the 14-bit address field
// counts 16 bytes), so no descriptor is kept per step.
template <int kE>
__device__ __forceinline__ void fc1_issue(float (&acc)[32], uint64_t dx,
                                          uint64_t dw1, int n_ksteps) {
  const int nks = kE ? (kE + 15) / 16 : n_ksteps;
#pragma unroll
  for (int ks = 0; ks < 4 * kMaxKBlocks; ++ks)
    if (ks < nks)
      wgmma_ss64(acc, dx + ((ks >> 2) * kXBlockBytes + (ks & 3) * 32) / 16,
                 dw1 + ((ks >> 2) * kW1BlockBytes + (ks & 3) * 32) / 16,
                 ks > 0);
}

// fc2 of one chunk: the GELU fragments (a, k16 steps of the chunk's 64
// hidden channels) against the chunk's W2 columns (dw2: E rows of 128 B)
template <int kE>
__device__ __forceinline__ void fc2_issue(float (&acc)[kAccRegs],
                                          const uint32_t (&a)[4][4],
                                          uint64_t dw2, int e) {
  const int ee = kE ? kE : e;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#define SMLP_PART(I)                                                      \
  {                                                                       \
    const int col = part_col(ee, I);                                      \
    if (col >= 0)                                                         \
      wgmma_rs<part_n(I)>(acc + part_reg(I), a[j],                        \
                          dw2 + (uint32_t)(col * 128 + j * 32) / 16);     \
  }
    SMLP_PART(0) SMLP_PART(1) SMLP_PART(2) SMLP_PART(3) SMLP_PART(4)
#undef SMLP_PART
  }
}

// v (0.5 + 0.5 erff(v / sqrt 2)): bit for bit PyTorch's v 0.5 (1 + erf),
// since scaling by 0.5 is exact
__device__ __forceinline__ float gelu(float v) {
  return v * fmaf(0.5f, erff(v * 0.70710678118654752440f), 0.5f);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// b1 and GELU on fc1's accumulators, as the A fragments of fc2's four k16
// steps: fragment register q of step j is columns 16 j + 8 (q >> 1) + 2 t
// (+1) of row g (q even) or g + 8 (q odd), accumulators 8 j + 2 q (+1)
__device__ __forceinline__ void gelu_frags(const float (&acc)[32],
                                           uint32_t (&a)[4][4],
                                           const float* b1, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 8 * j + 2 * q, col = 8 * (2 * j + (q >> 1)) + 2 * t;
      a[j][q] = pack_bf16(gelu(__fadd_rn(acc[i], b1[col])),
                          gelu(__fadd_rn(acc[i + 1], b1[col + 1])));
    }
}

// P output columns from c0 of this warp's 16 rows (row0 on), accumulators
// R0.. of fc2's: b2 added, rounded, staged in the warp's shared rows, then
// stored as whole 16-byte pieces of each row, or 8-byte pieces of its
// first e columns where rows of e bf16 are no whole 16 bytes (rows below m)
template <int P, int R0>
__device__ __forceinline__ void store_piece(const Params& p,
                                            const float (&acc)[kAccRegs],
                                            const float* b2,
                                            __nv_bfloat16* st, int c0,
                                            long long row0, int e, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < P / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * t, row = g + 8 * ((i >> 1) & 1);
    *reinterpret_cast<uint32_t*>(st + row * kStagePitch + col) =
        pack_bf16(__fadd_rn(acc[R0 + i], b2[c0 + col]),
                  __fadd_rn(acc[R0 + i + 1], b2[c0 + col + 1]));
  }
  __syncwarp();
  if (e % 8 == 0) {
    constexpr int kPer = P / 8;               // 16-byte pieces a row
#pragma unroll
    for (int it = lane; it < 16 * kPer; it += 32) {
      const int row = it / kPer, q = (it % kPer) * 8;
      if (row0 + row < p.m)
        *reinterpret_cast<uint4*>(p.y + (row0 + row) * e + c0 + q) =
            *reinterpret_cast<const uint4*>(st + row * kStagePitch + q);
    }
  } else {
    constexpr int kPer = P / 4;               // 8-byte pieces a row
#pragma unroll
    for (int it = lane; it < 16 * kPer; it += 32) {
      const int row = it / kPer, q = (it % kPer) * 4;
      if (row0 + row < p.m && c0 + q < e)
        *reinterpret_cast<uint2*>(p.y + (row0 + row) * e + c0 + q) =
            *reinterpret_cast<const uint2*>(st + row * kStagePitch + q);
    }
  }
  __syncwarp();
}

template <int kE>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const float (&acc)[kAccRegs],
                                         const float* b2, __nv_bfloat16* st,
                                         long long row0, int lane) {
  // parts of E8 (kE is a multiple of 8), columns stored up to E
  const int ee = kE ? kE : p.ew, e = kE ? kE : p.e;
  int col = part_col(ee, 0);
  if (col >= 0) {
    store_piece<64, 0>(p, acc, b2, st, col, row0, e, lane);
    store_piece<64, 32>(p, acc, b2, st, col + 64, row0, e, lane);
  }
  if ((col = part_col(ee, 1)) >= 0)
    store_piece<64, 64>(p, acc, b2, st, col, row0, e, lane);
  if ((col = part_col(ee, 2)) >= 0)
    store_piece<32, 96>(p, acc, b2, st, col, row0, e, lane);
  if ((col = part_col(ee, 3)) >= 0)
    store_piece<16, 112>(p, acc, b2, st, col, row0, e, lane);
  if ((col = part_col(ee, 4)) >= 0)
    store_piece<8, 120>(p, acc, b2, st, col, row0, e, lane);
}

// kE: E as a constant (240), or 0 for E read from p
template <int kE>
__global__ void __launch_bounds__(kThreads, 1)
    swin_mlp_kernel(const __nv_bfloat16* __restrict__ h,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_w2,
                    const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  unsigned char* const gen = smem_raw + (base - raw);
  float* const b2s = reinterpret_cast<float*>(gen + kB2At);
  float* const b1s = reinterpret_cast<float*>(gen + kB1At);
  // barriers: the h tile's full and empty; per stage W1's full and
  // empty, W2's full and empty (W1 is handed back after fc1, W2 after fc2)
  const uint32_t x_full = base + kBarsAt, x_empty = x_full + 8;
  const uint32_t w1_full = x_full + 16, w1_empty = w1_full + 8 * kStages;
  const uint32_t w2_full = w1_empty + 8 * kStages;
  const uint32_t w2_empty = w2_full + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // h by cp.async copies of warps 9-11, not by TMA
  const bool narrow = (kE ? kE : p.e) % 8 != 0;
  if (threadIdx.x == 0) {
    mbar_init(x_full, narrow ? 96 : 1);
    mbar_init(x_empty, 8);                     // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w1_full + 8 * s, 1);
      mbar_init(w2_full + 8 * s, 1);
      mbar_init(w1_empty + 8 * s, 8);
      mbar_init(w2_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < p.n_chunks * kChunk; i += kThreads)
    b1s[i] = i < p.hidden ? __bfloat162float(p.b1[i]) : 0.f;
  for (int i = threadIdx.x; i < kMaxE; i += kThreads)
    b2s[i] = i < p.e ? __bfloat162float(p.b2[i]) : 0.f;
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every TMA load; where h is
    // copied, warps 9-11 copy it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kProducerRegs));
    if (narrow && warp > 8) {
      uint32_t xph = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        mbar_wait(x_empty, xph ^ 1);
        xph ^= 1;
        load_x_narrow(p, h, base, (long long)tile * kRows,
                      threadIdx.x - 288, 96);
        mbar_arrive(x_full);
      }
      return;
    }
    if (threadIdx.x != 256) return;
    const uint32_t w1_tx = p.n_kblocks * kW1BlockBytes;
    const uint32_t w2_tx = 2u * p.w2_box_rows * 128u;
    int q = 0;
    uint32_t xph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      if (!narrow) {
        mbar_wait(x_empty, xph ^ 1);
        xph ^= 1;
        mbar_expect_tx(x_full, p.n_kblocks * kXBlockBytes);
        for (int kb = 0; kb < p.n_kblocks; ++kb)
          tma_load_2d(base + kb * kXBlockBytes, &tm_x, x_full,
                      kb * kKBlock, tile * kRows);
      }
      for (int c = 0; c < p.n_chunks; ++c, ++q) {
        const int s = q % kStages;
        const uint32_t parity = ((q / kStages) & 1) ^ 1;
        const uint32_t st = base + kXBytes + s * kStageBytes;
        mbar_wait(w1_empty + 8 * s, parity);
        mbar_expect_tx(w1_full + 8 * s, w1_tx);
        for (int kb = 0; kb < p.n_kblocks; ++kb)
          tma_load_2d(st + kb * kW1BlockBytes, &tm_w1, w1_full + 8 * s,
                      kb * kKBlock, c * kChunk);
        mbar_wait(w2_empty + 8 * s, parity);
        mbar_expect_tx(w2_full + 8 * s, w2_tx);
        for (int half = 0; half < 2; ++half)
          tma_load_2d(st + kW1Bytes + half * p.w2_box_rows * 128, &tm_w2,
                      w2_full + 8 * s, c * kChunk, half * p.w2_box_rows);
      }
    }
    return;
  }

  // consumer warpgroups: g's 64 rows of each tile, warp w rows 16 w..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = warp >> 2, w = warp & 3, t = lane & 3;
  const uint64_t dx = smem_desc<64>(base + g * 64 * kKBlock * 2);
  const uint32_t me = g == 0 ? kBarWG0 : kBarWG1;
  const uint32_t other = g == 0 ? kBarWG1 : kBarWG0;
  __nv_bfloat16* const st = reinterpret_cast<__nv_bfloat16*>(
      gen + kStagingAt + warp * kWarpStageBytes);
  float acc2[kAccRegs], acc1[32];
  uint32_t a[4][4];
  int q = 0;
  uint32_t xph = 0;
  // hand chunk k's W1 or W2 stage back to the producer
  auto release = [&](uint32_t empty, int k) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (k % kStages));
  };
  auto release_x = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty);
  };
  // the descriptors of chunk k's W1 blocks and W2 rows
  auto dw1 = [&](int k) {
    return smem_desc<64>(base + kXBytes + (k % kStages) * kStageBytes);
  };
  auto dw2 = [&](int k) {
    return smem_desc<64>(base + kXBytes + (k % kStages) * kStageBytes +
                         kW1Bytes);
  };
  if (g == 1) named_arrive(kBarWG0);           // warpgroup 0 goes first
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) acc2[i] = 0.f;
    mbar_wait(x_full, xph);
    xph ^= 1;
    // the tile's first turn: fc1 of its first chunk
    mbar_wait(w1_full + 8 * (q % kStages), (q / kStages) & 1);
    named_sync(me);
    fence_all(acc1);
    wgmma_fence();
    fc1_issue<kE>(acc1, dx, dw1(q), p.n_ksteps);
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_all(acc1);
    release(w1_empty, q);
    if (p.n_chunks == 1) release_x();
    gelu_frags(acc1, a, b1s, t);
    // then a turn a chunk: fc2 of chunk c and fc1 of chunk c + 1 in flight
    // together, GELU of chunk c + 1 after both; the last chunk's fc2 a turn
    // of its own
    for (int c = 0; c + 1 < p.n_chunks; ++c, ++q) {
      mbar_wait(w2_full + 8 * (q % kStages), (q / kStages) & 1);
      mbar_wait(w1_full + 8 * ((q + 1) % kStages), ((q + 1) / kStages) & 1);
      named_sync(me);
      fence_all(acc2);
      fence_all(acc1);
      fence_frags(a);
      wgmma_fence();
      fc2_issue<kE>(acc2, a, dw2(q), p.ew);
      wgmma_commit();
      fc1_issue<kE>(acc1, dx, dw1(q + 1), p.n_ksteps);
      wgmma_commit();
      named_arrive(other);
      wgmma_wait<1>();
      fence_frags(a);
      release(w2_empty, q);
      wgmma_wait<0>();
      fence_all(acc1);
      release(w1_empty, q + 1);
      if (c + 2 == p.n_chunks) release_x();
      gelu_frags(acc1, a, b1s + (c + 1) * kChunk, t);
    }
    mbar_wait(w2_full + 8 * (q % kStages), (q / kStages) & 1);
    named_sync(me);
    fence_all(acc2);
    fence_frags(a);
    wgmma_fence();
    fc2_issue<kE>(acc2, a, dw2(q), p.ew);
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_all(acc2);
    fence_frags(a);
    release(w2_empty, q);
    ++q;
    epilogue<kE>(p, acc2, b2s, st,
                 (long long)tile * kRows + g * 64 + w * 16, lane);
  }
  if (g == 0) named_sync(kBarWG0);     // warpgroup 1's last hand-over
}

// ---- host side ----

template <int kE>
int launch_kernel(const __nv_bfloat16* h, const CUtensorMap& tx,
                  const CUtensorMap& tw1, const CUtensorMap& tw2,
                  const Params& p, uint32_t smem, int n_sm, int dev,
                  cudaStream_t stream) {
  auto kernel = swin_mlp_kernel<kE>;
  static uint64_t set_on;                 // bit d: device d
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set_on & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    set_on |= bit;
  }
  // persistent blocks, one per SM, each walking every grid-th tile
  const int grid = std::max(1, std::min(p.tiles, n_sm));
  kernel<<<grid, kThreads, smem, stream>>>(h, tx, tw1, tw2, p);
  return (int)cudaGetLastError();
}

}  // namespace smlp
}  // namespace

// y = fc2(GELU(fc1(h))) over (m, e) bf16 tokens h: w1 (hidden, e8) with
// e8 = e rounded up to 8 (zero columns past e), b1 (hidden), w2 (e,
// hidden), b2 (e), all bf16 and contiguous, y (m, e).  e a multiple of 4
// in [4, 240], hidden a multiple of 8 in [8, 2048], every pointer aligned
// to 16 bytes.  Returns cudaGetLastError() after the
// launch (0 on success, nothing launched for m = 0); the Python wrapper
// checks the tensors.
extern "C" int swin_mlp_launch(const void* h, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y,
                               long long m, int e, int hidden, void* stream) {
  using namespace smlp;
  if (m < 0 || e < 4 || e > kMaxE || e % 4 || hidden < 8 ||
      hidden > kMaxHidden || hidden % 8 || (uintptr_t)h % 16 ||
      (uintptr_t)w1 % 16 || (uintptr_t)b1 % 16 || (uintptr_t)w2 % 16 ||
      (uintptr_t)b2 % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long long tiles = (m + kRows - 1) / kRows;
  if (tiles * kRows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const wgc::EncodeTiledFn encode = wgc::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  Params p{};
  p.m = m;
  p.e = e;
  p.hidden = hidden;
  p.ew = (e + 7) / 8 * 8;
  p.n_chunks = (hidden + kChunk - 1) / kChunk;
  p.n_kblocks = (e + kKBlock - 1) / kKBlock;
  p.n_ksteps = (e + 15) / 16;
  p.tiles = (int)tiles;
  p.w2_box_rows = (e + 15) / 16 * 8;
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.y = static_cast<__nv_bfloat16*>(y);

  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t xdim[2] = {(cuuint64_t)e, (cuuint64_t)m};
  const cuuint64_t xstride[1] = {(cuuint64_t)e * 2};
  const cuuint32_t xbox[2] = {kKBlock, kRows};
  const cuuint64_t w1dim[2] = {(cuuint64_t)p.ew, (cuuint64_t)hidden};
  const cuuint64_t w1stride[1] = {(cuuint64_t)p.ew * 2};
  const cuuint32_t w1box[2] = {kKBlock, kChunk};
  const cuuint64_t w2dim[2] = {(cuuint64_t)hidden, (cuuint64_t)e};
  const cuuint64_t w2stride[1] = {(cuuint64_t)hidden * 2};
  const cuuint32_t w2box[2] = {kChunk, (cuuint32_t)p.w2_box_rows};
  // h's map only where its rows are whole 16 bytes (else it is copied)
  CUtensorMap tx{}, tw1, tw2;
  if ((e % 8 == 0 &&
       encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(h),
              xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) ||
      encode(&tw1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w1),
             w1dim, w1stride, w1box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&tw2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w2),
             w2dim, w2stride, w2box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  // the SM count, looked up once per device
  static int sms_of[64];
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) n_sm = sms_of[dev];
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sms_of[dev] = n_sm;
  }
  const uint32_t smem = kAlign + kB1At + 4u * p.n_chunks * kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  return e == 240
             ? launch_kernel<240>(hb, tx, tw1, tw2, p, smem, n_sm, dev, st)
             : launch_kernel<0>(hb, tx, tw1, tw2, p, smem, n_sm, dev, st);
}

extern "C" const char* swin_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
