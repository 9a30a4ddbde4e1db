// The bf16 forward 3x3 SAME conv on Hopper (sm_90a): TMA loads into
// rings of shared-memory stages, wgmma on the tensor cores, an epilogue
// staged through shared memory.  The forward kernels run on it:
// csrc/conv3x3.cu (one conv, channels-last in and out),
// csrc/dense_block.cu (the convs of a dense block) and
// csrc/dense_block_chain.cu (conv n of each dense block of the RRDB
// trunk, chained through the blocks' buffers); so does the bf16
// backward's data gradient (csrc/dense_block_bwd.cu), a conv over the
// channel range of its dz buffer, with the epilogues of kBwd below.  The
// f32 paths keep the FMA tile of conv3x3_tile.cuh.
//
// The conv is an implicit GEMM: M = the pixels of an output unit (16x16,
// or 16 wide x 8 high at N = 128), N = output channels (8, 16, 32, 64 or
// 128 per block), K = 9 taps x cin.
//
// Bound.  The flagship dense block (8, 64, 128^2) bf16 is bound by
// operations (62.8 GFLOP, 0.0635 ms at 989 TFLOP/s, against 0.010 ms of
// bytes); the 8 x 512^2 tail conv 64 -> 64 by operations and bytes about
// equally (0.156 / 0.160 ms); conv_first (cin 3) by its output write.
// What the design does about each:
//
// - Products by wgmma m64nNk16 with A from registers.  For tap (dy, dx)
//   the A rows of one warp are the 16 pixels of one tile row, shifted by
//   dy rows and dx columns in the input patch (18 wide); the 64 rows of
//   a wgmma are four tile rows, not evenly strided in the patch, which a
//   shared-memory descriptor cannot express.  So each warp loads its 16
//   rows with one ldmatrix.x4 from the shifted patch addresses, the
//   swizzle XOR applied in the address, and B (the weights) is read by
//   wgmma through a descriptor.  Warp w's M block mb is output row
//   MB w + mb, so its MB blocks read MB + 2 patch rows, each of which
//   serves up to three (M block, dy) pairs: per (dx, k16 step) the warp
//   loads those rows once and issues the 3 x MB wgmmas as one batch
//   behind one fence (wgmma.fence waits for the wgmmas in flight), while
//   the next batch's rows load into a second register set.  That halves
//   the ldmatrix traffic against loading per tap, which shared memory's
//   bandwidth made the limit.  (A from shared memory through three
//   dx-shifted copies of the patch was tried: the copies triple the L2
//   reads and it ran slower.)
// - Two consumer warpgroups, each with a ring of its own, take the units
//   of a block in turn, so one's epilogue overlaps the other's products
//   (ping-pong); each computes a whole unit: four M blocks (two at
//   N = 128).  A producer warpgroup, one thread
//   of which issues every load, gives its registers to the consumers
//   (setmaxnreg 40 / 232), which a 16x16 unit at N = 64 needs (128
//   accumulators a thread).  The blocks are persistent (one per SM), each
//   walking the units of one channel group; the producer loads the units
//   in order, so the second warpgroup starts about half a unit later.
// - Input by TMA from a 4-D tensor map over the channels-last buffer with
//   dim 0 = cin (not the pixel stride) and a row stride of c_total * 2 B:
//   its zero fill outside the map gives SAME padding (the halo starts at
//   -1) and the cut at cin for free, so conv k of a dense block never
//   reads the slice it writes, and H, W need not be multiples of 16.
// - K in chunks of KC = 64, 32 or 16 channels (rows of 128, 64 or 32
//   bytes, swizzled over their width, which keeps the ldmatrix rows of 8
//   neighbouring pixels on 32 banks): the widest that divides cin and
//   fits, so no chunk is zero-filled (cin 96 and 160 of the growth convs
//   take 32), and conv_first (cin 3, padded to 8 by the wrapper because a
//   tensor map needs 16-byte strides) runs K = 9 x 16, wgmma's least k
//   per tap, not 9 x 32.
// - Weights from the (9, cout, cin) packed layout by a 3-D tensor map
//   (nothing is repacked; channels past cout read as zero).  Where all
//   of a conv's weights fit beside two rings of two stages they are
//   loaded once per block, one barrier per K chunk so the first products
//   need only the first chunk (tail 64 -> 64: 73.7 KB; convs 1-4 of the
//   dense block: 36.9-92.2 KB; each 128-channel group of the 64 -> 256
//   upconv: 147 KB, with 16-channel chunks); otherwise (conv5: 221 KB)
//   each stage carries its chunk of weights beside the patch.
// - N is the whole cout up to 64, so every output channel of a unit comes
//   from one pass over its input; the upconv's 256 channels are two
//   groups of 128, since 256 channels' weights (295 KB) fit in no block
//   and their accumulators in no warpgroup.
// - Rings of 2-4 stages (full and empty mbarriers per stage): the
//   producer runs ahead into the next units while the consumers finish
//   this one.
// - Programmatic dependent launch: each launch lets the next one's blocks
//   start as its own finish, and those load their weights and bias and
//   set up their barriers before griddepcontrol.wait, so the five convs
//   of a dense block do not each pay the launch and the weight load.
// - Epilogue: bias (in shared memory for the whole launch), LeakyReLU
//   and the one rounding in f32 on the accumulators, the rows staged per
//   warp in shared memory (16 pixels x N channels, rows padded by 16
//   bytes), then written with coalesced 16-byte stores: a channel slice
//   of a channels-last buffer (pixel stride c_out), or for conv5 y in
//   NCHW (16-byte runs of 8 pixels of one channel, x read the same way
//   for the f32 residual) or NHWC.  Shapes that break 16-byte alignment
//   (cout 3) store element by element.
// - The trunk's chained epilogue (kChain) is compiled only into the
//   source that launches it (WGC_EPILOGUE below); the mode stays a field
//   read at run time, so every source has the same kernels under the same
//   names.  Epilogue code that never runs is not free: compiled beside
//   the others, a chained mode slowed the single conv's 64-wide
//   instantiations by 8-11 % and the dense block by 2-5 % on an H100
//   (PERF.md).
//
// What holds it back (PERF.md has the numbers): shared-memory bandwidth
// (per wgmma the A rows and N x 32 bytes of B), which a 32-wide growth
// conv feels most, and per launch the fill and drain of a persistent
// grid that has only four units per SM at the flagship shape.
//
// cuTensorMapEncodeTiled lives in libcuda, not the runtime: it is looked
// up once with cudaGetDriverEntryPoint, so the build needs no -lcuda,
// and the two tensor maps are encoded on the host at every launch (a
// few microseconds, hidden behind the device while the forward is
// device-bound), not cached: a cache keyed by pointer and shape would
// have to know when PyTorch frees and reuses a buffer.  The shared-memory
// attribute and the SM count are set and read once per device.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {
namespace wgc {

constexpr int kTile = 16;                      // output tile width
constexpr int kPatchW = kTile + 2;             // with the one-pixel halo
constexpr int kConsumerWarps = 8;              // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
constexpr int kProducerRegs = 40;    // setmaxnreg: what the producer keeps
constexpr int kConsumerRegs = 232;   // and what each consumer thread gets
constexpr int kMaxSmem = 232448;               // a block's dynamic maximum
constexpr uint32_t kAlign = 1024;              // swizzle pattern period
constexpr int kMaxStages = 4;                  // per ring
constexpr int kMaxChunks = 16;                 // K chunks of resident weights
constexpr int kMaxChunkK = 64;                 // channels per K chunk

// M blocks of 64 pixels (one tile row from each warp) a warpgroup
// computes per unit: a 16x16 tile, or 16x8 where N = 128 leaves no
// registers for more
__host__ __device__ constexpr int m_blocks(int n) { return n <= 64 ? 4 : 2; }

// N for cout output channels: the whole cout up to 64, else groups of
// max_n (64 or 128)
constexpr int pick_n(int cout, int max_n) {
  return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 32 ? 32
       : cout <= 64 || max_n <= 64 ? 64 : 128;
}

// epilogue modes
constexpr int kStore = 0;            // bias, optional LeakyReLU, store
constexpr int kResidualNCHW = 1;     // y = x + res_scale * conv, NCHW
constexpr int kResidualNHWC = 2;     // the same, NHWC
// the backward's data gradient (kBwd kernels; no bias, acc staged in f32)
constexpr int kBwdAct = 3;   // dout = acc * leak(act): dz (bf16), db slots
constexpr int kBwdDx = 4;    // dx = round(g + acc), NCHW
// conv n of a dense block on the RRDB trunk's chain: y = x + res_scale *
// conv with x read from the block's own feature buffer and y written
// into the next block's, both channels-last at pixel stride c_out.  Where
// the block ends an RRDB, act (LeakyReLU's flag in kStore) says where x_o
// lies, and out = x_o + round(res_scale * y), the RRDB's residual:
constexpr int kChain = 5;
constexpr int kOuterAtOut = 1;       // act: x_o is what out holds
constexpr int kOuterIsX = 2;         // act: x_o is x (an RRDB of one block)

// The modes a source compiles (it may define WGC_EPILOGUE before
// including this header); the backward's kernels have their own epilogue.
#define WGC_EPILOGUE_BLOCK 0   // kStore and the residuals (the default)
#define WGC_EPILOGUE_CHAIN 1   // kStore and kChain: dense_block_chain.cu
#ifndef WGC_EPILOGUE
#define WGC_EPILOGUE WGC_EPILOGUE_BLOCK
#endif
__host__ __device__ constexpr bool compiled(int mode) {
  return mode == kStore || mode == kBwdAct || mode == kBwdDx ||
         (WGC_EPILOGUE == WGC_EPILOGUE_BLOCK &&
          (mode == kResidualNCHW || mode == kResidualNHWC)) ||
         (WGC_EPILOGUE == WGC_EPILOGUE_CHAIN && mode == kChain);
}

// Everything a launch needs on the device besides the two tensor maps.
struct Params {
  int cin, cout, h, w;
  int n_groups;                  // channel groups of N (grid: groups x slots)
  int tiles_x, tiles_y, tiles;   // output units per channel group
  int nk;                        // K chunks
  int stages;                    // per ring
  int resident;                  // weights loaded once per block
  uint32_t patch_bytes, wchunk_bytes;   // smem regions (1024-aligned)
  const float* bias;
  void* out;                     // output channel 0 (or n0 = 0) of pixel 0
  int c_out;                     // output pixel stride (channels)
  int act;
  float slope;
  int mode;
  const void* res;               // x for the residual, laid out like y
  float res_scale;
  int vec_out;                   // 16-byte stores are aligned
};

// The backward's kernels take these fields besides (kBwdAct: the saved
// activation at channel 0 of the slice of pixel 0, pixel stride
// act_stride; dz out likewise; db partial sums [group][unit][warp][N]).
// A separate type, so the forward kernels' parameters stay as they were:
// a larger Params slowed the single conv's 64- and 128-wide
// instantiations on an H100.
struct BwdParams : Params {
  const void* act_in;
  int act_stride;
  void* dz;
  int dz_stride;
  float* db_part;
};
template <bool kBwd>
using ParamsOf = typename std::conditional<kBwd, BwdParams, Params>::type;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand whose rows are
// KC bf16 (KC * 2 bytes, swizzled over that width): 8-row groups 8 rows
// apart, LBO unused for swizzled K-major operands.
template <int KC>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  // 128B, 64B or 32B swizzle
  constexpr uint64_t layout = KC == 64 ? 1 : KC == 32 ? 2 : 3;
  constexpr uint64_t sbo = 8 * KC * 2 / 16;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         (layout << 62);
}

// The address of a 16-byte piece at byte offset ``off`` of a region
// written by TMA with the KC * 2-byte swizzle: bits [7, 7 + s) of the
// offset XOR into bits [4, 4 + s) (CUTLASS's Swizzle<s, 4, 3>).
template <int KC>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = (KC * 2 / 16 - 1) << 4;
  return off ^ ((off >> 3) & mask);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The A fragments of k16 step ``ks``, shifted dx columns, of the MB + 2
// patch rows this warp's output rows read (rows MB w .. MB w + MB + 1 of
// the patch): lane l gives the row address of pixel column l & 15,
// channels [16 ks + 8 (l >> 4), + 8).
template <int KC, int MB>
__device__ __forceinline__ void load_rows(uint32_t (&a)[MB + 2][4],
                                          uint32_t patch, int pix0, int dx,
                                          int ks, int half) {
#pragma unroll
  for (int r = 0; r < MB + 2; ++r) {
    const int pix = pix0 + r * kPatchW + dx;
    const uint32_t off = pix * (KC * 2) + ks * 32 + half * 16;
    ldmatrix_x4(a[r], patch + swizzle<KC>(off));
  }
}

// The products of one K chunk.  Warp w's M block mb is output row
// MB w + mb, so tap (dy, dx) of M block mb reads patch row mb + dy of
// the warp's MB + 2: each (dx, k16 step) loads those rows once and issues
// 3 x MB wgmmas from them as one batch behind one fence (wgmma.fence
// waits for the wgmmas in flight), while the next batch's rows load into
// a second register set.
template <int N, int KC, int MB>
__device__ __forceinline__ void mma_chunk(float (&acc)[MB][N / 2],
                                          uint32_t patch, uint32_t wts,
                                          int pix0, int half) {
  constexpr int kBatches = 3 * (KC / 16);          // (k16 step, dx)
  uint32_t a[2][MB + 2][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[mb][i]);
  load_rows<KC, MB>(a[0], patch, pix0, 0, 0, half);
#pragma unroll
  for (int bt = 0; bt < kBatches; ++bt) {
    const int dx = bt % 3, ks = bt / 3;
    wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t desc = smem_desc<KC>(wts + (dy * 3 + dx) * N * KC * 2 +
                                          ks * 32);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        wgmma_rs<N>(acc[mb], a[bt & 1][mb + dy], desc);
    }
    wgmma_commit();
    if (bt + 1 < kBatches) {
      wgmma_wait<1>();      // batch bt - 1, the other set's reader, is done
      load_rows<KC, MB>(a[(bt + 1) & 1], patch, pix0, (bt + 1) % 3,
                        (bt + 1) / 3, half);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[mb][i]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// y = x + res_scale * conv, conv already rounded to T, in f32, rounded
template <typename T>
__device__ __forceinline__ T residual(const Params& p, T x, T conv) {
  return from_f32<T>(
      __fadd_rn(to_f32(x), __fmul_rn(p.res_scale, to_f32(conv))));
}

// the RRDB's outer residual x_o + round(res_scale * y), rounded as
// PyTorch's multiply and add in T round it
template <typename T>
__device__ __forceinline__ T outer(const Params& p, T xo, T y) {
  return from_f32<T>(__fadd_rn(
      to_f32(xo), to_f32(from_f32<T>(__fmul_rn(p.res_scale, to_f32(y))))));
}

// Bytes of one warp's staging rows: 16 pixels x N channels, + 16 bytes
__host__ __device__ constexpr uint32_t warp_stage_bytes(int n, int elt) {
  return 16 * (n * elt + 16);
}

// Epilogue of M block ``mb`` of this warp: tile row ``oy``, pixels
// [ox0, ox0 + 16), output channels [n0, n0 + N).
template <int N, typename Tout>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const float (&acc)[N / 2],
                                         const float* bias,
                                         Tout* st, int b, int oy, int ox0,
                                         int n0, int lane) {
  constexpr int kRow = N + 16 / sizeof(Tout);        // staging row, elements
  constexpr int kVec = 16 / sizeof(Tout);            // elements per 16 B
  const int g = lane >> 2, t = lane & 3;
  const bool act = p.mode == kStore && p.act;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * t, row = g + 8 * ((i >> 1) & 1);
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[j] = __fadd_rn(acc[i + j], bias[col + j]);
      if (act && v[j] < 0.f) v[j] = __fmul_rn(p.slope, v[j]);
    }
    st[row * kRow + col] = from_f32<Tout>(v[0]);
    st[row * kRow + col + 1] = from_f32<Tout>(v[1]);
  }
  __syncwarp();
  if (oy < p.h) {
    const int nvalid = min(N, p.cout - n0);
    const size_t row_pix = ((size_t)b * p.h + oy) * p.w;
    Tout* out = static_cast<Tout*>(p.out);
    const Tout* res = static_cast<const Tout*>(p.res);
    if (compiled(kResidualNCHW) && p.mode == kResidualNCHW) {
      // y[b][n][oy][ox]: runs of 8 pixels of one channel
      const size_t plane = (size_t)p.h * p.w;
      for (int it = lane; it < 2 * nvalid; it += 32) {
        const int c = it >> 1, px0 = 8 * (it & 1);
        const size_t i0 = ((size_t)b * p.cout + n0 + c) * plane +
                          (size_t)oy * p.w + ox0 + px0;
        if (p.vec_out && ox0 + px0 + 8 <= p.w) {
          alignas(16) Tout xv[kVec], yv[kVec];
          *reinterpret_cast<uint4*>(xv) =
              *reinterpret_cast<const uint4*>(res + i0);
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            yv[j] = residual(p, xv[j], st[(px0 + j) * kRow + c]);
          *reinterpret_cast<uint4*>(out + i0) =
              *reinterpret_cast<const uint4*>(yv);
        } else {
          for (int j = 0; j < 8 && ox0 + px0 + j < p.w; ++j)
            out[i0 + j] = residual(p, res[i0 + j], st[(px0 + j) * kRow + c]);
        }
      }
    } else if (p.vec_out) {
      // channels-last: each pixel's channels as 16-byte pieces
      constexpr int kPer = N / kVec;
      for (int it = lane; it < 16 * kPer; it += 32) {
        const int px = it / kPer, q = (it % kPer) * kVec;
        if (ox0 + px >= p.w || q >= nvalid) continue;
        alignas(16) Tout v[kVec];
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(st + px * kRow + q);
        const size_t pix = row_pix + ox0 + px;
        if (compiled(kResidualNHWC) && p.mode == kResidualNHWC) {
          alignas(16) Tout xv[kVec];
          *reinterpret_cast<uint4*>(xv) =
              *reinterpret_cast<const uint4*>(res + pix * p.cout + n0 + q);
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[j] = residual(p, xv[j], v[j]);
        }
        if (compiled(kChain) && p.mode == kChain) {
          // x_o in out is read before this lane writes the same piece
          const size_t i = pix * p.c_out + n0 + q;
          alignas(16) Tout xv[kVec], ov[kVec];
          *reinterpret_cast<uint4*>(xv) =
              *reinterpret_cast<const uint4*>(res + i);
          if (p.act == kOuterAtOut)
            *reinterpret_cast<uint4*>(ov) =
                *reinterpret_cast<const uint4*>(out + i);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            v[j] = residual(p, xv[j], v[j]);
            if (p.act)
              v[j] = outer(p, p.act == kOuterIsX ? xv[j] : ov[j], v[j]);
          }
        }
        *reinterpret_cast<uint4*>(out + pix * p.c_out + n0 + q) =
            *reinterpret_cast<const uint4*>(v);
      }
    } else {
      for (int it = lane; it < 16 * nvalid; it += 32) {
        const int px = it / nvalid, c = it % nvalid;
        if (ox0 + px >= p.w) continue;
        const size_t pix = row_pix + ox0 + px;
        Tout v = st[px * kRow + c];
        if (compiled(kResidualNHWC) && p.mode == kResidualNHWC)
          v = residual(p, res[pix * p.cout + n0 + c], v);
        if (compiled(kChain) && p.mode == kChain) {
          const size_t i = pix * p.c_out + n0 + c;
          v = residual(p, res[i], v);
          if (p.act) v = outer(p, p.act == kOuterIsX ? res[i] : out[i], v);
        }
        out[pix * p.c_out + n0 + c] = v;
      }
    }
  }
  __syncwarp();
}

// The backward's epilogue of M block ``mb`` (kBwdAct or kBwdDx): the f32
// accumulators, with no bias, staged per warp (16 pixels x N floats, rows
// padded by 16 bytes), then
// - kBwdAct: per 8 channels of a pixel, dout = acc * (act > 0 ? 1 :
//   slope) from the saved activation (the slope branch at exactly 0, as
//   the TPU kernel takes it), dz = dout rounded to bf16 as one 16-byte
//   store, and dout added unrounded into this lane's db sums;
// - kBwdDx: dx = round(g + acc) in NCHW, g read the same way (one
//   rounding, of the final sum).
// Lane l always handles the channels q = 8 (l % (N / 8)) of its items,
// so its db sums belong to those 8 channels.
template <int N>
__device__ __forceinline__ void bwd_epilogue(const BwdParams& p,
                                             const float (&acc)[N / 2],
                                             float* st, int b, int oy,
                                             int ox0, int n0, int lane,
                                             float (&db)[8]) {
  constexpr int kRow = N + 4;                  // staging row, floats
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * t, row = g + 8 * ((i >> 1) & 1);
    *reinterpret_cast<float2*>(st + row * kRow + col) =
        make_float2(acc[i], acc[i + 1]);
  }
  __syncwarp();
  if (oy < p.h) {
    const int nvalid = min(N, p.cout - n0);
    if (p.mode == kBwdAct) {
      constexpr int kPer = N / 8;
      const size_t row_pix = ((size_t)b * p.h + oy) * p.w;
      for (int it = lane; it < 16 * kPer; it += 32) {
        const int px = it / kPer, q = (it % kPer) * 8;
        if (ox0 + px >= p.w || q >= nvalid) continue;
        const size_t pix = row_pix + ox0 + px;
        alignas(16) __nv_bfloat16 a[8], z[8];
        *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.act_in) + pix * p.act_stride +
            n0 + q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = st[px * kRow + q + j];
          if (!(__bfloat162float(a[j]) > 0.f)) v = __fmul_rn(p.slope, v);
          db[j] = __fadd_rn(db[j], v);
          z[j] = __float2bfloat16_rn(v);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.dz) +
                                  pix * p.dz_stride + n0 + q) =
            *reinterpret_cast<const uint4*>(z);
      }
    } else {
      // dx[b][n][oy][ox]: runs of 8 pixels of one channel
      const size_t plane = (size_t)p.h * p.w;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
      const __nv_bfloat16* gr = static_cast<const __nv_bfloat16*>(p.res);
      for (int it = lane; it < 2 * nvalid; it += 32) {
        const int c = it >> 1, px0 = 8 * (it & 1);
        const size_t i0 = ((size_t)b * p.cout + n0 + c) * plane +
                          (size_t)oy * p.w + ox0 + px0;
        if (p.vec_out && ox0 + px0 + 8 <= p.w) {
          alignas(16) __nv_bfloat16 gv[8], yv[8];
          *reinterpret_cast<uint4*>(gv) =
              *reinterpret_cast<const uint4*>(gr + i0);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            yv[j] = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(gv[j]), st[(px0 + j) * kRow + c]));
          *reinterpret_cast<uint4*>(out + i0) =
              *reinterpret_cast<const uint4*>(yv);
        } else {
          for (int j = 0; j < 8 && ox0 + px0 + j < p.w; ++j)
            out[i0 + j] = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(gr[i0 + j]), st[(px0 + j) * kRow + c]));
        }
      }
    }
  }
  __syncwarp();
}

// kBwdAct, after a unit's M blocks: the lanes of each 8 channels add
// their db sums in a fixed order (xor steps over the lanes that share
// them), and the first lane of each writes slot (group, unit, warp w).
template <int N>
__device__ __forceinline__ void bwd_db_slot(const BwdParams& p,
                                            float (&db)[8],
                                            int unit, int w, int n0,
                                            int lane) {
  constexpr int kPer = N / 8;
#pragma unroll
  for (int o = 16; o >= kPer; o >>= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      db[j] = __fadd_rn(db[j], __shfl_xor_sync(0xffffffffu, db[j], o));
  if (lane < kPer) {
    float* slot = p.db_part +
                  ((((size_t)(n0 / N) * p.tiles + unit) * 4 + w) * N) +
                  8 * lane;
#pragma unroll
    for (int j = 0; j < 8; ++j) slot[j] = db[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) db[j] = 0.f;
}

// Grid: n_groups x slots blocks; block (slot, group) computes output
// channels [group * N, + N) of units slot, slot + slots, ...; its k-th
// unit goes to warpgroup k % 2, each warpgroup with a ring of its own,
// so one warpgroup's epilogue overlaps the other's products.  kBwd: the
// backward's epilogues (Tout = float, the staging type).
template <int N, int KC, typename Tout, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const ParamsOf<kBwd> p) {
  constexpr int MB = m_blocks(N);
  constexpr int kUnitH = 4 * MB;                 // output rows per unit
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  // [resident weights][ring 0][ring 1][staging per warp][barriers][bias]
  const uint32_t stage_bytes =
      p.patch_bytes + (p.resident ? 0 : p.wchunk_bytes);
  const uint32_t rings_at = p.resident ? p.nk * p.wchunk_bytes : 0;
  const uint32_t staging_at = rings_at + 2 * p.stages * stage_bytes;
  const uint32_t bars_at =
      staging_at + kConsumerWarps * warp_stage_bytes(N, sizeof(Tout));
  // full / empty barrier of stage s of ring g: + 8 (g kMaxStages + s);
  // resident weights: one barrier per K chunk
  const uint32_t full = base + bars_at, empty = full + 16 * kMaxStages;
  const uint32_t wbar = empty + 16 * kMaxStages;
  // the block's N bias values (0 past cout)
  float* bias = reinterpret_cast<float*>(
      smem_raw + (base - raw) + bars_at + 8 * (4 * kMaxStages + kMaxChunks));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(full + 8 * (g * kMaxStages + s), 1);
        mbar_init(empty + 8 * (g * kMaxStages + s), 4);   // its 4 warps
      }
    for (int kc = 0; kc < kMaxChunks; ++kc) mbar_init(wbar + 8 * kc, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int slot = blockIdx.x / p.n_groups;
  const int slots = gridDim.x / p.n_groups;
  const int n0 = (blockIdx.x % p.n_groups) * N;
  for (int n = threadIdx.x; n < N; n += kThreads)
    bias[n] = !kBwd && n0 + n < p.cout ? p.bias[n0 + n] : 0.f;
  __syncthreads();
  // the next launch may start its blocks as this one's finish (it is
  // launched with programmatic stream serialization, as this one is)
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n");

  const int per_image = p.tiles_x * p.tiles_y;

  if (warp >= kConsumerWarps) {
    // producer warpgroup: hands its registers to the consumers; one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kProducerRegs));
    if (threadIdx.x != 32 * kConsumerWarps) return;
    const uint32_t patch_tx = kPatchW * (kUnitH + 2) * KC * 2;
    const uint32_t w_tx = 9 * N * KC * 2;
    // Weights (and the bias above) are read before the previous launch
    // on the stream has finished: no kernel of this tile writes them, and
    // every other kernel before it had finished when that launch began.
    // Everything else waits for it: griddepcontrol.wait.
    if (p.resident)
      for (int kc = 0; kc < p.nk; ++kc) {
        mbar_expect_tx(wbar + 8 * kc, w_tx);
        tma_load_3d(base + kc * p.wchunk_bytes, &tm_w, wbar + 8 * kc,
                    kc * KC, n0, 0);
      }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    // units in order, so warpgroup 1 starts when warpgroup 0 has freed
    // stages of its first unit: the two run half a unit apart
    int stage[2] = {0, 0};
    uint32_t phase[2] = {0, 0};
    for (int k = 0;; ++k) {
      const int unit = slot + slots * k;
      if (unit >= p.tiles) break;
      const int g = k & 1;
      const int b = unit / per_image, r = unit % per_image;
      const int y0 = (r / p.tiles_x) * kUnitH, x0 = (r % p.tiles_x) * kTile;
      for (int kc = 0; kc < p.nk; ++kc) {
        const uint32_t sb = 8 * (g * kMaxStages + stage[g]);
        mbar_wait(empty + sb, phase[g] ^ 1);
        const uint32_t dst =
            base + rings_at + (g * p.stages + stage[g]) * stage_bytes;
        mbar_expect_tx(full + sb, patch_tx + (p.resident ? 0 : w_tx));
        tma_load_4d(dst, &tm_x, full + sb, kc * KC, x0 - 1, y0 - 1, b);
        if (!p.resident)
          tma_load_3d(dst + p.patch_bytes, &tm_w, full + sb, kc * KC, n0,
                      0);
        if (++stage[g] == p.stages) {
          stage[g] = 0;
          phase[g] ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(kConsumerRegs));
    // warp w of warpgroup g owns rows MB w + mb of its units
    const int g = warp >> 2, w = warp & 3;
    const int pix0 = MB * w * kPatchW + (lane & 15);
    Tout* st = reinterpret_cast<Tout*>(
        smem_raw + (base - raw) + staging_at +
        warp * warp_stage_bytes(N, sizeof(Tout)));
    float acc[MB][N / 2];
    float db[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int stage = 0;
    uint32_t phase = 0;
    for (int k = g;; k += 2) {
      const int unit = slot + slots * k;
      if (unit >= p.tiles) break;
      const int b = unit / per_image, r = unit % per_image;
      const int y0 = (r / p.tiles_x) * kUnitH, x0 = (r % p.tiles_x) * kTile;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[mb][i] = 0.f;
      for (int kc = 0; kc < p.nk; ++kc) {
        const uint32_t sb = 8 * (g * kMaxStages + stage);
        mbar_wait(full + sb, phase);
      if (p.resident) mbar_wait(wbar + 8 * kc, 0);
        const uint32_t patch =
            base + rings_at + (g * p.stages + stage) * stage_bytes;
        const uint32_t wts =
            p.resident ? base + kc * p.wchunk_bytes : patch + p.patch_bytes;
        mma_chunk<N, KC, MB>(acc, patch, wts, pix0, lane >> 4);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + sb);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (kBwd) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          bwd_epilogue<N>(p, acc[mb], st, b, y0 + MB * w + mb, x0, n0, lane,
                          db);
        if (p.mode == kBwdAct) bwd_db_slot<N>(p, db, unit, w, n0, lane);
      } else {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          epilogue<N, Tout>(p, acc[mb], bias, st, b, y0 + MB * w + mb, x0,
                            n0, lane);
      }
    }
  }
}

// ---- host side ----

// One conv, as either forward kernel asks for it.  in: channels-last
// (B, H, W, c_total) bf16 of which channels [0, cin) are read; w: packed
// (9, cout, cin) bf16; bias (cout,) f32; out: see Params.
struct Conv {
  const void* in;
  int c_total, cin;
  const void* w;
  int cout;
  const float* bias;
  void* out;
  int c_out;
  int out_f32;
  int act;
  float slope;
  int mode;
  const void* res;
  float res_scale;
  int batch, h, w_img;
  // kBwdAct (see Params)
  const void* act_in;
  int act_stride;
  void* dz;
  int dz_stride;
  float* db_part;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

struct Plan {
  int kc, stages, resident;
  uint32_t patch_bytes, wchunk_bytes, smem;
};

constexpr uint32_t round_up(uint32_t v, uint32_t a) {
  return (v + a - 1) / a * a;
}

// Chunk width, ring depth and weight residency of a conv with n output
// channels per block, patches of patch_rows rows and cin input channels:
// weights resident if they fit beside two rings of two stages (at 32
// channels a chunk, else 16), else streamed with each stage.  False if
// not even that fits.
inline bool make_plan(int n, int patch_rows, int cin, uint32_t staging,
                      Plan* pl) {
  const uint32_t fixed =
      kAlign + staging + 8 * (4 * kMaxStages + kMaxChunks) + 4 * n;
  // the widest chunk that divides cin (no zero-filled channels), else 16
  int first = 16;
  for (int kc = kMaxChunkK; kc > 16; kc /= 2)
    if (cin % kc == 0) {
      first = kc;
      break;
    }
  for (int resident = 1; resident >= 0; --resident)
    for (int kc = first; kc >= 16; kc /= 2) {
      const uint32_t pb = round_up(kPatchW * patch_rows * kc * 2, kAlign);
      const uint32_t wb = round_up(9 * n * kc * 2, kAlign);
      const int nk = (cin + kc - 1) / kc;
      if (resident && nk > kMaxChunks) continue;
      const uint32_t wall = resident ? nk * wb : 0;
      const uint32_t stage = pb + (resident ? 0 : wb);
      if (fixed + wall + 4 * stage > (uint32_t)kMaxSmem) continue;
      const int s = std::min(
          kMaxStages, (int)((kMaxSmem - fixed - wall) / (2 * stage)));
      *pl = {kc, s, resident, pb, wb, fixed + wall + 2 * s * stage};
      return true;
    }
  return false;
}

template <int N, int KC, typename Tout, bool kBwd>
int launch_kernel(const CUtensorMap& tx, const CUtensorMap& tw,
                  const ParamsOf<kBwd>& p, const Plan& pl, int grid, int dev,
                  cudaStream_t stream) {
  auto kernel = conv3x3_wgmma<N, KC, Tout, kBwd>;
  // the attribute once per device: every plan stays within kMaxSmem
  static uint64_t set_on;                 // bit d: device d
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set_on & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    set_on |= bit;
  }
  // programmatic stream serialization: this launch's blocks may start
  // while the previous launch on the stream finishes (griddepcontrol)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int N, typename Tout, bool kBwd>
int launch_n(const Conv& c, cudaStream_t stream) {
  Plan pl;
  constexpr int kUnitH = 4 * m_blocks(N);
  const uint32_t staging = kConsumerWarps * warp_stage_bytes(N, sizeof(Tout));
  if (!make_plan(N, kUnitH + 2, c.cin, staging, &pl))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = pl.kc == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : pl.kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t px = (cuuint64_t)c.c_total * 2;   // bytes per pixel
  const cuuint64_t xdim[4] = {(cuuint64_t)c.cin, (cuuint64_t)c.w_img,
                              (cuuint64_t)c.h, (cuuint64_t)c.batch};
  const cuuint64_t xstride[3] = {px, px * c.w_img, px * c.w_img * c.h};
  const cuuint32_t xbox[4] = {(cuuint32_t)pl.kc, kPatchW, kUnitH + 2, 1};
  const cuuint64_t wdim[3] = {(cuuint64_t)c.cin, (cuuint64_t)c.cout, 9};
  const cuuint64_t wstride[2] = {(cuuint64_t)c.cin * 2,
                                 (cuuint64_t)c.cin * c.cout * 2};
  const cuuint32_t wbox[3] = {(cuuint32_t)pl.kc, N, 9};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap tx, tw;
  if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(c.in), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(c.w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  ParamsOf<kBwd> p{};
  p.cin = c.cin;
  p.cout = c.cout;
  p.h = c.h;
  p.w = c.w_img;
  p.n_groups = (c.cout + N - 1) / N;
  p.tiles_x = (c.w_img + kTile - 1) / kTile;
  p.tiles_y = (c.h + kUnitH - 1) / kUnitH;
  p.tiles = c.batch * p.tiles_x * p.tiles_y;
  p.nk = (c.cin + pl.kc - 1) / pl.kc;
  p.stages = pl.stages;
  p.resident = pl.resident;
  p.patch_bytes = pl.patch_bytes;
  p.wchunk_bytes = pl.wchunk_bytes;
  p.bias = c.bias;
  p.out = c.out;
  p.c_out = c.c_out;
  p.act = c.act;
  p.slope = c.slope;
  p.mode = c.mode;
  p.res = c.res;
  p.res_scale = c.res_scale;
  if constexpr (kBwd) {
    p.act_in = c.act_in;
    p.act_stride = c.act_stride;
    p.dz = c.dz;
    p.dz_stride = c.dz_stride;
    p.db_part = c.db_part;
  }
  // elements per 16-byte store: the backward writes bf16 from f32 staging
  constexpr int kVec = kBwd ? 8 : 16 / sizeof(Tout);
  const bool aligned = (uintptr_t)c.out % 16 == 0 &&
                       (c.mode == kStore || c.mode == kBwdAct ||
                        (uintptr_t)c.res % 16 == 0);
  p.vec_out = aligned && (c.mode == kResidualNCHW || c.mode == kBwdDx
                              ? c.w_img % kVec == 0
                              : c.c_out % kVec == 0 && c.cout % kVec == 0);

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
  // persistent blocks, one per SM, split evenly over the channel groups
  const int slots = std::max(
      1, std::min(p.tiles, (n_sm + p.n_groups - 1) / p.n_groups));
  const int grid = slots * p.n_groups;
  if (pl.kc == 64)
    return launch_kernel<N, 64, Tout, kBwd>(tx, tw, p, pl, grid, dev, stream);
  if (pl.kc == 32)
    return launch_kernel<N, 32, Tout, kBwd>(tx, tw, p, pl, grid, dev, stream);
  return launch_kernel<N, 16, Tout, kBwd>(tx, tw, p, pl, grid, dev, stream);
}

// The launch, N picked from cout (the whole of it up to 64, else groups
// of kMaxN).  kMaxN bounds the instantiated widths; kBwd picks the
// backward's epilogues.
template <typename Tout, int kMaxN, bool kBwd = false>
int launch(const Conv& c, cudaStream_t stream) {
  if (c.cin < 8 || c.cin % 8 || c.c_total % 8 || c.cin > c.c_total ||
      c.cout < 1 || c.batch < 1 || c.h < 1 || c.w_img < 1 ||
      (uintptr_t)c.in % 16 || (uintptr_t)c.w % 16 || !compiled(c.mode))
    return (int)cudaErrorInvalidValue;
  switch (pick_n(c.cout, kMaxN)) {
    case 8: return launch_n<8, Tout, kBwd>(c, stream);
    case 16: return launch_n<16, Tout, kBwd>(c, stream);
    case 32: return launch_n<32, Tout, kBwd>(c, stream);
    case 64: return launch_n<64, Tout, kBwd>(c, stream);
  }
  return launch_n<(kMaxN > 64 ? 128 : 64), Tout, kBwd>(c, stream);
}

}  // namespace wgc
}  // namespace
