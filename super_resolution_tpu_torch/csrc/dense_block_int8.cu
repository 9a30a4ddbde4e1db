// ESRGAN dense block with dynamic int8 quantization on Hopper (sm_90a):
// one weight-prep launch, one banding launch, then one int8 wgmma conv
// launch per conv (n + 2 launches for n convs).
//
// Replaces the TPU kernel
//   super_resolution_tpu/ops/pallas/experiments_dense_block.py:
//   fused_dense_block_cf8 (v8, _kernel8)
// and computes exactly what it computes.  With n convs (any n >= 1 up to
// kMaxConvs; the halo is n rows), the image is cut into bands of `rows`
// rows; band i reads image rows [i*rows - n, i*rows + rows + n) (zero
// rows outside the image) and recomputes its halo rows itself.  For conv
// k (0-based) of band i:
//   s_x   = max(amax, 1e-6) * (1/127), the amax over the conv's input
//           window (band rows [k, rows + 2n - k), every input channel,
//           the full width) -- one scale per (image, band, conv);
//   q     = clip(rint(v * (1 / s_x)), -127, 127), round half to even;
//   A_dx  = sum over (dy, c) of wq[dx*F + f][dy*C + c] * q, in int32;
//   out   = (fma(A_1, s_w1 * s_x, A_0 * (s_w0 * s_x)) + A_2 * (s_w2 *
//           s_x)) + b, in f32, each dx term dequantized on its own
//           before the shift-add, then LeakyReLU (k < n - 1), zero
//           outside the image rows, rounded to x's dtype;
//   the last conv is rounded to x's dtype before the f32 residual with x.
// The weights are quantized per row dx*F + f of the (3F, 3C) packing:
// s_w = max(max|row|, 1e-12) * (1/127), wq = clip(rint(w / s_w), -127,
// 127).  Every f32 step is an explicit intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, and the one __fmaf_rn), so nvcc contracts nothing on its
// own.  The FMA and the constant 1/127 are what XLA makes of the JAX
// kernel's `left + mid` and `/ 127.0` (checked against the interpreted
// kernel on the CPU); with them the float32 values are the JAX kernel's.
//
// Layout.  A banded channels-last buffer (B * n_bands, rows + 2n, W,
// c_total) holds x in channels [0, C) and each conv's output slice after
// it; conv k reads the channel prefix [0, cin_k) of its window and writes
// rows [k + 1, rows + 2n - 1 - k) of the next slice; the last conv writes
// y (NCHW).  Bands never share a row: a halo row has another value in
// each band that computes it, which is why the result depends on `rows`.
// C and G are padded to multiples of 8 inside the buffer (zero channels,
// zero weights and biases: every amax, weight scale and int32 sum stays
// as it was; an all-zero weight row gets the scale 1e-12 / 127 and
// quantizes to 0).
//
// The launches:
// 1. int8_prep_weights, one launch for all n convs (a pointer table in
//    one parameter struct): per packed row its scale and its int8 row,
//    laid out (tap, cout_p, cpad) with each real input channel at its
//    buffer position and zeros elsewhere (cpad = the buffer prefix
//    rounded up to 32), the (3 cout_p) f32 scales and the f32 biases.
//    It never lets a dependent launch start early: the convs read its
//    output before their griddepcontrol.wait.
// 2. int8_band: x (NCHW) into the buffer's slice 0 (the pad channels
//    zeroed, zero rows outside the image), the per-row maxima of |x|
//    into slice 0 of the amax array, the other slices' rows zeroed.
// 3. conv_int8_wgmma, conv k (programmatic dependent launch).  Its
//    epilogue takes the max |stored value| of each output row (after the
//    image-row mask and the rounding to x's dtype) and atomicMax-es it,
//    as the bits of a non-negative float (ordered as unsigned ints),
//    into slice k + 1 of the amax array (n slices, B * n_bands,
//    band_rows).  Slice j is written exactly on rows [j, band_rows - j),
//    which hold conv k's window for every j <= k, so conv k's scale is
//    the max of slices 0..k over rows [k, band_rows - k): no pass reads
//    the buffer for its amax.  A max does not depend on order, so the
//    result is deterministic.
//
// Bound.  At (8, 64, 128, 128) bf16, rows 16, the block's work with the
// band recompute is sum_k out_rows_k * cin_k * cout_k * 9 * 2 * W * B *
// n_bands = 71.9 GOP: 0.036 ms at 1,979 TOP/s (int8 dense), against
// 33.6 MB of x and y, 0.010 ms at 3.35 TB/s -- bound by operations.
// What the conv's design does about it (the bf16 tile of
// conv3x3_wgmma.cuh, whose helpers it uses, carried over to s8):
// - Products by wgmma.mma_async m64nNk32 .s32.s8.s8, A from registers,
//   B (the weights, K-major (tap, cout, cpad) rows of 32 channels) by a
//   32-byte-swizzled descriptor.  N is the whole cout up to 64 (8, 16,
//   32, 64), else output-channel groups of 64 (grid).  Each dx keeps its
//   own int32 sums (it is dequantized with its own scale): A is shifted
//   by dx in the patch, as in the bf16 tile, and each warp holds three
//   accumulator sets; so a warpgroup's unit is 16 columns by 16 rows at
//   N <= 16, 8 at N = 32, 4 at N = 64 (96 int32 sums a thread).  Per dx
//   a warp loads its MB + 2 patch rows once with ldmatrix and issues the
//   3 x MB wgmmas (dy, M block) behind one fence, the next dx's rows
//   loading into a second register set.
// - Input by TMA from a 4-D tensor map over the banded buffer (dim 0 =
//   cin, rows of c_total elements): its zero fill gives the column
//   padding and the cut at cin.  Stages of 32 channels of x's dtype in
//   rings (full / empty mbarriers), one ring per consumer warpgroup, one
//   producer thread issuing every load (its warpgroup hands its
//   registers to the consumers: setmaxnreg 40 / 232), persistent blocks
//   each walking a contiguous range of units, ping-pong between the two
//   consumer warpgroups.
// - Quantization on the way from the stage to the tensor cores (TMA
//   cannot quantize): the consumer warpgroup turns each stage into an
//   int8 copy with the 32-byte swizzle (two such patches a warpgroup,
//   taking turns, so one named barrier a chunk suffices), which its
//   warps read with ldmatrix (an 8-bit k32 fragment is a 16-bit k16
//   fragment of the same bytes).  Each value is quantized once per
//   conv, not once per dx shift as quantizing after a bf16 ldmatrix
//   would, the ldmatrix reads half the bytes, and x in f32 runs the same
//   kernel (the stage is f32).  rint is one f32 add of 1.5 *
//   2^23 (the integer lands in the low mantissa bits, round half to even
//   as rint); the clip is left out because it changes no value a kept
//   output reads: every value of a conv's window has |v| <= amax, so |v
//   * (1 / s_x)| < 127.5.  Values outside the window (rows below it or
//   past it) only reach output rows the conv discards.  (Tried on an
//   H100 and slower: three quantizer warps feeding int8 rings, which
//   cost the consumers their setmaxnreg registers; 64-channel chunks,
//   one 128-byte TMA row a pixel.)
// - Weights resident in shared memory for the whole launch where they
//   fit (int8 halves them: conv5 of the flagship block is 110.6 KB), one
//   barrier per K chunk; otherwise each stage carries its chunk.
// - Programmatic dependent launch: blocks load their weights, scales and
//   biases before griddepcontrol.wait; every thread that reads the amax
//   array or the buffer waits.
// - Epilogue: dequantize (s_w * s_x in shared memory per band image),
//   bias, LeakyReLU, mask, one rounding, the row maxima (of |v|, rounded
//   once: rounding is monotone), then the rows staged per warp in shared
//   memory and written with 16-byte stores (channels-last slice, or NCHW
//   y with the f32 residual, x loaded ahead of the arithmetic).
// What holds it back (PERF.md has the times): the consumer warps, not
// the tensor cores.  Per unit they spend most of their time in the
// epilogue (three int32 sums converted and dequantized per output) and
// in the products of only one or two 32-channel chunks (the growth
// convs), with two consumer warps a scheduler to hide the latencies.

#include "conv3x3_wgmma.cuh"   // mbarriers, TMA, ldmatrix, wgmma fences,
                               // descriptors, tensor-map encoding

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {
namespace i8 {

using wgc::EncodeTiledFn;
using wgc::from_f32;
using wgc::kAlign;
using wgc::ldmatrix_x4;
using wgc::mbar_arrive;
using wgc::mbar_expect_tx;
using wgc::mbar_init;
using wgc::mbar_wait;
using wgc::round_up;
using wgc::smem_u32;
using wgc::to_f32;
using wgc::warp_stage_bytes;

constexpr int kTile = 16;                      // output columns per unit
constexpr int kPatchW = kTile + 2;
constexpr int kConsumerWarps = 8;              // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
constexpr int kProducerRegs = 40;    // setmaxnreg: what the producer keeps
constexpr int kConsumerRegs = 232;   // and what each consumer thread gets
constexpr int kMaxSmem = 232448;
constexpr int kMaxStages = 4;                  // per ring
constexpr int kMaxChunks = 16;                 // K chunks of resident weights
constexpr int kChunk = 32;                     // channels per K chunk (k32)
constexpr int kMaxConvs = 64;                  // convs of one prep launch
constexpr float kRecip127 = 1.0f / 127.0f;     // XLA's fold of x / 127.0
constexpr float kRound = 12582912.0f;          // 1.5 * 2^23

// M blocks (tile rows) per warp: three accumulator sets of MB x N / 2
// int32 sums stay within 96 a thread
__host__ __device__ constexpr int m_blocks(int n) {
  return n <= 16 ? 4 : n == 32 ? 2 : 1;
}
constexpr int pick_n(int cout) {
  return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
}

// ---- the conv ----

struct Params {
  int cin, cout, c_total, k, halo, rows, h, w, n_bands, band_rows;
  int out_rows;                  // band rows conv k writes
  int n_bb;                      // B * n_bands
  int n_groups;                  // channel groups of N
  int tiles_x, tiles_y, tiles;   // units per channel group
  int nk, stages, resident;
  uint32_t patch_bytes, wchunk_bytes, q_bytes;
  const float* sw;               // (3 cout): the scale of row dx * cout + f
  const float* bias;             // (cout)
  void* buf;
  void* y;                       // the last conv: y, NCHW
  const void* x;                 // the last conv: x, NCHW (the residual)
  float slope, res_scale;
  int last;
  unsigned* amax;                // (n, n_bb, band_rows) float bits
  int vec_out;                   // NCHW 16-byte runs are aligned
};

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void fence_int(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// the consumer warpgroup g's 128 threads, named barrier 1 + g
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}

// eight consecutive channels as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the low bytes of four words, the first in the lowest byte
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The stage (pixels of 32 channels of T, as TMA wrote it) -> its int8
// copy, 32 bytes a pixel with the 32-byte swizzle: q = rint(v * inv) as
// the low byte of v * inv + 1.5 * 2^23 (both steps rounded apart).
template <typename T>
__device__ __forceinline__ void quantize_patch(const T* stage,
                                               unsigned char* q, int n_pix,
                                               float inv, int tid) {
  for (int i = tid; i < n_pix * 4; i += 128) {
    const int p = i >> 2, j = i & 3;
    float v[8];
    load8(stage + p * kChunk + 8 * j, v);
    uint32_t r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      r[e] = __float_as_uint(__fadd_rn(__fmul_rn(v[e], inv), kRound));
    *reinterpret_cast<uint2*>(q + wgc::swizzle<16>(p * kChunk + 8 * j)) =
        make_uint2(pack4(r[0], r[1], r[2], r[3]),
                   pack4(r[4], r[5], r[6], r[7]));
  }
}

// The A fragments, shifted dx columns, of the MB + 2 patch rows this
// warp's output rows read: lane l gives the address of pixel column
// l & 15, bytes [16 (l >> 4), + 16) of its 32 channels.
template <int MB>
__device__ __forceinline__ void load_rows(uint32_t (&a)[MB + 2][4],
                                          uint32_t q, int pix0, int dx,
                                          int half) {
#pragma unroll
  for (int r = 0; r < MB + 2; ++r) {
    const int pix = pix0 + r * kPatchW + dx;
    ldmatrix_x4(a[r], q + wgc::swizzle<16>(pix * kChunk + half * 16));
  }
}

// The products of one K chunk of 32 channels: per dx the MB + 2 rows are
// loaded once and 3 x MB wgmmas (dy, M block) issued as one batch into
// that dx's sums, while the next dx's rows load into the other set.  The
// first chunk's dy = 0 wgmmas overwrite the sums (scale-d 0), so they
// are never zeroed.
template <int N, int MB>
__device__ __forceinline__ void mma_chunk(int (&acc)[3][MB][N / 2],
                                          uint32_t q, uint32_t wts, int pix0,
                                          int half, int first) {
  uint32_t a[2][MB + 2][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_int(acc[dx][mb][i]);
  load_rows<MB>(a[0], q, pix0, 0, half);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    wgc::wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t desc =
          wgc::smem_desc<16>(wts + (dy * 3 + dx) * N * kChunk);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        wgmma_s8<N>(acc[dx][mb], a[dx & 1][mb + dy], desc,
                    !(first && dy == 0));
    }
    wgc::wgmma_commit();
    if (dx < 2) {
      wgc::wgmma_wait<1>();    // dx - 1, the other set's reader, is done
      load_rows<MB>(a[(dx + 1) & 1], q, pix0, dx + 1, half);
    }
  }
  wgc::wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_int(acc[dx][mb][i]);
}

// two neighbouring outputs, rounded to T, as one store
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Runs of 8 pixels of one channel a lane writes per M block of the last
// conv (item lane + 32 r), and the 16-byte pieces of each run
template <int N>
__host__ __device__ constexpr int res_items() { return N >= 16 ? N / 16 : 1; }
template <typename T>
__host__ __device__ constexpr int res_pieces() { return 8 * sizeof(T) / 16; }

// x of the last conv's residual for M block oy, loaded before the
// epilogue's arithmetic so that their latency overlaps it (16-byte runs,
// where W is a multiple of 8)
template <int N, typename T>
__device__ __forceinline__ void load_res(
    const Params& p, uint4 (&xr)[res_items<N>()][res_pieces<T>()], int band,
    int b, int oy, int x0, int n0, int lane) {
  const int img_row = band * p.rows + oy;       // the last conv: k = n - 1
  const int nvalid = min(N, p.cout - n0);
  const T* x = static_cast<const T*>(p.x);
#pragma unroll
  for (int r = 0; r < res_items<N>(); ++r) {
    const int it = lane + 32 * r, c = it >> 1, px0 = 8 * (it & 1);
    if (c < nvalid && oy < p.out_rows && x0 + px0 < p.w) {
      const uint4* src = reinterpret_cast<const uint4*>(
          x + (((size_t)b * p.cout + n0 + c) * p.h + img_row) * p.w + x0 +
          px0);
#pragma unroll
      for (int v = 0; v < res_pieces<T>(); ++v) xr[r][v] = src[v];
    }
  }
}

// Epilogue of one M block of this warp: output row oy of band image bb
// (band `band` of image b), pixels [x0, x0 + 16), output channels [n0,
// n0 + N).  ss: this unit's 3 x N dequantization scales s_w * s_x, bias
// the block's N biases (0 past cout).
template <int N, typename T>
__device__ __forceinline__ void epilogue(const Params& p, const int* a0,
                                         const int* a1, const int* a2,
                                         const float* ss, const float* bias,
                                         T* st, int bb, int band, int b,
                                         int oy, int x0, int n0, int lane) {
  constexpr int kRow = N + 16 / sizeof(T);          // staging row, elements
  constexpr int kVec = 16 / sizeof(T);              // elements per 16 B
  const int g = lane >> 2, t = lane & 3;
  const int img_row = band * p.rows - (p.halo - p.k - 1) + oy;
  const bool in_img = img_row >= 0 && img_row < p.h;
  uint4 xr[res_items<N>()][res_pieces<T>()];
  if (p.last && p.vec_out)
    load_res<N, T>(p, xr, band, b, oy, x0, n0, lane);
  // the row's max |v| over pixels in the image (padded channels are 0);
  // rounding is monotone and odd, so max |round(v)| = round(max |v|)
  const bool col_ok[2] = {x0 + g < p.w, x0 + g + 8 < p.w};
  float m = 0.f;
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    // sums i, i + 1 of acc: row g + 8 half, channels col, col + 1
    const int col = 8 * q + 2 * t;
    const float2 s0 = *reinterpret_cast<const float2*>(ss + col);
    const float2 s1 = *reinterpret_cast<const float2*>(ss + N + col);
    const float2 s2 = *reinterpret_cast<const float2*>(ss + 2 * N + col);
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * q + 2 * half;
      float v[2] = {0.f, 0.f};           // zero outside the image rows
      if (in_img) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float left = __fmul_rn(__int2float_rn(a0[i + j]),
                                       j ? s0.y : s0.x);
          const float mid =
              __fmaf_rn(__int2float_rn(a1[i + j]), j ? s1.y : s1.x, left);
          const float right = __fmul_rn(__int2float_rn(a2[i + j]),
                                        j ? s2.y : s2.x);
          v[j] = __fadd_rn(__fadd_rn(mid, right), j ? bv.y : bv.x);
          if (!p.last && !(v[j] >= 0.f)) v[j] = __fmul_rn(p.slope, v[j]);
        }
        if (col_ok[half]) m = fmaxf(m, fmaxf(fabsf(v[0]), fabsf(v[1])));
      }
      store2(st + (g + 8 * half) * kRow + col, v[0], v[1]);
    }
  }
  __syncwarp();
  if (oy < p.out_rows) {
    if (!p.last) {
      // the row's max |stored value| into slice k + 1
#pragma unroll
      for (int o = 16; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const int brow = p.k + 1 + oy;
      if (lane == 0)
        atomicMax(p.amax + ((size_t)(p.k + 1) * p.n_bb + bb) * p.band_rows +
                      brow,
                  __float_as_uint(to_f32(from_f32<T>(m))));
      // each pixel's channels as 16-byte pieces (cout is a multiple of 8)
      constexpr int kPer = N / kVec;
      T* out = static_cast<T*>(p.buf) +
               ((size_t)bb * p.band_rows + brow) * p.w * p.c_total + p.cin +
               n0;
      for (int it = lane; it < 16 * kPer; it += 32) {
        const int px = it / kPer, q = (it % kPer) * kVec;
        if (x0 + px >= p.w || n0 + q >= p.cout) continue;
        *reinterpret_cast<uint4*>(out + (size_t)(x0 + px) * p.c_total + q) =
            *reinterpret_cast<const uint4*>(st + px * kRow + q);
      }
    } else {
      // y[b][n][img_row][ox] = x + res_scale * conv: runs of 8 pixels of
      // one channel (img_row is band * rows + oy: k = n - 1)
      const int nvalid = min(N, p.cout - n0);
      T* y = static_cast<T*>(p.y);
      const T* x = static_cast<const T*>(p.x);
      if (p.vec_out) {
#pragma unroll
        for (int r = 0; r < res_items<N>(); ++r) {
          const int it = lane + 32 * r, c = it >> 1, px0 = 8 * (it & 1);
          if (c >= nvalid || x0 + px0 >= p.w) continue;
          const size_t i0 = (((size_t)b * p.cout + n0 + c) * p.h + img_row) *
                                p.w + x0 + px0;
          alignas(16) T xv[8], yv[8];
#pragma unroll
          for (int v = 0; v < res_pieces<T>(); ++v)
            reinterpret_cast<uint4*>(xv)[v] = xr[r][v];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            yv[j] = from_f32<T>(__fadd_rn(
                to_f32(xv[j]),
                __fmul_rn(p.res_scale, to_f32(st[(px0 + j) * kRow + c]))));
#pragma unroll
          for (int v = 0; v < res_pieces<T>(); ++v)
            reinterpret_cast<uint4*>(y + i0)[v] =
                reinterpret_cast<const uint4*>(yv)[v];
        }
      } else {
        for (int it = lane; it < 2 * nvalid; it += 32) {
          const int c = it >> 1, px0 = 8 * (it & 1);
          const size_t i0 = (((size_t)b * p.cout + n0 + c) * p.h + img_row) *
                                p.w + x0 + px0;
          for (int j = 0; j < 8 && x0 + px0 + j < p.w; ++j)
            y[i0 + j] = from_f32<T>(__fadd_rn(
                to_f32(x[i0 + j]),
                __fmul_rn(p.res_scale, to_f32(st[(px0 + j) * kRow + c]))));
        }
      }
    }
  }
  __syncwarp();
}

// s_x of (band image bb, conv k): the max of amax slices 0..k over band
// rows [k, band_rows - k), by one warp, every lane getting it.  The
// first 32 kScaleLoads reads are issued at once (the windows of a 5-conv
// block at rows 16 hold at most 130 words), the rest one by one.
constexpr int kScaleLoads = 4;

__device__ __forceinline__ const unsigned* amax_word(const Params& p, int bb,
                                                     int i) {
  const int win_rows = p.band_rows - 2 * p.k;
  const int j = i / win_rows, row = p.k + i % win_rows;
  return p.amax + ((size_t)j * p.n_bb + bb) * p.band_rows + row;
}

__device__ __forceinline__ float band_scale(const Params& p, int bb,
                                            int lane) {
  const int total = (p.k + 1) * (p.band_rows - 2 * p.k);
  unsigned v[kScaleLoads];
#pragma unroll
  for (int u = 0; u < kScaleLoads; ++u) {
    const int i = lane + 32 * u;
    v[u] = i < total ? *amax_word(p, bb, i) : 0u;
  }
  unsigned mu = 0u;
#pragma unroll
  for (int u = 0; u < kScaleLoads; ++u) mu = max(mu, v[u]);
  for (int i = lane + 32 * kScaleLoads; i < total; i += 32)
    mu = max(mu, *amax_word(p, bb, i));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    mu = max(mu, __shfl_xor_sync(0xffffffffu, mu, o));
  return __fmul_rn(fmaxf(__uint_as_float(mu), 1e-6f), kRecip127);
}

// Grid: n_groups x slots persistent blocks; block (slot, group) computes
// output channels [group * N, + N) of a contiguous range of units (so
// consecutive units mostly share their band image and its scale), its
// k-th unit on consumer warpgroup k % 2, each with a ring of its own.
// One producer thread issues every TMA load; each consumer warpgroup
// quantizes its stages into two int8 patches in turn, runs the products
// and the epilogue.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const Params p) {
  constexpr int MB = m_blocks(N);
  constexpr int kUnitH = 4 * MB;
  constexpr int kPatchPix = kPatchW * (kUnitH + 2);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  unsigned char* const gbase = smem_raw + (base - raw);
  // [resident weights][stage rings 0, 1][int8 patches 2 x 2][staging per
  // consumer warp][barriers][scales 3N][bias N][2 x 3N: s_w * s_x]
  const uint32_t stage_bytes =
      p.patch_bytes + (p.resident ? 0 : p.wchunk_bytes);
  const uint32_t rings_at = p.resident ? p.nk * p.wchunk_bytes : 0;
  const uint32_t q_at = rings_at + 2 * p.stages * stage_bytes;
  const uint32_t staging_at = q_at + 4 * p.q_bytes;
  const uint32_t bars_at =
      staging_at + kConsumerWarps * warp_stage_bytes(N, sizeof(T));
  // full / empty barrier of stage s of ring g: + 8 (g kMaxStages + s);
  // resident weights: one barrier per K chunk
  const uint32_t full = base + bars_at, empty = full + 16 * kMaxStages;
  const uint32_t wbar = empty + 16 * kMaxStages;
  float* const sc = reinterpret_cast<float*>(
      gbase + bars_at + 8 * (4 * kMaxStages + kMaxChunks));
  float* const bias = sc + 3 * N;
  float* const ss_all = bias + N;

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
  const int u_begin = (int)((long long)p.tiles * slot / slots);
  const int u_end = (int)((long long)p.tiles * (slot + 1) / slots);
  const int n0 = (blockIdx.x % p.n_groups) * N;
  // scales and biases come from the prep launch, which had finished
  // before the previous launch on the stream began
  for (int i = threadIdx.x; i < 3 * N; i += kThreads) {
    const int dx = i / N, n = n0 + i % N;
    sc[i] = n < p.cout ? p.sw[dx * p.cout + n] : 0.f;
  }
  for (int n = threadIdx.x; n < N; n += kThreads)
    bias[n] = n0 + n < p.cout ? p.bias[n0 + n] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("griddepcontrol.launch_dependents;\n");

  const int per_bb = p.tiles_x * p.tiles_y;

  if (warp >= kConsumerWarps) {
    // the producer warpgroup: hands its registers to the consumers; one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kProducerRegs));
    if (threadIdx.x != 32 * kConsumerWarps) return;
    const uint32_t patch_tx = kPatchPix * kChunk * sizeof(T);
    const uint32_t w_tx = 9 * N * kChunk;
    if (p.resident)
      for (int kc = 0; kc < p.nk; ++kc) {
        mbar_expect_tx(wbar + 8 * kc, w_tx);
        wgc::tma_load_3d(base + kc * p.wchunk_bytes, &tm_w, wbar + 8 * kc,
                         kc * kChunk, n0, 0);
      }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    int stage[2] = {0, 0};
    uint32_t phase[2] = {0, 0};
    for (int k = 0; u_begin + k < u_end; ++k) {
      const int unit = u_begin + k, g = k & 1;
      const int bb = unit / per_bb, r = unit % per_bb;
      const int y0 = (r / p.tiles_x) * kUnitH, x0 = (r % p.tiles_x) * kTile;
      for (int kc = 0; kc < p.nk; ++kc) {
        const uint32_t sb = 8 * (g * kMaxStages + stage[g]);
        mbar_wait(empty + sb, phase[g] ^ 1);
        const uint32_t dst =
            base + rings_at + (g * p.stages + stage[g]) * stage_bytes;
        mbar_expect_tx(full + sb, patch_tx + (p.resident ? 0 : w_tx));
        // window rows from band row k + y0; columns from x0 - 1
        wgc::tma_load_4d(dst, &tm_x, full + sb, kc * kChunk, x0 - 1,
                         p.k + y0, bb);
        if (!p.resident)
          wgc::tma_load_3d(dst + p.patch_bytes, &tm_w, full + sb,
                           kc * kChunk, n0, 0);
        if (++stage[g] == p.stages) {
          stage[g] = 0;
          phase[g] ^= 1;
        }
      }
    }
  } else {
    // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(kConsumerRegs));
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the amax
    const int g = warp >> 2, w = warp & 3;
    const int wtid = threadIdx.x & 127;
    const int pix0 = MB * w * kPatchW + (lane & 15);
    T* const st = reinterpret_cast<T*>(gbase + staging_at +
                                       warp * warp_stage_bytes(N, sizeof(T)));
    float* const ss = ss_all + 3 * N * g;
    int acc[3][MB][N / 2];
    int stage = 0, chunks = 0;
    uint32_t phase = 0;
    int cached_bb = -1;
    float inv = 0.f;
    for (int k = g; u_begin + k < u_end; k += 2) {
      const int unit = u_begin + k;
      const int bb = unit / per_bb, r = unit % per_bb;
      const int band = bb % p.n_bands, b = bb / p.n_bands;
      const int y0 = (r / p.tiles_x) * kUnitH, x0 = (r % p.tiles_x) * kTile;
      if (bb != cached_bb) {
        // this band's scales, once the last epilogue has read the
        // previous ones
        const float s_x = band_scale(p, bb, lane);
        inv = __fdiv_rn(1.0f, s_x);
        wg_sync(g);
        for (int i = wtid; i < 3 * N; i += 128) ss[i] = __fmul_rn(sc[i], s_x);
        cached_bb = bb;
      }
      for (int kc = 0; kc < p.nk; ++kc, ++chunks) {
        const uint32_t sb = 8 * (g * kMaxStages + stage);
        mbar_wait(full + sb, phase);
        if (p.resident) mbar_wait(wbar + 8 * kc, 0);
        const uint32_t off = rings_at + (g * p.stages + stage) * stage_bytes;
        // the two int8 patches take turns: the one written here was last
        // read two chunks ago, before every warp passed the barrier below
        const uint32_t q_off = q_at + (2 * g + (chunks & 1)) * p.q_bytes;
        quantize_patch<T>(reinterpret_cast<const T*>(gbase + off),
                          gbase + q_off, kPatchPix, inv, wtid);
        if (p.resident) {          // the stage is free once quantized
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + sb);
        }
        wg_sync(g);                // the int8 patch (and ss) is complete
        mma_chunk<N, MB>(acc, base + q_off,
                         p.resident ? base + kc * p.wchunk_bytes
                                    : base + off + p.patch_bytes,
                         pix0, lane >> 4, kc == 0);
        if (!p.resident) {         // its weights were read by the wgmmas
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + sb);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        epilogue<N, T>(p, acc[0][mb], acc[1][mb], acc[2][mb], ss, bias, st,
                       bb, band, b, y0 + MB * w + mb, x0, n0, lane);
    }
  }
}

// ---- the weight-prep launch ----

// The n convs' HWIO weights and f32 biases, and where each conv's int8
// rows (tap, cout_p, cpad), (3 cout_p) scales and (cout_p) biases go in
// the scratch buffer (byte offsets).  Conv k reads the buffer prefix
// cin_p = cp + k gp (real channels C + k G) and writes cout_p = gp
// channels (G real; the last conv C), cpad = cin_p rounded up to 32.
struct PrepArgs {
  const void* w[kMaxConvs];
  const float* b[kMaxConvs];
  int ws[kMaxConvs][4];            // element strides of w's 4 HWIO dims
  long long wq_off[kMaxConvs], sw_off[kMaxConvs], bias_off[kMaxConvs];
  void* scratch;
  int n, c, g, cp, gp, w_bf16;
};

// w[dy][dx][c][f] of conv k, read through its strides
__device__ __forceinline__ float load_w(const PrepArgs& a, int k, int dy,
                                        int dx, int c, int f) {
  const size_t i = (size_t)dy * a.ws[k][0] + (size_t)dx * a.ws[k][1] +
                   (size_t)c * a.ws[k][2] + (size_t)f * a.ws[k][3];
  return a.w_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.w[k])[i])
             : static_cast<const float*>(a.w[k])[i];
}

// One block per packed row dx * cout_p + f of one conv.
__global__ void __launch_bounds__(128)
    int8_prep_weights(const __grid_constant__ PrepArgs a) {
  int row = blockIdx.x, k = 0;
  for (; k < a.n - 1; ++k) {
    if (row < 3 * a.gp) break;
    row -= 3 * a.gp;
  }
  const bool last = k == a.n - 1;
  const int cout = last ? a.c : a.g, cout_p = last ? a.c : a.gp;
  const int cin = a.c + k * a.g, cin_p = a.cp + k * a.gp;
  const int cpad = (cin_p + kChunk - 1) / kChunk * kChunk;
  const int dx = row / cout_p, f = row % cout_p;
  // max |w| over (dy, c) of HWIO w[dy][dx][c][f]
  float m = 0.f;
  if (f < cout)
    for (int i = threadIdx.x; i < 3 * cin; i += 128) {
      const int dy = i / cin, c = i % cin;
      m = fmaxf(m, fabsf(load_w(a, k, dy, dx, c, f)));
    }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[4];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
  const float s = __fmul_rn(fmaxf(m, 1e-12f), kRecip127);
  unsigned char* const scratch = static_cast<unsigned char*>(a.scratch);
  if (threadIdx.x == 0) {
    reinterpret_cast<float*>(scratch + a.sw_off[k])[row] = s;
    if (dx == 0)
      reinterpret_cast<float*>(scratch + a.bias_off[k])[f] =
          f < cout ? a.b[k][f] : 0.f;
  }
  int8_t* const wq = reinterpret_cast<int8_t*>(scratch + a.wq_off[k]);
  for (int i = threadIdx.x; i < 3 * cpad; i += 128) {
    const int dy = i / cpad, cb = i % cpad;
    // the real input channel at buffer channel cb, or -1 (padding)
    int real = -1;
    if (cb < cin_p && f < cout) {
      if (cb < a.cp) {
        real = cb < a.c ? cb : -1;
      } else {
        const int e = cb - a.cp, j = e / a.gp, r = e % a.gp;
        real = r < a.g ? a.c + j * a.g + r : -1;
      }
    }
    int qv = 0;
    if (real >= 0) {
      const float v = load_w(a, k, dy, dx, real, f);
      qv = (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    }
    wq[((size_t)(dy * 3 + dx) * cout_p + f) * cpad + cb] = (int8_t)qv;
  }
}

// ---- the banding launch ----

constexpr int kBandPix = 64;                   // pixels of a banding tile
constexpr int kBandCh = 64;                    // channels of a banding tile

// One block per (band image bb, band row): x's row into the buffer's
// channels [0, cp) through a shared-memory transpose of 64 x 64 tiles
// (runs of 8 pixels in, runs of 8 channels out; channel row ch keeps
// pixel px at column px ^ 8 ((ch / 8) % 8), so the 8 lanes that read one
// pixel's channels hit 8 different 16-byte bank groups), zero outside the image
// and in [C, cp); the row's max |x| into amax slice 0, and the row of
// every other slice zeroed.  vec: W is a multiple of 8 (x's runs of 8
// pixels are 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(256)
    int8_band(const T* x, T* buf, unsigned* amax, int c, int h, int w,
              int rows, int halo, int n_bands, int cp, int c_total,
              int n_slices, int vec) {
  __shared__ __align__(16) T tile[kBandCh][kBandPix];
  const int band_rows = rows + 2 * halo;
  const int n_bb = gridDim.x / band_rows;
  const int brow = blockIdx.x % band_rows, bb = blockIdx.x / band_rows;
  const int band = bb % n_bands, b = bb / n_bands;
  const int img = band * rows - halo + brow;
  const bool inside = img >= 0 && img < h;
  T* const out = buf + ((size_t)bb * band_rows + brow) * w * c_total;
  float m = 0.f;
  for (int px0 = 0; px0 < w; px0 += kBandPix)
    for (int c0 = 0; c0 < cp; c0 += kBandCh) {
      // in: item (channel, run of 8 pixels)
      for (int it = threadIdx.x; it < kBandCh * kBandPix / 8; it += 256) {
        const int ch = it / (kBandPix / 8), px = 8 * (it % (kBandPix / 8));
        alignas(16) T v[8];
        const size_t src =
            (((size_t)b * c + c0 + ch) * h + img) * w + px0 + px;
        const bool real = inside && c0 + ch < c;
        if (real && vec && px0 + px + 8 <= w) {
#pragma unroll
          for (int q = 0; q < res_pieces<T>(); ++q)
            reinterpret_cast<uint4*>(v)[q] =
                reinterpret_cast<const uint4*>(x + src)[q];
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = real && px0 + px + j < w ? x[src + j] : from_f32<T>(0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(to_f32(v[j])));
#pragma unroll
        for (int q = 0; q < res_pieces<T>(); ++q)
          reinterpret_cast<uint4*>(&tile[ch][px ^ (8 * ((ch >> 3) & 7))])[q] =
              reinterpret_cast<const uint4*>(v)[q];
      }
      __syncthreads();
      // out: item (pixel, run of 8 channels)
      for (int it = threadIdx.x; it < kBandPix * kBandCh / 8; it += 256) {
        const int px = it / (kBandCh / 8), ch = 8 * (it % (kBandCh / 8));
        if (px0 + px >= w || c0 + ch >= cp) continue;
        alignas(16) T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = tile[ch + j][px ^ (8 * ((ch >> 3) & 7))];
        T* dst = out + (size_t)(px0 + px) * c_total + c0 + ch;
#pragma unroll
        for (int q = 0; q < res_pieces<T>(); ++q)
          reinterpret_cast<uint4*>(dst)[q] =
              reinterpret_cast<const uint4*>(v)[q];
      }
      __syncthreads();
    }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) m = fmaxf(m, part[i]);
    amax[(size_t)bb * band_rows + brow] = __float_as_uint(m);
  }
  for (int j = 1 + threadIdx.x; j < n_slices; j += 256)
    amax[((size_t)j * n_bb + bb) * band_rows + brow] = 0u;
}

// ---- host side ----

struct Plan {
  int stages, resident;
  uint32_t patch_bytes, wchunk_bytes, q_bytes, smem;
};

// Ring depth and weight residency of a conv with N output channels a
// block, units of unit_h rows and cin input channels of elt bytes:
// weights resident if they fit beside two rings of one stage (and the
// four int8 patches), else streamed with each stage; the rest of shared
// memory deepens the rings, to 4 stages.  False if not even that fits.
inline bool make_plan(int n, int unit_h, int cin, int elt, Plan* pl) {
  const uint32_t staging = kConsumerWarps * warp_stage_bytes(n, elt);
  // + scales 3n, biases n and two warpgroups' 3n scales, f32
  const uint32_t fixed =
      kAlign + staging + 8 * (4 * kMaxStages + kMaxChunks) + 40 * n;
  const uint32_t pix = kPatchW * (unit_h + 2);
  const uint32_t pb = round_up(pix * kChunk * elt, kAlign);
  const uint32_t qb = round_up(pix * kChunk, kAlign);
  const uint32_t wb = round_up(9 * n * kChunk, kAlign);
  const int nk = (cin + kChunk - 1) / kChunk;
  for (int resident = 1; resident >= 0; --resident) {
    if (resident && nk > kMaxChunks) continue;
    const uint32_t stage = pb + (resident ? 0 : wb);
    const uint32_t used = fixed + (resident ? nk * wb : 0) + 4 * qb;
    if (used + 2 * stage > (uint32_t)kMaxSmem) continue;
    const int s =
        std::min(kMaxStages, (int)((kMaxSmem - used) / (2 * stage)));
    *pl = {s, resident, pb, wb, qb, used + 2 * s * stage};
    return true;
  }
  return false;
}

inline int sm_count(int dev, int* n_sm) {
  static int sms_of[64];
  if (dev < 64 && sms_of[dev]) {
    *n_sm = sms_of[dev];
    return 0;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) sms_of[dev] = *n_sm;
  return 0;
}

struct ConvArgs {
  void* buf;
  int c_total, cin, k, halo;
  const void* wq;
  int cpad;
  const float* sw;
  const float* bias;
  int cout;
  void* y;
  const void* x;
  int batch, n_bands, rows, h, w;
  float slope, res_scale;
  int last;
  unsigned* amax;
};

template <int N, typename T>
int launch_conv(const ConvArgs& c, cudaStream_t stream) {
  constexpr int kUnitH = 4 * m_blocks(N);
  constexpr bool kBf16 = sizeof(T) == 2;
  Plan pl;
  if (!make_plan(N, kUnitH, c.cin, sizeof(T), &pl))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = wgc::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int band_rows = c.rows + 2 * c.halo;
  const int n_bb = c.batch * c.n_bands;
  const cuuint64_t px = (cuuint64_t)c.c_total * sizeof(T);
  const cuuint64_t xdim[4] = {(cuuint64_t)c.cin, (cuuint64_t)c.w,
                              (cuuint64_t)band_rows, (cuuint64_t)n_bb};
  const cuuint64_t xstride[3] = {px, px * c.w, px * c.w * band_rows};
  const cuuint32_t xbox[4] = {kChunk, kPatchW, kUnitH + 2, 1};
  const cuuint64_t wdim[3] = {(cuuint64_t)c.cpad, (cuuint64_t)c.cout, 9};
  const cuuint64_t wstride[2] = {(cuuint64_t)c.cpad,
                                 (cuuint64_t)c.cpad * c.cout};
  const cuuint32_t wbox[3] = {kChunk, N, 9};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap tx, tw;
  if (encode(&tx, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, c.buf, xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(c.wq),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  Params p{};
  p.cin = c.cin;
  p.cout = c.cout;
  p.c_total = c.c_total;
  p.k = c.k;
  p.halo = c.halo;
  p.rows = c.rows;
  p.h = c.h;
  p.w = c.w;
  p.n_bands = c.n_bands;
  p.band_rows = band_rows;
  p.out_rows = band_rows - 2 * c.k - 2;
  p.n_bb = n_bb;
  p.n_groups = (c.cout + N - 1) / N;
  p.tiles_x = (c.w + kTile - 1) / kTile;
  p.tiles_y = (p.out_rows + kUnitH - 1) / kUnitH;
  p.tiles = n_bb * p.tiles_x * p.tiles_y;
  p.nk = (c.cin + kChunk - 1) / kChunk;
  p.stages = pl.stages;
  p.resident = pl.resident;
  p.patch_bytes = pl.patch_bytes;
  p.wchunk_bytes = pl.wchunk_bytes;
  p.q_bytes = pl.q_bytes;
  p.sw = c.sw;
  p.bias = c.bias;
  p.buf = c.buf;
  p.y = c.y;
  p.x = c.x;
  p.slope = c.slope;
  p.res_scale = c.res_scale;
  p.last = c.last;
  p.amax = c.amax;
  p.vec_out = c.w % 8 == 0 && (uintptr_t)c.y % 16 == 0 &&
              (uintptr_t)c.x % 16 == 0;

  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int rc = sm_count(dev, &n_sm);
  if (rc) return rc;
  auto kernel = conv_int8_wgmma<N, T>;
  static uint64_t set_on;                 // bit d: the attribute on device d
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set_on & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    set_on |= bit;
  }
  const int slots = std::max(
      1, std::min(p.tiles, (n_sm + p.n_groups - 1) / p.n_groups));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slots * p.n_groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_conv_t(const ConvArgs& c, cudaStream_t s) {
  switch (pick_n(c.cout)) {
    case 8: return launch_conv<8, T>(c, s);
    case 16: return launch_conv<16, T>(c, s);
    case 32: return launch_conv<32, T>(c, s);
  }
  return launch_conv<64, T>(c, s);
}

}  // namespace i8
}  // namespace

// All n convs' weights: args is a PrepArgs (a type of this file only,
// so the C interface takes its address untyped); one launch, grid = the
// packed rows of every conv.  Returns cudaGetLastError().
extern "C" int dense_block_int8_prep(const void* args, void* stream) {
  const i8::PrepArgs* a = static_cast<const i8::PrepArgs*>(args);
  if (a->n < 1 || a->n > i8::kMaxConvs || a->c < 1 || a->cp % 8 ||
      a->cp < a->c || (a->n > 1 && (a->g < 1 || a->gp % 8 || a->gp < a->g)))
    return (int)cudaErrorInvalidValue;
  const int blocks = 3 * ((a->n - 1) * a->gp + a->c);
  i8::int8_prep_weights<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return (int)cudaGetLastError();
}

// x (B, C, H, W) into the banded buffer and amax slice 0 (see int8_band).
extern "C" int dense_block_int8_band(int is_bf16, const void* x, void* buf,
                                     void* amax, int batch, int c, int h,
                                     int w, int rows, int halo, int cp,
                                     int c_total, int n_slices,
                                     void* stream) {
  const long long blocks =
      (long long)batch * (h / (rows > 0 ? rows : 1)) * (rows + 2 * halo);
  if (batch < 1 || c < 1 || cp < c || cp % 8 || c_total < cp ||
      c_total % 8 || rows < 5 || h % rows || w < 1 || halo < 1 ||
      n_slices != halo || blocks > 0x7fffffffLL || (uintptr_t)buf % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* am = static_cast<unsigned*>(amax);
  // 16-byte runs of x: aligned where W is a multiple of 8
  const int vec = w % 8 == 0 && (uintptr_t)x % 16 == 0;
  if (is_bf16)
    i8::int8_band<__nv_bfloat16><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(buf), am, c, h, w, rows, halo, h / rows,
        cp, c_total, n_slices, vec);
  else
    i8::int8_band<float><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(buf), am, c, h, w,
        rows, halo, h / rows, cp, c_total, n_slices, vec);
  return (int)cudaGetLastError();
}

// Conv k of the int8 block (see the note above).  The wrapper checks
// shapes, dtypes and contiguity; the widths are checked here too because
// they pick the template and the tensor maps.
extern "C" int dense_block_int8_conv(
    int is_bf16, void* buf, int c_total, int cin, int k, int halo,
    const void* wq, int cpad, const void* sw, const void* bias, int cout,
    void* y, const void* x, int batch, int n_bands, int rows, int h,
    int w_img, float slope, float res_scale, int last, void* amax,
    void* stream) {
  if (cout < 1 || cin < 8 || cin % 8 || c_total % 8 ||
      cin + (last ? 0 : cout) > c_total || (!last && cout % 8) ||
      cpad < cin || cpad % i8::kChunk || k < 0 || k >= halo || rows < 5 ||
      n_bands * rows != h || batch < 1 || w_img < 1 ||
      (uintptr_t)buf % 16 || (uintptr_t)wq % 16)
    return (int)cudaErrorInvalidValue;
  const i8::ConvArgs a{buf, c_total, cin, k, halo,
                       wq, cpad, static_cast<const float*>(sw),
                       static_cast<const float*>(bias), cout, y, x, batch,
                       n_bands, rows, h, w_img, slope, res_scale, last,
                       static_cast<unsigned*>(amax)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? i8::launch_conv_t<__nv_bfloat16>(a, s)
                 : i8::launch_conv_t<float>(a, s);
}

// The conv's plan for a cout, cin and dtype: {N, unit rows, stages,
// weights resident, dynamic shared memory}; the [build] line prints it.
extern "C" int dense_block_int8_plan(int cout, int cin, int is_bf16,
                                     int* out) {
  const int n = i8::pick_n(cout), unit_h = 4 * i8::m_blocks(n);
  i8::Plan pl;
  if (!i8::make_plan(n, unit_h, cin, is_bf16 ? 2 : 4, &pl))
    return (int)cudaErrorInvalidValue;
  out[0] = n;
  out[1] = unit_h;
  out[2] = pl.stages;
  out[3] = pl.resident;
  out[4] = (int)pl.smem;
  return 0;
}



extern "C" const char* dense_block_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
