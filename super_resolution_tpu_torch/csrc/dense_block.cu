// ESRGAN dense block on Hopper (sm_90a): one 3x3 SAME conv per launch,
// five launches per block, all reading and writing one feature buffer.
//
// Replaces the TPU kernels
//   super_resolution_tpu/ops/pallas/dense_block_cf.py:fused_dense_block_cf5
//   super_resolution_tpu/ops/pallas/dense_block_cf_ext.py:fused_dense_block_cf9
// (one function, one contract), and with x and y channels-last
//   super_resolution_tpu/ops/pallas/dense_block.py:fused_dense_block
// (the same function behind an NHWC contract).  For k = 1..4
//   x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) + b_k)
// and y = x + res_scale * conv5(cat(x, x_1..x_4)).  Numerics follow the
// Pallas kernels, not the per-conv lax path: every conv accumulates in
// f32, adds its f32 bias in f32, applies LeakyReLU for k < 5 and is
// rounded to x's dtype; conv5 is rounded to x's dtype BEFORE the f32
// residual, and y is rounded to x's dtype.
//
// Layout.  The wrapper (ops/dense_block.py) allocates one channels-last
// feature buffer (B, H, W, C + 4G) and copies the input x into channels
// [0, C) (from NCHW a transpose, from NHWC a strided copy).  Launch k
// reads the channel prefix [0, C + (k-1)G) and its epilogue writes the
// next channel slice, so the concat costs nothing; launch 5 writes y in
// x's layout (NCHW, or NHWC with the nhwc flag) and reads x for the
// residual.  Channels-last puts the channels of one pixel side by side,
// so a tile's input moves as 16-byte copies.  Weights are packed once
// per model as (9, cout, cin): tap-major (tap = dy*3 + dx), then output
// channel, then input channel.
//
// The tile's main loop is shared with the backward kernels and lives in
// conv3x3_tile.cuh.
//
// Bound.  At the flagship shape (8, 64, 128, 128) bf16 one block is
// 62.8 GFLOP against 34.0 MB of input, weights and output: ~63.5 us of
// tensor-core time at 989 TFLOP/s against ~10 us of memory time at
// 3.35 TB/s, so it is bound by operations.  What this design does about
// it: the bf16 path runs every multiply-add on the tensor cores
// (mma.sync m16n8k16, f32 accumulate) as an implicit GEMM with
// M = pixels, N = output channels, K = 9 * input channels: one 16x16-pixel
// output tile and all output channels per block, K in chunks of 32
// channels, the input patch and weight chunk brought into shared memory
// by cp.async two chunks deep, so the next chunk's copy overlaps this
// chunk's products.  Padded shared-memory rows keep the fragment loads
// free of bank conflicts.  It is still a first kernel: mma.sync reaches
// only part of the wgmma rate, and per-conv launches re-read the growing
// buffer (from L2 at this size).  wgmma, TMA and one fused launch per
// block are the next steps, measured in PERF.md.
//
// The f32 path (used when the model runs in float32) uses scalar FMA in
// the same tiling, so float32 stays IEEE float32 (no TF32).

#include "conv3x3_tile.cuh"

namespace {

struct ConvArgs {
  ConvIn c;                // buffer, weights (9, cout, cin), geometry
  const float* bias;       // (cout,)
  void* out;               // convs 1-4: buffer + first output channel;
                           // conv5: y, (B, cout, H, W) or (B, H, W, cout)
  const void* res;         // conv5: x, laid out like y; else unused
  float slope, res_scale;
  int residual;            // 0: LReLU epilogue, 1: y = x + res_scale * conv
  int nhwc;                // conv5: x and y are NHWC (else NCHW)
};

// convs 1-4: bias, LeakyReLU, rounding to T (the value stored)
template <typename T>
__device__ __forceinline__ T act_out(const ConvArgs& a, int n, float acc) {
  const float v = __fadd_rn(acc, a.bias[n]);
  return from_f32<T>(v >= 0.f ? v : __fmul_rn(a.slope, v));
}

// conv5: bias, rounding to T, then the f32 residual with x, rounded to T;
// y and x are NCHW, or NHWC with a.nhwc
template <typename T>
__device__ __forceinline__ void store_res(const ConvArgs& a, int b, int n,
                                          size_t pix, float acc) {
  const size_t hw = (size_t)a.c.h * a.c.w_img;
  const size_t i = a.nhwc ? ((size_t)b * hw + pix) * a.c.cout + n
                          : ((size_t)b * a.c.cout + n) * hw + pix;
  const float conv5 = to_f32(from_f32<T>(__fadd_rn(acc, a.bias[n])));
  const float x = to_f32(static_cast<const T*>(a.res)[i]);
  static_cast<T*>(a.out)[i] =
      from_f32<T>(__fadd_rn(x, __fmul_rn(a.res_scale, conv5)));
}

// bf16: the tile of conv3x3_tile.cuh on the tensor cores, then the
// epilogue on the accumulator fragments.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
    conv3x3_bf16(ConvArgs a) {
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][NT][4];
  conv_tile_bf16<NT>(a.c, b, 0, y0, x0, acc);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + warp * 2 + mt;
    if (oy >= a.c.h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= a.c.w_img) continue;
      const size_t pix = (size_t)oy * a.c.w_img + ox;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;            // n + 1 < cout with n
        if (n >= a.c.cout) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (a.residual) {
          store_res<__nv_bfloat16>(a, b, n, pix, v0);
          store_res<__nv_bfloat16>(a, b, n + 1, pix, v1);
        } else {
          __nv_bfloat16* out =
              static_cast<__nv_bfloat16*>(a.out) +
              ((size_t)b * a.c.h * a.c.w_img + pix) * a.c.c_total + n;
          *reinterpret_cast<uint32_t*>(out) =
              pack_bf16(act_out<__nv_bfloat16>(a, n, v0),
                        act_out<__nv_bfloat16>(a, n + 1, v1));
        }
      }
    }
  }
}

// f32: scalar FMA, one output pixel and all N output channels per thread.
template <int NT>
__global__ void __launch_bounds__(kThreads) conv3x3_f32(ConvArgs a) {
  constexpr int N = 8 * NT;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;

  float acc[N];
  conv_tile_f32<NT>(a.c, b, 0, y0, x0, acc);

  const int oy = y0 + threadIdx.x / kTileW, ox = x0 + threadIdx.x % kTileW;
  if (oy >= a.c.h || ox >= a.c.w_img) return;
  const size_t pix = (size_t)oy * a.c.w_img + ox;
  float* out = static_cast<float*>(a.out) +
               ((size_t)b * a.c.h * a.c.w_img + pix) * a.c.c_total;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n >= a.c.cout) continue;
    if (a.residual)
      store_res<float>(a, b, n, pix, acc[n]);
    else
      out[n] = act_out<float>(a, n, acc[n]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const ConvArgs& a, int batch,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c.w_img + kTileW - 1) / kTileW,
                  (a.c.h + kTileH - 1) / kTileH, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(int is_bf16, const ConvArgs& a, int batch,
              cudaStream_t stream) {
  if (is_bf16)
    return launch(conv3x3_bf16<NT>, conv_tile_smem(true, 8 * NT), a, batch,
                  stream);
  return launch(conv3x3_f32<NT>, conv_tile_smem(false, 8 * NT), a, batch,
                stream);
}

}  // namespace

// One conv of the dense block.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
// The wrapper checks shapes, dtypes, alignment and contiguity; the
// widths are checked here too because they pick the template and the
// 16-byte copies.
extern "C" int dense_block_conv(int is_bf16, const void* in, int c_total,
                                int cin, const void* w, const void* bias,
                                int cout, void* out, const void* res,
                                int batch, int h, int w_img, float slope,
                                float res_scale, int residual, int nhwc,
                                void* stream) {
  if (cout < 8 || cout > 64 || cout % 8 || cin < 8 || cin % 8 ||
      c_total % 8 || cin > c_total || batch < 1 || batch > 65535 ||
      h < 1 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{{in, c_total, cin, w, cout, h, w_img},
             static_cast<const float*>(bias), out, res, slope, res_scale,
             residual, nhwc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 16) return launch_nt<2>(is_bf16, a, batch, s);
  if (cout <= 32) return launch_nt<4>(is_bf16, a, batch, s);
  return launch_nt<8>(is_bf16, a, batch, s);
}

extern "C" const char* dense_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
