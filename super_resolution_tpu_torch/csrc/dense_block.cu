// ESRGAN dense block on Hopper (sm_90a): one 3x3 SAME conv per launch,
// one launch per conv of the block, all reading and writing one feature
// buffer.
//
// Replaces the TPU kernels
//   super_resolution_tpu/ops/pallas/dense_block_cf.py:fused_dense_block_cf5
//   super_resolution_tpu/ops/pallas/dense_block_cf_ext.py:fused_dense_block_cf9
// (one function, one contract), and with x and y channels-last
//   super_resolution_tpu/ops/pallas/dense_block.py:fused_dense_block
// (the same function behind an NHWC contract).  With n convs (any n >= 1,
// five in ESRGAN), for k = 1..n-1
//   x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) + b_k)
// and y = x + res_scale * conv_n(cat(x, x_1..x_{n-1})).  Numerics follow
// the Pallas kernels, not the per-conv lax path: every conv accumulates
// in f32, adds its f32 bias in f32, applies LeakyReLU for k < n and is
// rounded to x's dtype; conv_n is rounded to x's dtype BEFORE the f32
// residual, and y is rounded to x's dtype.
//
// Layout.  The wrapper (ops/dense_block.py) allocates one channels-last
// feature buffer (B, H, W, C + (n-1)G) per call and copies the input x
// into channels [0, C) (from NCHW a transpose, from NHWC a strided copy).
// Launch k reads the channel prefix [0, C + (k-1)G) and its epilogue
// writes the next channel slice, so the concat costs nothing; the last
// launch writes y in x's layout (NCHW, or NHWC with the nhwc flag) and
// reads x for the residual.  (A bf16 model's RRDB trunk launches its
// convs 1..n-1 here too, but on three buffers shared along the trunk and
// with conv n from dense_block_chain.cu: one copy of its input in all.)
// In bf16 every slice
// starts on a 16-byte boundary: the wrapper pads C and G to multiples of
// 8 inside the buffer (zero input channels, zero weights and biases on
// the padded outputs, which LeakyReLU leaves 0); the public shapes stay
// unpadded.  Channels-last puts the channels of one pixel side by side,
// so a tile's input moves as 16-byte copies.  Weights are packed once
// per model as (9, cout, cin): tap-major (tap = dy*3 + dx), then output
// channel, then input channel.
//
// bf16 runs on the Hopper tile of conv3x3_wgmma.cuh: TMA loads into a
// ring of shared-memory stages, wgmma with A from registers, one
// persistent block per SM walking 16x16-pixel output tiles, all output
// channels of a conv in one block up to 64 (N = 32 for convs 1-4, 64 for
// conv5 in ESRGAN), wider outputs in groups of 64.
// The input tensor map stops at cin, so conv k reads nothing at or past
// the slice it writes.  The epilogue stages each warp's 16 pixels in
// shared memory and writes convs 1-4 as 16-byte pieces of their slice
// (the pixel stride is c_total), and conv5's y as 16-byte runs of 8
// pixels of one channel (NCHW) or of 8 channels of one pixel (NHWC),
// reading x for the residual the same way.
//
// Bound.  At the flagship shape (8, 64, 128, 128) bf16 one block is
// 62.8 GFLOP against 34.0 MB of input, weights and output: ~63.5 us of
// tensor-core time at 989 TFLOP/s against ~10 us of memory time at
// 3.35 TB/s, so it is bound by operations.  What the design does about
// it: every multiply-add on wgmma, fed by TMA with no load instructions
// in the consumer warps; convs 1-4 keep their weights (36.9-92.2 KB) in
// shared memory for the whole launch, so each tile moves only its input
// patch; conv5's 221 KB of weights fit in no block and come 32 input
// channels at a time with each stage of the ring, three stages deep.
// One launch per conv, so the growing buffer is re-read per conv (from
// L2 at this size); programmatic dependent launch overlaps each launch's
// start with the previous one's end (conv3x3_wgmma.cuh).  A block in one
// launch is not built: ROADMAP.md lists it among the kernel's
// candidates, and PERF.md has the times.
//
// The f32 path (used when the model runs in float32) is the scalar-FMA
// tile of conv3x3_tile.cuh, so float32 stays IEEE float32 (no TF32).

#include "conv3x3_tile.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

struct ConvArgs {
  ConvIn c;                // buffer, weights (9, cout, cin), geometry
  const float* bias;       // (cout,)
  void* out;               // convs 1..n-1: buffer + first output channel;
                           // conv n: y, (B, cout, H, W) or (B, H, W, cout)
  const void* res;         // conv n: x, laid out like y; else unused
  float slope, res_scale;
  int residual;            // 0: LReLU epilogue, 1: y = x + res_scale * conv
  int nhwc;                // conv n: x and y are NHWC (else NCHW)
  int n_groups;            // f32: blocks along the output channels
};

// convs 1..n-1: bias, LeakyReLU, rounding to T (the value stored)
template <typename T>
__device__ __forceinline__ T act_out(const ConvArgs& a, int n, float acc) {
  const float v = __fadd_rn(acc, a.bias[n]);
  return from_f32<T>(v >= 0.f ? v : __fmul_rn(a.slope, v));
}

// conv n: bias, rounding to T, then the f32 residual with x, rounded to T;
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

// f32: scalar FMA, one output pixel and the N output channels from n0
// per thread.
template <int NT>
__global__ void __launch_bounds__(kThreads) conv3x3_f32(ConvArgs a) {
  constexpr int N = 8 * NT;
  const int b = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * N;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;

  float acc[N];
  conv_tile_f32<NT>(a.c, b, n0, y0, x0, acc);

  const int oy = y0 + threadIdx.x / kTileW, ox = x0 + threadIdx.x % kTileW;
  if (oy >= a.c.h || ox >= a.c.w_img) return;
  const size_t pix = (size_t)oy * a.c.w_img + ox;
  float* out = static_cast<float*>(a.out) +
               ((size_t)b * a.c.h * a.c.w_img + pix) * a.c.c_total;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n0 + n >= a.c.cout) continue;
    if (a.residual)
      store_res<float>(a, b, n0 + n, pix, acc[n]);
    else
      out[n0 + n] = act_out<float>(a, n0 + n, acc[n]);
  }
}

template <int NT>
int launch_f32(ConvArgs a, int batch, cudaStream_t stream) {
  auto kernel = conv3x3_f32<NT>;
  const size_t smem = conv_tile_smem(8 * NT);
  a.n_groups = (a.c.cout + 8 * NT - 1) / (8 * NT);
  if ((long long)batch * a.n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c.w_img + kTileW - 1) / kTileW,
                  (a.c.h + kTileH - 1) / kTileH, batch * a.n_groups);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One conv of the dense block.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
// The wrapper checks shapes, dtypes, alignment and contiguity; what picks
// the template or the 16-byte copies is checked here too (bf16 input
// channels and pixel strides in multiples of 8, in wgc::launch).
extern "C" int dense_block_conv(int is_bf16, const void* in, int c_total,
                                int cin, const void* w, const void* bias,
                                int cout, void* out, const void* res,
                                int batch, int h, int w_img, float slope,
                                float res_scale, int residual, int nhwc,
                                void* stream) {
  if (cout < 1 || cin < 1 || cin > c_total || batch < 1 ||
      batch > 65535 || h < 1 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{{in, c_total, cin, w, cout, h, w_img},
             static_cast<const float*>(bias), out, res, slope, res_scale,
             residual, nhwc, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int mode = !residual ? wgc::kStore
                     : nhwc    ? wgc::kResidualNHWC
                               : wgc::kResidualNCHW;
    wgc::Conv c{in, c_total, cin, w, cout, static_cast<const float*>(bias),
                out, residual ? cout : c_total, 0, !residual, slope, mode,
                res, res_scale, batch, h, w_img};
    return wgc::launch<__nv_bfloat16, 64>(c, s);
  }
  if (cout <= 16) return launch_f32<2>(a, batch, s);
  if (cout <= 32) return launch_f32<4>(a, batch, s);
  return launch_f32<8>(a, batch, s);
}

extern "C" const char* dense_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
