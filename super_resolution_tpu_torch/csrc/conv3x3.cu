// One 3x3 SAME conv on Hopper (sm_90a), channels-last in and out.
//
// Replaces the TPU kernels
//   super_resolution_tpu/ops/pallas/conv_cf.py:conv3x3_cf_fwd     (NCHW)
//   super_resolution_tpu/ops/pallas/packed_conv.py:packed_conv3x3  (NHWC)
// which compute one function in two layouts:
//   y = conv3x3(x) + b, optionally LeakyReLU,
// accumulated in f32, the f32 bias added in f32, the LeakyReLU taken in
// f32, and one rounding to the output dtype, at the point where both
// TPU kernels round (conv_cf.py:59-62, packed_conv.py:63-66).
//
// Layout.  x is a channels-last (B, H, W, c_in) buffer of which channels
// [0, cin) are the conv's input, and y goes to channels [0, cout) of a
// channels-last buffer of c_out channels per pixel (the pointer may
// start at a channel offset).  So one conv of a dense block reads the
// channel prefix of a feature buffer and writes its own slice of it, and
// an NCHW tensor in torch.channels_last memory format is read and
// written as it lies.  Weights are packed (9, cout, cin), tap-major
// (tap = dy*3 + dx), as for the dense-block kernels.
//
// The tile is the implicit GEMM of conv3x3_tile.cuh (M = a 16x16-pixel
// output tile, N = up to 64 output channels from n0, K = 9 * cin): bf16
// on the tensor cores (mma.sync m16n8k16, f32 accumulate, cp.async two K
// chunks deep); f32 as scalar FMA, IEEE float32 (no TF32).  Output
// channels past 64 (the pixel-shuffle upconv has 4 * 64 = 256) take a
// grid dimension over n0.  An odd cout (conv_last: 3) or an odd output
// channel stride stores channels one by one; otherwise bf16 channel
// pairs go out as one 32-bit word.  bf16 input channels come in 16-byte
// pieces, so cin, the input channel stride and the pointers must be
// multiples of 8 channels / 16 bytes: the wrapper (ops/conv3x3.py) pads
// conv_first's 3 input channels to 8 with zeros, which leaves the
// arithmetic unchanged.
//
// Bound.  The flagship tail conv, a 512x512 plane of 64 -> 64 channels
// for a batch of 8 in bf16, is 154.6 GFLOP (0.156 ms at 989 TFLOP/s)
// against 537 MB of input and output (0.160 ms at 3.35 TB/s): bound by
// operations and by bytes about equally, unlike the dense block.  What
// this design does about it: each block reads its input tile once, with
// a one-pixel halo (18x18 for 16x16 outputs, the halo's re-reads mostly
// from L2), every multiply-add runs on the tensor cores, and the
// epilogue writes each output once, in its final dtype, straight from
// the accumulators -- bias, activation and rounding cost no extra pass
// over memory.  Still a first kernel: mma.sync reaches part of the wgmma
// rate, each block re-reads the weights from L2, and cin = 64 gives only
// two K chunks to overlap copies with products.  PERF.md has its times.

#include "conv3x3_tile.cuh"

namespace {

struct Args {
  ConvIn c;             // input buffer (c_total = input channel stride),
                        // weights (9, cout, cin), geometry
  const float* bias;    // (cout,)
  void* out;            // output channel 0 of pixel (0, 0, 0)
  int c_out;            // output channel stride
  int n_groups;         // blocks along the output channels
  int act;              // 1: LeakyReLU with slope
  float slope;
  int pair_store;       // bf16 out: a channel pair is one aligned word
};

// bias, LeakyReLU and the one rounding, in f32
template <typename T>
__device__ __forceinline__ T epilogue(const Args& a, int n, float acc) {
  float v = __fadd_rn(acc, a.bias[n]);
  if (a.act) v = v >= 0.f ? v : __fmul_rn(a.slope, v);
  return from_f32<T>(v);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 v0,
                                           __nv_bfloat16 v1, int pair) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  } else {
    p[0] = v0;
    p[1] = v1;
  }
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           int) {
  p[0] = v0;
  p[1] = v1;
}

// bf16 in, Tout out: the tile on the tensor cores, then the epilogue on
// the accumulator fragments (layout in conv3x3_tile.cuh).
template <int NT, typename Tout>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
    single_conv3x3_bf16(Args a) {
  const int b = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * 8 * NT;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][NT][4];
  conv_tile_bf16<NT>(a.c, b, n0, y0, x0, acc);

  Tout* out = static_cast<Tout*>(a.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + warp * 2 + mt;
    if (oy >= a.c.h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= a.c.w_img) continue;
      Tout* row = out + (((size_t)b * a.c.h + oy) * a.c.w_img + ox) *
                            (size_t)a.c_out;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + nt * 8 + 2 * t;       // even
        if (n >= a.c.cout) continue;
        const Tout v0 = epilogue<Tout>(a, n, acc[mt][nt][2 * half]);
        if (n + 1 >= a.c.cout) {
          row[n] = v0;
          continue;
        }
        store_pair(row + n, v0,
                   epilogue<Tout>(a, n + 1, acc[mt][nt][2 * half + 1]),
                   a.pair_store);
      }
    }
  }
}

// f32: scalar FMA, one output pixel and the N output channels from n0
// per thread.
template <int NT>
__global__ void __launch_bounds__(kThreads) single_conv3x3_f32(Args a) {
  constexpr int N = 8 * NT;
  const int b = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * N;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;

  float acc[N];
  conv_tile_f32<NT>(a.c, b, n0, y0, x0, acc);

  const int oy = y0 + threadIdx.x / kTileW, ox = x0 + threadIdx.x % kTileW;
  if (oy >= a.c.h || ox >= a.c.w_img) return;
  float* row = static_cast<float*>(a.out) +
               (((size_t)b * a.c.h + oy) * a.c.w_img + ox) * (size_t)a.c_out;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n0 + n >= a.c.cout) continue;
    row[n0 + n] = epilogue<float>(a, n0 + n, acc[n]);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, int batch,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.c.w_img + kTileW - 1) / kTileW,
                  (a.c.h + kTileH - 1) / kTileH, batch * a.n_groups);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(int in_bf16, int out_bf16, Args a, int batch,
              cudaStream_t stream) {
  a.n_groups = (a.c.cout + 8 * NT - 1) / (8 * NT);
  if ((long long)batch * a.n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = conv_tile_smem(in_bf16 != 0, 8 * NT);
  if (!in_bf16) return launch(single_conv3x3_f32<NT>, smem, a, batch, stream);
  if (out_bf16)
    return launch(single_conv3x3_bf16<NT, __nv_bfloat16>, smem, a, batch,
                  stream);
  return launch(single_conv3x3_bf16<NT, float>, smem, a, batch, stream);
}

}  // namespace

// One conv.  Returns cudaGetLastError() after the launch (0 on success);
// the Python wrapper raises on anything else.  The wrapper checks shapes,
// dtypes, strides and devices; what picks the template or would make a
// copy unaligned is checked here too.  in_bf16 = 0 (float32 input) writes
// float32.
extern "C" int conv3x3_launch(int in_bf16, int out_bf16, const void* in,
                              int c_in, int cin, const void* w,
                              const void* bias, int cout, void* out,
                              int c_out, int act, float slope, int batch,
                              int h, int w_img, void* stream) {
  if (cin < 1 || cin > c_in || cout < 1 || cout > c_out || batch < 1 ||
      h < 1 || w_img < 1 || (!in_bf16 && out_bf16))
    return (int)cudaErrorInvalidValue;
  if (in_bf16 && (cin % 8 || c_in % 8 || (uintptr_t)in % 16 ||
                  (uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  Args a{{in, c_in, cin, w, cout, h, w_img},
         static_cast<const float*>(bias), out, c_out, 1, act, slope,
         out_bf16 && c_out % 2 == 0 && (uintptr_t)out % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 8) return launch_nt<1>(in_bf16, out_bf16, a, batch, s);
  if (cout <= 32) return launch_nt<4>(in_bf16, out_bf16, a, batch, s);
  return launch_nt<8>(in_bf16, out_bf16, a, batch, s);
}

extern "C" const char* conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
