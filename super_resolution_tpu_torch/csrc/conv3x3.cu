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
// bf16 input runs on the Hopper tile of conv3x3_wgmma.cuh: TMA loads
// into a ring of shared-memory stages, wgmma with A from registers, one
// persistent block per SM walking 16x16-pixel output tiles.  N is the
// whole cout up to 64 (conv_last's 3 channels: N = 8), the upconv's 256
// channels are two groups of 128.  The output is staged per warp in
// shared memory and written with 16-byte stores to the channel slice of
// a channels-last buffer; cout 3 stores element by element.  bf16 input
// comes by TMA, which needs 16-byte pixel strides and pointers: cin and
// the input channel stride are multiples of 8, and the wrapper
// (ops/conv3x3.py) pads conv_first's 3 input channels to 8 with zeros,
// which leaves the arithmetic unchanged.  f32 input runs a scalar-FMA
// tile (conv3x3_tile.cuh), IEEE float32 (no TF32), with a grid dimension
// over groups of 64 output channels.
//
// Bound.  The flagship tail conv, a 512x512 plane of 64 -> 64 channels
// for a batch of 8 in bf16, is 154.6 GFLOP (0.156 ms at 989 TFLOP/s)
// against 537 MB of input and output (0.160 ms at 3.35 TB/s): bound by
// operations and by bytes about equally.  The design keeps both near
// their floor: every multiply-add on wgmma, the 73.7 KB of weights
// loaded once per block (not once per tile), each input tile read once
// with a one-pixel halo for all 64 output channels, loads overlapping
// products through the ring, and each output written once, in its final
// dtype, with full 16-byte stores.  conv_first (8 x 128^2, 3 -> 64) is
// bound by its 16.8 MB output write: K is 9 x 16, not 9 x 32, and the
// stores are coalesced.  PERF.md has the times.

#include "conv3x3_tile.cuh"
#include "conv3x3_wgmma.cuh"

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
};

// bias, LeakyReLU and the one rounding, in f32
template <typename T>
__device__ __forceinline__ T epilogue(const Args& a, int n, float acc) {
  float v = __fadd_rn(acc, a.bias[n]);
  if (a.act) v = v >= 0.f ? v : __fmul_rn(a.slope, v);
  return from_f32<T>(v);
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
int launch_f32(Args a, int batch, cudaStream_t stream) {
  a.n_groups = (a.c.cout + 8 * NT - 1) / (8 * NT);
  if ((long long)batch * a.n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  return launch(single_conv3x3_f32<NT>, conv_tile_smem(8 * NT), a,
                batch, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    wgc::Conv c{in, c_in, cin, w, cout, static_cast<const float*>(bias),
                out, c_out, !out_bf16, act, slope, wgc::kStore, nullptr,
                0.f, batch, h, w_img};
    return out_bf16 ? wgc::launch<__nv_bfloat16, 128>(c, s)
                    : wgc::launch<float, 64>(c, s);
  }
  Args a{{in, c_in, cin, w, cout, h, w_img},
         static_cast<const float*>(bias), out, c_out, 1, act, slope};
  if (cout <= 8) return launch_f32<1>(a, batch, s);
  if (cout <= 32) return launch_f32<4>(a, batch, s);
  return launch_f32<8>(a, batch, s);
}

// The Hopper tile's plan for a bf16 conv of cin -> cout channels:
// plan[0..4] = N, K chunk, ring stages, weights resident (1/0), dynamic
// shared memory in bytes.  Returns 0, or cudaErrorInvalidValue where no
// plan fits.  For reports; the launch makes the same plan itself.
extern "C" int conv3x3_wgmma_plan(int cout, int cin, int out_bf16,
                                  int* plan) {
  if (cout < 1 || cin < 8) return (int)cudaErrorInvalidValue;
  // the widths conv3x3_launch instantiates
  const int n = wgc::pick_n(cout, out_bf16 ? 128 : 64);
  const uint32_t staging =
      wgc::kConsumerWarps * wgc::warp_stage_bytes(n, out_bf16 ? 2 : 4);
  wgc::Plan pl;
  if (!wgc::make_plan(n, 4 * wgc::m_blocks(n) + 2, cin, staging, &pl))
    return (int)cudaErrorInvalidValue;
  plan[0] = n;
  plan[1] = pl.kc;
  plan[2] = pl.stages;
  plan[3] = pl.resident;
  plan[4] = (int)pl.smem;
  return 0;
}

extern "C" const char* conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
