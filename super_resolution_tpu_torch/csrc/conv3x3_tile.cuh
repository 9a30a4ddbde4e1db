// The float32 conv tile: the f32 paths of the forward kernels
// (dense_block.cu, conv3x3.cu) and of the backward's data gradient
// (dense_block_bwd.cu).  Every bf16 conv runs on the Hopper tile of
// conv3x3_wgmma.cuh.  The 3x3 SAME conv of one 16x16-pixel output tile as
// an implicit GEMM over a channels-last input, without an epilogue: M =
// pixels, N = up to 64 output channels starting at n0, K = 9 * input
// channels, in chunks of 16 channels.  Scalar FMA, so float32 stays IEEE
// float32 (no TF32); every load is a scalar, so no width or channel
// offset needs any alignment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;                    // output rows per block
constexpr int kTileW = 16;                    // output columns per block
constexpr int kPatchW = kTileW + 2;           // input patch with a 1-pixel halo
constexpr int kPatch = (kTileH + 2) * kPatchW;
constexpr int kThreads = 256;                 // 8 warps
constexpr int kChunkF = 16;                   // channels per K step

// What a conv tile reads: a channels-last (B, H, W, c_total) buffer of
// which channels [0, cin) are the conv's input, and weights packed as
// (9, cout, cin), tap = dy*3 + dx.
struct ConvIn {
  const void* in;
  int c_total;
  int cin;
  const void* w;
  int cout;
  int h, w_img;
};

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

// Bytes of dynamic shared memory a tile of N = 8 * NT output channels needs.
constexpr size_t conv_tile_smem(int N) {
  return (size_t)(kChunkF * kPatch + 9 * kChunkF * N) * sizeof(float);
}

// Scalar FMA, one output pixel (tile row tid / 16, column
// tid % 16) and the N output channels [n0, n0 + N) per thread.
template <int NT>
__device__ __forceinline__ void conv_tile_f32(const ConvIn& a, int b, int n0,
                                              int y0, int x0,
                                              float (&acc)[8 * NT]) {
  constexpr int N = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sx = reinterpret_cast<float*>(smem_raw);   // [kChunkF][kPatch]
  float* sw = sx + kChunkF * kPatch;                // [9][kChunkF][N]

  const int tid = threadIdx.x, ty = tid / kTileW, tx = tid % kTileW;
  const float* in = static_cast<const float*>(a.in) +
                    (size_t)b * a.h * a.w_img * a.c_total;
  const float* w = static_cast<const float*>(a.w);

#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += kChunkF) {
    // channel fastest: neighbouring threads read neighbouring channels
    for (int i = tid; i < kChunkF * kPatch; i += kThreads) {
      const int k = i % kChunkF, p = i / kChunkF;
      const int py = p / kPatchW, px = p - py * kPatchW;
      const int gy = y0 - 1 + py, gx = x0 - 1 + px, c = c0 + k;
      float v = 0.f;
      if (c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_img)
        v = in[((size_t)gy * a.w_img + gx) * a.c_total + c];
      sx[k * kPatch + p] = v;
    }
    for (int i = tid; i < 9 * kChunkF * N; i += kThreads) {
      const int n = n0 + i % N, k = (i / N) % kChunkF;
      const int tap = i / (N * kChunkF), c = c0 + k;
      float v = 0.f;
      if (n < a.cout && c < a.cin)
        v = w[((size_t)tap * a.cout + n) * a.cin + c];
      sw[i] = v;
    }
    __syncthreads();

    for (int k = 0; k < kChunkF; ++k) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const float xv = sx[k * kPatch + (ty + dy) * kPatchW + tx + dx];
        const float4* wp =
            reinterpret_cast<const float4*>(sw + (tap * kChunkF + k) * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 wv = wp[q];
          acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace
