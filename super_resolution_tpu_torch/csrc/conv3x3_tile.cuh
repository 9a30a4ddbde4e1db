// The mma.sync / FMA conv tile, now serving only the backward's data
// gradient (dense_block_bwd.cu, bf16 and f32) and the f32 forward paths
// (dense_block.cu, conv3x3.cu); the bf16 forward runs on the Hopper tile
// of conv3x3_wgmma.cuh.  The 3x3 SAME conv of one 16x16-pixel output
// tile as an implicit GEMM over a channels-last input, without an
// epilogue.  M = pixels, N = up to 64 output channels starting at n0,
// K = 9 * input channels.
//
// bf16: mma.sync m16n8k16 with f32 accumulation; K in chunks of 32
// channels, the 18x18 input patch and the weight chunk brought into
// shared memory by cp.async two chunks deep, so the next chunk's copy
// overlaps this chunk's products.  Padded shared-memory rows keep the
// fragment loads free of bank conflicts.
// f32: scalar FMA in the same tiling, so float32 stays IEEE float32 (no
// TF32).

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
// bf16: K steps of 32 channels, held as 16 words (channel pairs) per
// pixel or weight row, plus 4 words of padding: 20 words = 80 bytes, a
// multiple of 16 for cp.async, and the 8 rows x 4 words of a fragment
// load fall on 32 different banks.
constexpr int kChunkB = 32;
constexpr int kRowWords = kChunkB / 2 + 4;
constexpr int kChunkF = 16;                   // f32: channels per K step

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; with ok false it writes 16 zero bytes
// and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);   // all but the newest group
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Bytes of dynamic shared memory a tile of N = 8 * NT output channels needs.
constexpr size_t conv_tile_smem(bool is_bf16, int N) {
  return is_bf16
             ? (size_t)2 * (kPatch + 9 * N) * kRowWords * sizeof(uint32_t)
             : (size_t)(kChunkF * kPatch + 9 * kChunkF * N) * sizeof(float);
}

// Start the copies of one K chunk (channels [c0, c0 + 32)) into a stage:
// the 18x18 input patch, zero outside the image (SAME padding) and past
// cin, and the 9 x N weight rows of output channels [n0, n0 + N), zero
// past cout and cin.  cin and cout are multiples of 8, so every 16-byte
// piece is all in or all out.
template <int N>
__device__ __forceinline__ void load_chunk_bf16(
    const ConvIn& a, const __nv_bfloat16* in, const __nv_bfloat16* w,
    uint32_t* sx, uint32_t* sw, int c0, int n0, int y0, int x0, int tid) {
  for (int i = tid; i < kPatch * 4; i += kThreads) {
    const int p = i >> 2, j = i & 3;
    const int py = p / kPatchW, px = p - py * kPatchW;
    const int gy = y0 - 1 + py, gx = x0 - 1 + px, c = c0 + 8 * j;
    const bool ok = c < a.cin && gy >= 0 && gy < a.h && gx >= 0 &&
                    gx < a.w_img;
    const __nv_bfloat16* src =
        ok ? in + ((size_t)gy * a.w_img + gx) * a.c_total + c : in;
    cp_async16(sx + p * kRowWords + 4 * j, src, ok);
  }
  for (int i = tid; i < 9 * N * 4; i += kThreads) {
    const int row = i >> 2, j = i & 3;
    const int n = n0 + row % N, tap = row / N, c = c0 + 8 * j;
    const bool ok = n < a.cout && c < a.cin;
    const __nv_bfloat16* src =
        ok ? w + ((size_t)tap * a.cout + n) * a.cin + c : w;
    cp_async16(sw + row * kRowWords + 4 * j, src, ok);
  }
}

// bf16 tile on the tensor cores.  NT = number of 8-wide output-channel
// tiles (channels past cout have zero weights).  Warp w owns tile rows 2w
// and 2w+1: two m16 tiles of 16 pixels each.  On return acc[mt][nt][r]
// holds, for tile row 2*warp + mt: r = 0,1 -> pixel column g, r = 2,3 ->
// column g + 8; output channel n0 + nt*8 + 2t + (r & 1), with
// g = lane >> 2, t = lane & 3.
template <int NT>
__device__ __forceinline__ void conv_tile_bf16(const ConvIn& a, int b, int n0,
                                               int y0, int x0,
                                               float (&acc)[2][NT][4]) {
  constexpr int N = 8 * NT;
  constexpr int kStage = (kPatch + 9 * N) * kRowWords;   // words
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(a.in) +
                            (size_t)b * a.h * a.w_img * a.c_total;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  const int n_chunks = (a.cin + kChunkB - 1) / kChunkB;
  load_chunk_bf16<N>(a, in, w, smem, smem + kPatch * kRowWords, 0, n0, y0,
                     x0, tid);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      uint32_t* nxt = smem + ((ch + 1) & 1) * kStage;
      load_chunk_bf16<N>(a, in, w, nxt, nxt + kPatch * kRowWords,
                         (ch + 1) * kChunkB, n0, y0, x0, tid);
    }
    cp_async_commit();        // possibly empty: keeps the group count even
    cp_async_wait_prev();     // chunk ch has landed (this thread's copies)
    __syncthreads();          // ... and every other thread's

    const uint32_t* sx = smem + (ch & 1) * kStage;
    const uint32_t* sw = sx + kPatch * kRowWords;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < kChunkB / 16; ++ks) {
        const int kw = ks * 8;                   // word offset of this k16
        uint32_t bf[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* bp = sw + (tap * N + nt * 8 + g) * kRowWords + kw;
          bf[nt][0] = bp[t];
          bf[nt][1] = bp[t + 4];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A rows are the 16 pixels of one tile row, shifted by the tap
          const uint32_t* ap0 =
              sx + ((warp * 2 + mt + dy) * kPatchW + g + dx) * kRowWords + kw;
          const uint32_t* ap1 = ap0 + 8 * kRowWords;
          const uint32_t a0 = ap0[t], a1 = ap1[t];
          const uint32_t a2 = ap0[t + 4], a3 = ap1[t + 4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();          // the stage is free for chunk ch + 2
  }
}

// f32 tile: scalar FMA, one output pixel (tile row tid / 16, column
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
