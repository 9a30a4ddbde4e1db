// ESRGAN dense block on Hopper (sm_90a): one 3x3 SAME conv per launch,
// five launches per block, all reading and writing one feature buffer.
//
// Replaces the TPU kernels
//   super_resolution_tpu/ops/pallas/dense_block_cf.py:fused_dense_block_cf5
//   super_resolution_tpu/ops/pallas/dense_block_cf_ext.py:fused_dense_block_cf9
// (one function, one contract).  For k = 1..4
//   x_k = LReLU(conv3x3(cat(x, x_1..x_{k-1})) + b_k)
// and y = x + res_scale * conv5(cat(x, x_1..x_4)).  Numerics follow the
// Pallas kernels, not the per-conv lax path: every conv accumulates in
// f32, adds its f32 bias in f32, applies LeakyReLU for k < 5 and is
// rounded to x's dtype; conv5 is rounded to x's dtype BEFORE the f32
// residual, and y is rounded to x's dtype.
//
// Layout.  The wrapper (ops/dense_block.py) allocates one channels-last
// feature buffer (B, H, W, C + 4G) and copies the NCHW input x into
// channels [0, C).  Launch k reads the channel prefix [0, C + (k-1)G)
// and its epilogue writes the next channel slice, so the concat costs
// nothing; launch 5 writes y (NCHW, like x) and reads x for the
// residual.  Channels-last puts the channels of one pixel side by side,
// so a tile's input moves as 16-byte copies.  Weights are packed once
// per model as (9, cout, cin): tap-major (tap = dy*3 + dx), then output
// channel, then input channel.
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

struct ConvArgs {
  const void* in;          // (B, H, W, c_total) buffer; [0, cin) is read
  int c_total;
  int cin;
  const void* w;           // (9, cout, cin) in the compute dtype
  const float* bias;       // (cout,)
  int cout;
  void* out;               // convs 1-4: buffer + first output channel;
                           // conv5: y, (B, cout, H, W)
  const void* res;         // conv5: x, (B, cout, H, W); else unused
  int h, w_img;
  float slope, res_scale;
  int residual;            // 0: LReLU epilogue, 1: y = x + res_scale * conv
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

// convs 1-4: bias, LeakyReLU, rounding to T (the value stored)
template <typename T>
__device__ __forceinline__ T act_out(const ConvArgs& a, int n, float acc) {
  const float v = __fadd_rn(acc, a.bias[n]);
  return from_f32<T>(v >= 0.f ? v : __fmul_rn(a.slope, v));
}

// conv5: bias, rounding to T, then the f32 residual with x, rounded to T;
// y and x are NCHW
template <typename T>
__device__ __forceinline__ void store_res(const ConvArgs& a, int b, int n,
                                          size_t pix, float acc) {
  const size_t hw = (size_t)a.h * a.w_img;
  const size_t i = ((size_t)b * a.cout + n) * hw + pix;
  const float conv5 = to_f32(from_f32<T>(__fadd_rn(acc, a.bias[n])));
  const float x = to_f32(static_cast<const T*>(a.res)[i]);
  static_cast<T*>(a.out)[i] =
      from_f32<T>(__fadd_rn(x, __fmul_rn(a.res_scale, conv5)));
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

// Start the copies of one K chunk (channels [c0, c0 + 32)) into a stage:
// the 18x18 input patch, zero outside the image (SAME padding) and past
// cin, and the 9 x N weight rows, zero past cout and cin.  cin and cout
// are multiples of 8, so every 16-byte piece is all in or all out.
template <int N>
__device__ __forceinline__ void load_chunk_bf16(
    const ConvArgs& a, const __nv_bfloat16* in, const __nv_bfloat16* w,
    uint32_t* sx, uint32_t* sw, int c0, int y0, int x0, int tid) {
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
    const int n = row % N, tap = row / N, c = c0 + 8 * j;
    const bool ok = n < a.cout && c < a.cin;
    const __nv_bfloat16* src =
        ok ? w + ((size_t)tap * a.cout + n) * a.cin + c : w;
    cp_async16(sw + row * kRowWords + 4 * j, src, ok);
  }
}

// bf16: implicit GEMM on the tensor cores.  NT = number of 8-wide
// output-channel tiles (cout padded up to 8*NT with zero weights).
// Warp w owns tile rows 2w and 2w+1: two m16 tiles of 16 pixels each.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
    conv3x3_bf16(ConvArgs a) {
  constexpr int N = 8 * NT;
  constexpr int kStage = (kPatch + 9 * N) * kRowWords;   // words
  extern __shared__ __align__(16) uint32_t smem[];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(a.in) +
                            (size_t)b * a.h * a.w_img * a.c_total;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  const int n_chunks = (a.cin + kChunkB - 1) / kChunkB;
  load_chunk_bf16<N>(a, in, w, smem, smem + kPatch * kRowWords, 0, y0, x0,
                     tid);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      uint32_t* nxt = smem + ((ch + 1) & 1) * kStage;
      load_chunk_bf16<N>(a, in, w, nxt, nxt + kPatch * kRowWords,
                         (ch + 1) * kChunkB, y0, x0, tid);
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

  // accumulator fragment: r = 0,1 -> pixel g, r = 2,3 -> pixel g + 8;
  // output channels nt*8 + 2t + (r & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + warp * 2 + mt;
    if (oy >= a.h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= a.w_img) continue;
      const size_t pix = (size_t)oy * a.w_img + ox;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;            // n + 1 < cout with n
        if (n >= a.cout) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if (a.residual) {
          store_res<__nv_bfloat16>(a, b, n, pix, v0);
          store_res<__nv_bfloat16>(a, b, n + 1, pix, v1);
        } else {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                               ((size_t)b * a.h * a.w_img + pix) * a.c_total +
                               n;
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
  extern __shared__ __align__(16) float smemf[];
  float* sx = smemf;                        // [kChunkF][kPatch]
  float* sw = smemf + kChunkF * kPatch;     // [9][kChunkF][N]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, ty = tid / kTileW, tx = tid % kTileW;
  const float* in = static_cast<const float*>(a.in) +
                    (size_t)b * a.h * a.w_img * a.c_total;
  const float* w = static_cast<const float*>(a.w);

  float acc[N];
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
      const int n = i % N, k = (i / N) % kChunkF, tap = i / (N * kChunkF);
      const int c = c0 + k;
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

  const int oy = y0 + ty, ox = x0 + tx;
  if (oy >= a.h || ox >= a.w_img) return;
  const size_t pix = (size_t)oy * a.w_img + ox;
  float* out = static_cast<float*>(a.out) +
               ((size_t)b * a.h * a.w_img + pix) * a.c_total;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n >= a.cout) continue;
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
  const dim3 grid((a.w_img + kTileW - 1) / kTileW,
                  (a.h + kTileH - 1) / kTileH, batch);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(int is_bf16, const ConvArgs& a, int batch,
              cudaStream_t stream) {
  constexpr int N = 8 * NT;
  if (is_bf16)
    return launch(conv3x3_bf16<NT>,
                  (size_t)2 * (kPatch + 9 * N) * kRowWords * sizeof(uint32_t),
                  a, batch, stream);
  return launch(conv3x3_f32<NT>,
                (size_t)(kChunkF * kPatch + 9 * kChunkF * N) * sizeof(float),
                a, batch, stream);
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
                                float res_scale, int residual,
                                void* stream) {
  if (cout < 8 || cout > 64 || cout % 8 || cin < 8 || cin % 8 ||
      c_total % 8 || cin > c_total || batch < 1 || batch > 65535 ||
      h < 1 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{in,   c_total, cin,   w,         static_cast<const float*>(bias),
             cout, out,     res,   h,         w_img,
             slope, res_scale, residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 16) return launch_nt<2>(is_bf16, a, batch, s);
  if (cout <= 32) return launch_nt<4>(is_bf16, a, batch, s);
  return launch_nt<8>(is_bf16, a, batch, s);
}

extern "C" const char* dense_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
