// ESRGAN dense block with dynamic int8 quantization on Hopper (sm_90a):
// per conv, one amax launch and one int8 tensor-core conv launch.
//
// Replaces the TPU kernel
//   super_resolution_tpu/ops/pallas/experiments_dense_block.py:
//   fused_dense_block_cf8 (v8, _kernel8)
// and computes exactly what it computes.  With n convs (any n >= 1; the
// halo is n rows), the image is cut into bands of `rows` rows; band i
// reads image rows [i*rows - n, i*rows + rows + n) (zero rows outside the
// image) and recomputes its halo rows itself.  For conv k (0-based) of
// band i:
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
// Every f32 step is an explicit intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, and the one __fmaf_rn), so nvcc contracts nothing on its
// own.  The FMA and the constant 1/127 are what XLA makes of the JAX
// kernel's `left + mid` and `/ 127.0` (checked against the interpreted
// kernel on the CPU); with them the float32 values are the JAX kernel's.
// The weights are quantized by the wrapper (ops/experiments_dense_block.py):
// per row dx*F + f of the (3F, 3C) packing, scale s_w = max(max|row|,
// 1e-12) / 127, given here as int8 (3 dy, 3 dx, F, C_pad), channels
// zero-padded to a multiple of 32, and the (3F) float scales.
//
// Layout.  The wrapper fills a banded channels-last buffer (B * n_bands,
// rows + 2n, W, C + (n-1)G) with x in channels [0, C); conv k reads the
// channel prefix [0, C + kG) of its window and writes rows [k + 1, rows +
// 2n - 1 - k) of the next channel slice; the last conv writes y (NCHW).
// Bands never share a row: a halo row has another value in each band that
// computes it, which is why the result depends on `rows`.  Channels come
// in 8-channel pieces: the wrapper pads C and G to multiples of 8 inside
// the buffer and the weights with zeros, which leaves every amax, every
// weight scale and every int32 sum as it was.  Outputs wider than 64
// channels take several blocks (grid z).
//
// Bound.  At (8, 64, 128, 128) bf16, rows 16, the block's work with the
// band recompute is sum_k out_rows_k * cin_k * cout_k * 9 * 2 * W * B *
// n_bands = 71.9 GOP: 0.036 ms at 1,979 TOP/s (int8 dense), against
// 33.6 MB of x and y, 0.010 ms at 3.35 TB/s -- bound by operations.
// What this design does about it: every multiply-add runs on the int8
// tensor cores (mma.sync m16n8k32, s8 x s8 -> s32), an implicit GEMM with
// M = 16 pixels of one output row per warp, N = 3 * cout (one accumulator
// set per dx, since each dx is dequantized with its own scale), K = 32
// channels of one dy tap row per step.  The input tile is quantized once
// into shared memory as it is staged (8 output rows x 16 columns per
// block, a one-pixel halo), padded to 48-byte pixel rows so the fragment
// loads hit 32 different banks.  It is a first kernel: single-buffered
// staging, no wgmma or TMA, and the amax is a separate pass (it cannot be
// carried from the previous conv: the window shrinks by a row on each
// side).  PERF.md has its times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;                     // output rows per block
constexpr int kTileW = 16;                    // output columns per block
constexpr int kPatchW = kTileW + 2;
constexpr int kPatch = (kTileH + 2) * kPatchW;
constexpr int kThreads = 256;                 // 8 warps, one output row each
constexpr int kChunk = 32;                    // channels per K step
constexpr int kRowWords = 12;                 // 32 int8 + 16 bytes padding
constexpr float kRecip127 = 1.0f / 127.0f;    // XLA's fold of x / 127.0

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

// eight consecutive channels as f32 (16-byte aligned)
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

// clip(rint(v * inv), -127, 127) of eight values, packed as int8 with the
// lower channel in the lower byte
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(v[i], inv)), -127.f), 127.f);
    w[i >> 2] |= ((uint32_t)(int)q & 0xffu) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The amax of conv k's input window of each band: grid (splits, B *
// n_bands); per band the max |v| over rows [k, band_rows - k), all W
// columns and channels [0, cin), as the bits of a non-negative float
// (whose order is the order of the unsigned ints) max-ed into amax[band].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    amax_kernel(const T* buf, int c_total, int cin, int k, int band_rows,
                int w_img, unsigned* amax) {
  const int bb = blockIdx.y;
  const int groups = cin / 8;
  const long n = (long)(band_rows - 2 * k) * w_img * groups;
  const T* base = buf + ((size_t)bb * band_rows + k) * w_img * c_total;
  float m = 0.f;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kThreads) {
    const long pix = i / groups;
    const int j = (int)(i - pix * groups);
    float v[8];
    load8(base + pix * c_total + 8 * j, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) m = fmaxf(m, fabsf(v[q]));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(amax + bb, __float_as_uint(m));
  }
}

struct Int8Conv {
  void* buf;               // (B * n_bands, band_rows, W, c_total)
  int c_total, cin, k;     // the input is channels [0, cin); conv index k
  int halo;                // rows a band reads above and below: n convs
  const int8_t* wq;        // (3 dy, 3 dx, cout, cpad)
  int cpad;
  const float* sw;         // (3 * cout): the scale of row dx * cout + n
  const float* bias;       // (cout)
  int cout;
  void* y;                 // the last conv: y, NCHW
  const void* x;           // the last conv: x, NCHW (the residual)
  int n_bands, rows, h, w_img;
  float slope, res_scale;
  int last;
  const unsigned* amax;    // (B * n_bands) float bits
  int n_groups;            // blocks along the output channels
};

// One conv of the int8 block: grid (W / 16, out_rows / 8, B * n_bands *
// n_groups), output channels [n0, n0 + N) a block.
// NT = 8-wide output-channel tiles (channels past cout have zero weights).
// Warp w owns output row y0 + w: one m16 tile of 16 pixels.  acc[dx][nt][r]:
// r = 0, 1 -> pixel column g, r = 2, 3 -> column g + 8; output channel
// n0 + nt * 8 + 2t + (r & 1), with g = lane >> 2, t = lane & 3.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) conv_int8(Int8Conv a) {
  constexpr int N = 8 * NT;
  __shared__ __align__(16) uint32_t sx[kPatch * kRowWords];
  __shared__ __align__(16) uint32_t sw[9 * N * kRowWords];

  const int bb = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * N;
  const int band = bb % a.n_bands, b = bb / a.n_bands;
  const int band_rows = a.rows + 2 * a.halo;
  const int out_rows = band_rows - 2 * a.k - 2;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const float s_x =
      __fmul_rn(fmaxf(__uint_as_float(a.amax[bb]), 1e-6f), kRecip127);
  const float inv = __fdiv_rn(1.0f, s_x);
  const T* in = static_cast<const T*>(a.buf) +
                (size_t)bb * band_rows * a.w_img * a.c_total;

  int acc[3][NT][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[dx][nt][r] = 0;

  for (int c0 = 0; c0 < a.cin; c0 += kChunk) {
    // the input patch, quantized: window rows y0 .. y0 + 9 (band rows
    // k + y0 ..), columns x0 - 1 .. x0 + 16; zero outside the window, the
    // image columns and the channels
    for (int i = tid; i < kPatch * 4; i += kThreads) {
      const int p = i >> 2, j = i & 3;
      const int pr = p / kPatchW, pc = p - pr * kPatchW;
      const int ry = y0 + pr, gx = x0 - 1 + pc, c = c0 + 8 * j;
      uint2 q = make_uint2(0u, 0u);
      if (c < a.cin && ry < out_rows + 2 && gx >= 0 && gx < a.w_img) {
        float v[8];
        load8(in + ((size_t)(a.k + ry) * a.w_img + gx) * a.c_total + c, v);
        q = quantize8(v, inv);
      }
      *reinterpret_cast<uint2*>(sx + p * kRowWords + 2 * j) = q;
    }
    // the weights of this chunk: row tap * N + n, 32 channels
    for (int i = tid; i < 9 * N * 2; i += kThreads) {
      const int row = i >> 1, half = i & 1;
      const int tap = row / N, n = n0 + row - tap * N;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < a.cout)
        v = *reinterpret_cast<const uint4*>(
            a.wq + ((size_t)tap * a.cout + n) * a.cpad + c0 + 16 * half);
      *reinterpret_cast<uint4*>(sw + row * kRowWords + 4 * half) = v;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // A rows: pixels g and g + 8 of output row `warp`, shifted by the
        // tap; word t holds channels 4t..4t+3, word t + 4 channels 16 + 4t..
        const uint32_t* ap0 = sx + ((warp + dy) * kPatchW + g + dx) * kRowWords;
        const uint32_t* ap1 = ap0 + 8 * kRowWords;
        const uint32_t a0 = ap0[t], a1 = ap1[t];
        const uint32_t a2 = ap0[t + 4], a3 = ap1[t + 4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* bp =
              sw + ((dy * 3 + dx) * N + nt * 8 + g) * kRowWords;
          mma_s8(acc[dx][nt], a0, a1, a2, a3, bp[t], bp[t + 4]);
        }
      }
    }
    __syncthreads();          // the stage is free for the next chunk
  }

  const int oy = y0 + warp;
  if (oy >= out_rows) return;
  const int img_row = band * a.rows - (a.halo - a.k - 1) + oy;
  const bool in_img = img_row >= 0 && img_row < a.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ox = x0 + g + 8 * half;
    if (ox >= a.w_img) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = n0 + nt * 8 + 2 * t + e, r = 2 * half + e;
        if (ch >= a.cout) continue;
        const float left = __fmul_rn(__int2float_rn(acc[0][nt][r]),
                                     __fmul_rn(a.sw[ch], s_x));
        const float mid = __fmaf_rn(__int2float_rn(acc[1][nt][r]),
                                    __fmul_rn(a.sw[a.cout + ch], s_x), left);
        const float right = __fmul_rn(__int2float_rn(acc[2][nt][r]),
                                      __fmul_rn(a.sw[2 * a.cout + ch], s_x));
        float v = __fadd_rn(__fadd_rn(mid, right), a.bias[ch]);
        if (!a.last && !(v >= 0.f)) v = __fmul_rn(a.slope, v);
        const T o = from_f32<T>(in_img ? v : 0.f);
        if (a.last) {
          // y = x + res_scale * conv_n, NCHW, the image row of this band
          const size_t i =
              (((size_t)b * a.cout + ch) * a.h + img_row) * a.w_img + ox;
          const float xv = to_f32(static_cast<const T*>(a.x)[i]);
          static_cast<T*>(a.y)[i] = from_f32<T>(
              __fadd_rn(xv, __fmul_rn(a.res_scale, to_f32(o))));
        } else {
          static_cast<T*>(a.buf)[(((size_t)bb * band_rows + a.k + 1 + oy) *
                                      a.w_img + ox) * a.c_total + a.cin +
                                 ch] = o;
        }
      }
    }
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_nt(Int8Conv a, dim3 grid, cudaStream_t s) {
  const int nt = a.cout <= 16 ? 2 : a.cout <= 32 ? 4 : 8;
  a.n_groups = (a.cout + 8 * nt - 1) / (8 * nt);
  if ((long long)grid.z * a.n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  grid.z *= a.n_groups;
  if (nt == 2) return launch(conv_int8<T, 2>, grid, s, a);
  if (nt == 4) return launch(conv_int8<T, 4>, grid, s, a);
  return launch(conv_int8<T, 8>, grid, s, a);
}

}  // namespace

// The amax of conv k's window in every band into amax (B * n_bands
// unsigned ints, zeroed by the wrapper).  Returns cudaGetLastError().
extern "C" int dense_block_int8_amax(int is_bf16, const void* buf,
                                     int c_total, int cin, int k, int halo,
                                     int rows, int n_bb, int w_img,
                                     void* amax, void* stream) {
  if (cin < 8 || cin % 8 || c_total % 8 || cin > c_total || k < 0 ||
      k >= halo || rows < 5 || n_bb < 1 || n_bb > 65535 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  const int band_rows = rows + 2 * halo;
  const long chunks = (long)(band_rows - 2 * k) * w_img * (cin / 8);
  long splits = chunks / (kThreads * 16);
  splits = splits < 1 ? 1 : splits > 128 ? 128 : splits;
  const dim3 grid((unsigned)splits, n_bb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* out = static_cast<unsigned*>(amax);
  if (is_bf16)
    return launch(amax_kernel<__nv_bfloat16>, grid, s,
                  static_cast<const __nv_bfloat16*>(buf), c_total, cin, k,
                  band_rows, w_img, out);
  return launch(amax_kernel<float>, grid, s, static_cast<const float*>(buf),
                c_total, cin, k, band_rows, w_img, out);
}

// Conv k of the int8 block (see the note above).  The wrapper checks
// shapes, dtypes and contiguity; the widths are checked here too because
// they pick the template and the 8-channel copies.
extern "C" int dense_block_int8_conv(
    int is_bf16, void* buf, int c_total, int cin, int k, int halo,
    const void* wq, int cpad, const void* sw, const void* bias, int cout,
    void* y, const void* x, int batch, int n_bands, int rows, int h,
    int w_img, float slope, float res_scale, int last, const void* amax,
    void* stream) {
  if (cout < 1 || cin < 8 || cin % 8 || c_total % 8 ||
      cin + (last ? 0 : cout) > c_total || cpad < cin || cpad % kChunk ||
      k < 0 || k >= halo || rows < 5 || n_bands * rows != h || batch < 1 ||
      (long)batch * n_bands > 65535 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  Int8Conv a{buf, c_total, cin, k, halo, static_cast<const int8_t*>(wq),
             cpad, static_cast<const float*>(sw),
             static_cast<const float*>(bias), cout, y, x, n_bands, rows, h,
             w_img, slope, res_scale, last,
             static_cast<const unsigned*>(amax), 1};
  const int out_rows = rows + 2 * halo - 2 * k - 2;
  const dim3 grid((w_img + kTileW - 1) / kTileW,
                  (out_rows + kTileH - 1) / kTileH, batch * n_bands);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? conv_nt<__nv_bfloat16>(a, grid, s)
                 : conv_nt<float>(a, grid, s);
}

extern "C" const char* dense_block_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
