// Backward of the ESRGAN dense block on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   super_resolution_tpu/ops/pallas/dense_block_cf_vjp.py:
//   fused_dense_block_cf5_bwd (body _kernel5_bwd)
// and keeps its numerics.  With feats = cat(x, x_1..x_4) saved by the
// forward, C_k = C + (k-1) G input channels of conv k, and g the
// cotangent of y:
//   dfeats (f32, all channels) = 0, dfeats[:C] = g
//   for k = 5..1:
//     dout_k = res_scale * g                      (k = 5)
//            = dfeats[x_k's slice] * leak(x_k)    (k < 5; leak is 1 where
//              the saved activation is > 0, slope where it is <= 0)
//     db_k   = sum over pixels of dout_k          (f32, unrounded)
//     dz_k   = dout_k rounded to x's dtype
//     dW_k   = sum over pixels of dz_k (x) feats[:C_k], per tap (f32)
//     dfeats[:C_k] += conv_transpose(dz_k, W_k)   (f32)
//   dx = dfeats[:C] rounded to x's dtype
// The TPU kernel's bands, halos, carries and lane caps served its VMEM
// and its sequential grid and are not carried over.
//
// Three kernels, launched per conv by ops/dense_block.py:
//
// dgrad3x3.  conv_transpose(dz_k, W_k) is a 3x3 SAME conv of dz_k with
// the flipped, transposed weights (9, C_k, cout_k), so it is the
// forward's implicit GEMM (conv3x3_tile.cuh) with another epilogue: each
// block adds its 16x16-pixel tile of up to 64 of the C_k channels into
// the channels-last f32 dfeats buffer.  Every (pixel, channel) belongs to
// one thread of one block, so the += needs no atomics.  After conv k the
// slice of x_{k-1} has received every contribution, so the same epilogue
// turns it into dout_{k-1} in place (times leak) and writes dz_{k-1}.
//
// wgrad3x3.  Per tap a (cout x pixels) . (pixels x C_k) product: K is the
// pixel axis.  Blocks are (range of 16x16-pixel tiles) x (chunk of 32
// input channels; 16 in f32); a block keeps all 9 x cout x chunk sums in
// registers while it walks its tiles, then writes them once to its slot
// of a workspace.  bf16 runs on the tensor cores (mma.sync m16n8k16,
// A = dz^T, B = the shifted feats patch, both packed from channels-last
// shared memory); f32 is scalar FMA.  The blocks of the first channel
// chunk also sum dout_k over their pixels for db_k.
//
// wgrad_reduce.  Sums the workspace slots in slot order into dW_k
// (9, cout, C_k) and db_k.  On the TPU the sequential grid accumulated
// into one output block; here blocks run in no order, so the partial sums
// meet in this second pass and a step repeats bit for bit (no atomics).
//
// Bound.  At the training shape (16, 64, 48, 48) bf16, growth 32, the
// backward is 35.3 GFLOP (twice the forward) against 25 MB of saved
// features, cotangent and weights in and dx, dW, db out: about 36 us of
// tensor-core time at 989 TFLOP/s against about 7.5 us of memory time at
// 3.35 TB/s, so it is bound by operations.  These are first kernels:
// mma.sync, single-buffered tiles in wgrad, 16-bit shared-memory loads to
// pack its fragments, and fifteen launches per block.  PERF.md has the
// measured times.

#include <type_traits>

#include "conv3x3_tile.cuh"

namespace {

struct DgradArgs {
  ConvIn c;            // in: dz_k (B, H, W, cout_k); w: flipped weights
                       // (9, C_k, cout_k); cout = C_k
  float* dfeats;       // (B, H, W, f_total) f32; channels [0, C_k) += conv
  const void* feats;   // (B, H, W, f_total) saved features
  int f_total;
  void* dz_prev;       // (B, H, W, C_k - act_lo): dz_{k-1}
  int act_lo;          // first channel of x_{k-1}'s slice; C_k for conv 1
  int n_groups;        // groups of 8 * NT output channels
  float slope;
};

// One element of the dgrad epilogue: dfeats += acc; in x_{k-1}'s slice
// the sum is final, so it becomes dout_{k-1} and dz_{k-1} is written.
template <typename T>
__device__ __forceinline__ void dgrad_store(const DgradArgs& a, size_t bp,
                                            int n, float acc) {
  float* df = a.dfeats + bp * a.f_total + n;
  float v = __fadd_rn(*df, acc);
  if (n >= a.act_lo) {
    const float act = to_f32(static_cast<const T*>(a.feats)[bp * a.f_total + n]);
    v = __fmul_rn(v, act > 0.f ? 1.f : a.slope);
    static_cast<T*>(a.dz_prev)[bp * (a.c.cout - a.act_lo) + n - a.act_lo] =
        from_f32<T>(v);
  }
  *df = v;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) dgrad3x3(DgradArgs a) {
  constexpr int N = 8 * NT;
  const int b = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * N;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const size_t img = (size_t)b * a.c.h * a.c.w_img;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[2][NT][4];
    conv_tile_bf16<NT>(a.c, b, n0, y0, x0, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int oy = y0 + warp * 2 + mt;
      if (oy >= a.c.h) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = x0 + g + 8 * half;
        if (ox >= a.c.w_img) continue;
        const size_t bp = img + (size_t)oy * a.c.w_img + ox;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + nt * 8 + 2 * t;     // n + 1 < C_k with n
          if (n >= a.c.cout) continue;
          dgrad_store<T>(a, bp, n, acc[mt][nt][2 * half]);
          dgrad_store<T>(a, bp, n + 1, acc[mt][nt][2 * half + 1]);
        }
      }
    }
  } else {
    float acc[N];
    conv_tile_f32<NT>(a.c, b, n0, y0, x0, acc);
    const int oy = y0 + threadIdx.x / kTileW, ox = x0 + threadIdx.x % kTileW;
    if (oy >= a.c.h || ox >= a.c.w_img) return;
    const size_t bp = img + (size_t)oy * a.c.w_img + ox;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n0 + n < a.c.cout) dgrad_store<T>(a, bp, n0 + n, acc[n]);
  }
}

struct WgradArgs {
  const void* dz;        // (B, H, W, cout): dout_k rounded to T
  const float* dout;     // dout_k in f32, dout_stride floats per pixel
  int dout_stride;
  const void* feats;     // (B, H, W, f_total); channels [0, cin) are read
  int f_total, cin, cout;
  float* partial;        // (n_parts, 9 * cout * cin + cout)
  int batch, h, w_img;
};

constexpr int kWgradCiB = 32;    // input channels per block, bf16
constexpr int kWgradCiF = 16;    // ... and f32

constexpr size_t wgrad_smem(bool is_bf16, int MT) {
  // dz tile, feats patch, db scratch
  return (is_bf16 ? (size_t)kTileH * kTileW * (16 * MT + 8) * 2 +
                        (size_t)kPatch * kRowWords * 4
                  : (size_t)kTileH * kTileW * 16 * MT * 4 +
                        (size_t)kPatch * kWgradCiF * 4) +
         4 * 64 * sizeof(float);
}

// Decode tile index -> image and tile origin.
__device__ __forceinline__ void tile_origin(const WgradArgs& a, int tile,
                                            int& b, int& y0, int& x0) {
  const int tx = (a.w_img + kTileW - 1) / kTileW;
  const int ty = (a.h + kTileH - 1) / kTileH;
  b = tile / (ty * tx);
  const int rem = tile - b * ty * tx;
  y0 = (rem / tx) * kTileH;
  x0 = (rem % tx) * kTileW;
}

// This thread's share of db over one tile: channel tid & 63, every fourth
// pixel starting at tid >> 6.
__device__ __forceinline__ float db_tile(const WgradArgs& a, int b, int y0,
                                         int x0) {
  const int co = threadIdx.x & 63;
  float s = 0.f;
  if (co >= a.cout) return s;
  for (int p = threadIdx.x >> 6; p < kTileH * kTileW; p += 4) {
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy < a.h && gx < a.w_img)
      s += a.dout[(((size_t)b * a.h + gy) * a.w_img + gx) * a.dout_stride + co];
  }
  return s;
}

// MT = number of 16-wide output-channel tiles (cout <= 16 * MT).
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) wgrad3x3(WgradArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kCo = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int n_tiles = a.batch * ((a.h + kTileH - 1) / kTileH) *
                      ((a.w_img + kTileW - 1) / kTileW);
  const int t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int n_w = 9 * a.cout * a.cin;
  float* part = a.partial + (size_t)blockIdx.x * (n_w + a.cout);
  const bool do_db = blockIdx.y == 0;
  float dbacc = 0.f;
  float* sdb;

  if constexpr (kBf16) {
    constexpr int ZR = kCo + 8;              // halfs per dz row (padded)
    constexpr int FR = 2 * kRowWords;        // halfs per feats row
    constexpr int MW = MT >= 2 ? MT / 2 : 1; // co tiles per warp
    unsigned short* zs = reinterpret_cast<unsigned short*>(smem_raw);
    unsigned short* fs = zs + kTileH * kTileW * ZR;
    sdb = reinterpret_cast<float*>(fs + kPatch * FR);
    const __nv_bfloat16* dz = static_cast<const __nv_bfloat16*>(a.dz);
    const __nv_bfloat16* feats = static_cast<const __nv_bfloat16*>(a.feats);
    const int ci0 = blockIdx.y * kWgradCiB;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int nt = warp & 3, mh = warp >> 2;   // ci tile, co half

    float acc[9][MW][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[tap][mi][r] = 0.f;

    for (int tile = t0; tile < t1; ++tile) {
      int b, y0, x0;
      tile_origin(a, tile, b, y0, x0);
      const size_t img = (size_t)b * a.h * a.w_img;
      __syncthreads();            // the previous tile's products are done
      for (int i = tid; i < kTileH * kTileW * (kCo / 8); i += kThreads) {
        const int p = i / (kCo / 8), j = i % (kCo / 8);
        const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
        const bool ok = 8 * j < a.cout && gy < a.h && gx < a.w_img;
        const __nv_bfloat16* src =
            ok ? dz + (img + (size_t)gy * a.w_img + gx) * a.cout + 8 * j : dz;
        cp_async16(zs + p * ZR + 8 * j, src, ok);
      }
      for (int i = tid; i < kPatch * 4; i += kThreads) {
        const int p = i >> 2, j = i & 3;
        const int gy = y0 - 1 + p / kPatchW, gx = x0 - 1 + p % kPatchW;
        const int c = ci0 + 8 * j;
        const bool ok = c < a.cin && gy >= 0 && gy < a.h && gx >= 0 &&
                        gx < a.w_img;
        const __nv_bfloat16* src =
            ok ? feats + (img + (size_t)gy * a.w_img + gx) * a.f_total + c
               : feats;
        cp_async16(fs + p * FR + 8 * j, src, ok);
      }
      cp_async_commit();
      if (do_db) dbacc += db_tile(a, b, y0, x0);
      cp_async_wait_all();
      __syncthreads();

      if (mh * MW < MT) {
        for (int r = 0; r < kTileH; ++r) {
          // A = dz^T: row = output channel, k = the 16 pixels of tile row r
          uint32_t af[MW][4];
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            const unsigned short* z =
                zs + (r * kTileW + 2 * t) * ZR + (mh * MW + mi) * 16 + g;
            af[mi][0] = (uint32_t)z[0] | ((uint32_t)z[ZR] << 16);
            af[mi][1] = (uint32_t)z[8] | ((uint32_t)z[ZR + 8] << 16);
            af[mi][2] = (uint32_t)z[8 * ZR] | ((uint32_t)z[9 * ZR] << 16);
            af[mi][3] =
                (uint32_t)z[8 * ZR + 8] | ((uint32_t)z[9 * ZR + 8] << 16);
          }
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            // B = the patch shifted by the tap: k = pixel, n = input channel
            const unsigned short* f =
                fs + ((r + dy) * kPatchW + 2 * t + dx) * FR + nt * 8 + g;
            const uint32_t b0 = (uint32_t)f[0] | ((uint32_t)f[FR] << 16);
            const uint32_t b1 =
                (uint32_t)f[8 * FR] | ((uint32_t)f[9 * FR] << 16);
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
              mma_bf16(acc[tap][mi], af[mi][0], af[mi][1], af[mi][2],
                       af[mi][3], b0, b1);
          }
        }
      }
    }

    // accumulator fragment: rows (co) g and g + 8, columns (ci) 2t, 2t + 1
    if (mh * MW < MT) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int co = (mh * MW + mi) * 16 + g + 8 * (r >> 1);
            const int ci = ci0 + nt * 8 + 2 * t + (r & 1);
            if (co < a.cout && ci < a.cin)
              part[((size_t)tap * a.cout + co) * a.cin + ci] =
                  acc[tap][mi][r];
          }
    }
  } else {
    // f32: thread = (input channel tid & 15, output channels (tid >> 4)
    // + 16 m), all 9 taps
    float* zs = reinterpret_cast<float*>(smem_raw);      // [256][kCo]
    float* fs = zs + kTileH * kTileW * kCo;              // [kPatch][16]
    sdb = fs + kPatch * kWgradCiF;
    const float* dz = static_cast<const float*>(a.dz);
    const float* feats = static_cast<const float*>(a.feats);
    const int ci0 = blockIdx.y * kWgradCiF;
    const int ci = tid & 15, col = tid >> 4;

    float acc[9][MT];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[tap][m] = 0.f;

    for (int tile = t0; tile < t1; ++tile) {
      int b, y0, x0;
      tile_origin(a, tile, b, y0, x0);
      const size_t img = (size_t)b * a.h * a.w_img;
      __syncthreads();
      for (int i = tid; i < kTileH * kTileW * kCo; i += kThreads) {
        const int p = i / kCo, c = i % kCo;
        const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
        zs[i] = (c < a.cout && gy < a.h && gx < a.w_img)
                    ? dz[(img + (size_t)gy * a.w_img + gx) * a.cout + c]
                    : 0.f;
      }
      for (int i = tid; i < kPatch * kWgradCiF; i += kThreads) {
        const int p = i / kWgradCiF, c = ci0 + i % kWgradCiF;
        const int gy = y0 - 1 + p / kPatchW, gx = x0 - 1 + p % kPatchW;
        fs[i] = (c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_img)
                    ? feats[(img + (size_t)gy * a.w_img + gx) * a.f_total + c]
                    : 0.f;
      }
      if (do_db) dbacc += db_tile(a, b, y0, x0);
      __syncthreads();

      for (int p = 0; p < kTileH * kTileW; ++p) {
        const int py = p / kTileW, px = p % kTileW;
        float zv[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) zv[m] = zs[p * kCo + col + 16 * m];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float f = fs[((py + tap / 3) * kPatchW + px + tap % 3) *
                                 kWgradCiF + ci];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[tap][m] = fmaf(zv[m], f, acc[tap][m]);
        }
      }
    }

#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int co = col + 16 * m;
        if (co < a.cout && ci0 + ci < a.cin)
          part[((size_t)tap * a.cout + co) * a.cin + ci0 + ci] = acc[tap][m];
      }
  }

  if (do_db) {
    // the four pixel shares of each channel, added in a fixed order
    sdb[tid] = dbacc;
    __syncthreads();
    if (tid < a.cout)
      part[n_w + tid] = (sdb[tid] + sdb[tid + 64]) +
                        (sdb[tid + 128] + sdb[tid + 192]);
  }
}

// dW and db from the workspace: slot after slot, so the sum has one order.
__global__ void wgrad_reduce(const float* partial, int n_parts, int n_w,
                             int cout, float* dw, float* db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_w + cout;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += partial[(size_t)p * n + i];
  if (i < n_w)
    dw[i] = s;
  else
    db[i - n_w] = s;
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, size_t smem, const Args& a, dim3 grid,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_dgrad(int is_bf16, DgradArgs a, int batch, cudaStream_t stream) {
  constexpr int N = 8 * NT;
  a.n_groups = (a.c.cout + N - 1) / N;
  if ((long long)batch * a.n_groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.c.w_img + kTileW - 1) / kTileW,
                  (a.c.h + kTileH - 1) / kTileH, batch * a.n_groups);
  if (is_bf16)
    return launch(dgrad3x3<__nv_bfloat16, NT>, conv_tile_smem(true, N), a,
                  grid, stream);
  return launch(dgrad3x3<float, NT>, conv_tile_smem(false, N), a, grid,
                stream);
}

template <int MT>
int launch_wgrad(int is_bf16, const WgradArgs& a, int n_parts,
                 cudaStream_t stream) {
  const int chunk = is_bf16 ? kWgradCiB : kWgradCiF;
  const dim3 grid(n_parts, (a.cin + chunk - 1) / chunk);
  if (is_bf16)
    return launch(wgrad3x3<__nv_bfloat16, MT>, wgrad_smem(true, MT), a, grid,
                  stream);
  return launch(wgrad3x3<float, MT>, wgrad_smem(false, MT), a, grid, stream);
}

bool bad_geometry(int batch, int h, int w_img) {
  return batch < 1 || h < 1 || w_img < 1 ||
         (long long)batch * ((h + kTileH - 1) / kTileH) *
                 ((w_img + kTileW - 1) / kTileW) > 0x7fffffffLL;
}

}  // namespace

// Each function returns cudaGetLastError() after its launch (0 on
// success); the Python wrapper raises on anything else.  It also checks
// shapes, dtypes, alignment and contiguity; the widths are checked here
// too because they pick the template and the 16-byte copies.

// Data gradient of conv k: dfeats[:, :c_k] += conv_transpose(dz, W_k),
// with wt = W_k flipped and transposed, (9, c_k, cout).  Channels
// [act_lo, c_k) are x_{k-1}'s slice: they leave as dout_{k-1}, and
// dz_prev (B, H, W, c_k - act_lo) receives them rounded.  act_lo == c_k
// for conv 1.
extern "C" int dense_block_dgrad(int is_bf16, const void* dz, int cout,
                                 const void* wt, int c_k, void* dfeats,
                                 const void* feats, int f_total,
                                 void* dz_prev, int act_lo, int batch, int h,
                                 int w_img, float slope, void* stream) {
  if (cout < 8 || cout > 64 || cout % 8 || c_k < 8 || c_k % 8 ||
      f_total % 8 || c_k > f_total || act_lo < 0 || act_lo > c_k ||
      act_lo % 8 || bad_geometry(batch, h, w_img))
    return (int)cudaErrorInvalidValue;
  DgradArgs a{{dz, cout, cout, wt, c_k, h, w_img},
              static_cast<float*>(dfeats), feats, f_total, dz_prev, act_lo,
              1, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_k <= 16) return launch_dgrad<2>(is_bf16, a, batch, s);
  if (c_k <= 32) return launch_dgrad<4>(is_bf16, a, batch, s);
  return launch_dgrad<8>(is_bf16, a, batch, s);
}

// Weight gradient of conv k, first pass: n_parts workspace slots of
// 9 * cout * cin + cout floats (dW partial sums, then db's).
extern "C" int dense_block_wgrad(int is_bf16, const void* dz,
                                 const void* dout, int dout_stride,
                                 const void* feats, int f_total, int cin,
                                 int cout, void* partial, int n_parts,
                                 int batch, int h, int w_img, void* stream) {
  if (cout < 8 || cout > 64 || cout % 8 || cin < 8 || cin % 8 ||
      f_total % 8 || cin > f_total || dout_stride < cout || n_parts < 1 ||
      n_parts > 65535 || bad_geometry(batch, h, w_img))
    return (int)cudaErrorInvalidValue;
  WgradArgs a{dz,   static_cast<const float*>(dout), dout_stride,
              feats, f_total, cin, cout, static_cast<float*>(partial),
              batch, h, w_img};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 16) return launch_wgrad<1>(is_bf16, a, n_parts, s);
  if (cout <= 32) return launch_wgrad<2>(is_bf16, a, n_parts, s);
  return launch_wgrad<4>(is_bf16, a, n_parts, s);
}

// Second pass: dw (9, cout, cin) and db (cout,) in f32 from the slots.
extern "C" int dense_block_wgrad_reduce(const void* partial, int n_parts,
                                        int n_w, int cout, void* dw,
                                        void* db, void* stream) {
  if (n_parts < 1 || n_w < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  const int n = n_w + cout;
  wgrad_reduce<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), n_parts, n_w, cout,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}
