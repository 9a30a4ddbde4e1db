// Backward of the ESRGAN dense block on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   super_resolution_tpu/ops/pallas/dense_block_cf_vjp.py:
//   fused_dense_block_cf5_bwd (body _kernel5_bwd)
// and keeps its numerics.  With n convs (any n >= 1), feats = cat(x,
// x_1..x_{n-1}) saved by the forward, C_k = C + (k-1) G input channels of
// conv k, and g the cotangent of y:
//   dout_n = res_scale * g                                       (f32)
//   dout_k = dfeats(x_k) * leak(x_k) for k < n, where dfeats(x_k) is the
//            sum over k' > k of conv_transpose(dz_k', W_k') on x_k's
//            channels, and leak is 1 where the saved activation is > 0,
//            slope where it is <= 0                              (f32)
//   db_k   = sum over pixels of dout_k                 (f32, unrounded)
//   dz_k   = dout_k rounded to x's dtype
//   dW_k   = sum over pixels of dz_k (x) feats[:C_k], per tap      (f32)
//   dx     = g + sum over k of conv_transpose(dz_k, W_k)[:C], rounded
//            once to x's dtype
// The TPU kernel's bands, halos, carries and lane caps served its VMEM
// and its sequential grid and are not carried over.
//
// bf16: n + 3 launches per block, driven by ops/dense_block.py.
//
// bwd_prep.  dz_n = round(res_scale * g), from NCHW g into the last slice
// of a channels-last bf16 dz buffer (B, H, W, C + (n-1) G) laid out like
// the feature buffer (dz_k in x_k's place, dz_n in x's), and db_n's
// partial sums per block of 64 pixels.
//
// The data gradient as a gather: n launches of the forward's Hopper tile
// (conv3x3_wgmma.cuh).  Slice j of the feature buffer (x for j = 0, x_j
// for j >= 1) receives gradient only from convs k > j, so its whole
// gradient is one 3x3 conv over the dz buffer's channel range
// dz_{j+1}..dz_n (K = 9 (C + (n-1-j) G)) with the tap-flipped,
// transposed slices of W_{j+1..n} (N = the slice's width), which the
// wrapper gathers from the packed weights with one indexed copy per
// block.  It mirrors the forward, which writes slice k reading slices
// < k: the tensor map's dim-0 cut selects the channel range as it selects
// the forward's cin, and weights over 64 output channels of K stream with
// the stages as conv5's do.  Two epilogues (kBwdAct, kBwdDx): for j >= 1
// dout_j from the accumulators and the saved x_j, dz_j into the dz
// buffer and db_j's partial sums per (unit, warp); for j = 0 dx = round(g
// + acc) in NCHW.  Launched for j = n-1 down to 0.  No f32 gradient
// buffer exists: each slice's f32 sum lives only in registers, and the
// dz buffer is written once and read by the launches below it.
//
// wgrad_wgmma.  dW_k[tap] = dz_k^T . shift_tap(feats[:, :C_k]), K = the
// pixels, every conv of the block in one launch.  Units are (conv k,
// 64-channel chunk of C_k, 32-channel group of cout_k, pixel range); a
// persistent block per SM whose two consumer warpgroups take its units in
// turn, and a producer thread that issues the TMA loads of each
// 16x8-pixel tile: the feats patch (64 channels, 18x10 pixels, zero
// outside the image: the SAME border) and the dz tile (32 channels, 16x8
// pixels).  The tap shift along K is the hard part: a shifted pixel
// window is not a legal offset into a swizzled MN-major tile.  So the
// product is D = dW^T (M = 64 input channels, N = 32 output channels):
// A, the shifted feats, comes from registers, each warp's 16 channels x
// 16 pixels loaded by ldmatrix.trans at the shifted pixel addresses of the
// one patch (the swizzle XOR in the address, as the forward loads its
// shifted A rows), and B, the unshifted dz rows, from shared memory
// through an MN-major descriptor (the transpose bit) that always starts
// at a whole tile row.  Each (patch row, dx) fragment is loaded once and
// serves up to three taps (dy); a warpgroup keeps 9 taps x 32 channels of
// sums (144 f32 a thread) for its unit, then writes them to the unit's
// slot of a workspace.  (One TMA box per tap, read from L2, was the
// other choice; in the forward, shifted copies of the patch lost.)
//
// bwd_reduce.  Sums the workspace slots in slot order into dW_k (9,
// cout_k, C_k) and the db slots into db_k, for every conv in one launch.
// The partition of every sum over pixels is a function of the shapes and
// the SM count alone, with no atomics, so a backward repeats bit for bit.
//
// Widths.  bf16 slices start on 16-byte boundaries: the wrapper pads C and
// G to multiples of 8 inside the feature and dz buffers (zero channels,
// zero weights), and the reduce maps the padded channels back; the
// public shapes are unpadded.  Wider slices than 64 channels take several
// channel groups in the gather, chunks and groups in wgrad.
//
// f32 (the parity mode) keeps the first kernels, per conv: dgrad3x3 (the
// FMA tile of conv3x3_tile.cuh, adding conv_transpose(dz_k, W_k) into an
// f32 channels-last dfeats buffer, whose epilogue turns x_{k-1}'s slice
// into dout_{k-1}), wgrad3x3 (scalar FMA, partial sums per range of
// 16x16 tiles) and wgrad_reduce: 3n launches, no width constraint.
//
// Bound.  At the training shape (16, 64, 48, 48) bf16, growth 32, the
// backward is 35.3 GFLOP (twice the forward) against 25 MB of saved
// features, cotangent and weights in and dx, dW, db out: about 36 us of
// tensor-core time at 989 TFLOP/s against about 7.5 us of memory time at
// 3.35 TB/s, so it is bound by operations.  What the design does about
// it: every product on wgmma fed by TMA; the data gradient moves about
// 47 MB of bf16 reads and 14 MB of dz writes where the first kernels
// read and wrote 189 MB of f32 gradient; the weight gradient reads each
// feats patch once for nine taps and one 32-channel group.  PERF.md has
// the measured times.

#include "conv3x3_tile.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- f32 --

struct DgradArgs {
  ConvIn c;            // in: dz_k (B, H, W, cout_k); w: flipped weights
                       // (9, C_k, cout_k); cout = C_k
  float* dfeats;       // (B, H, W, f_total) f32; channels [0, C_k) += conv
  const float* feats;  // (B, H, W, f_total) saved features
  int f_total;
  float* dz_prev;      // (B, H, W, C_k - act_lo): dz_{k-1}
  int act_lo;          // first channel of x_{k-1}'s slice; C_k for conv 1
  int n_groups;        // groups of 8 * NT output channels
  float slope;
};

// One element of the dgrad epilogue: dfeats += acc; in x_{k-1}'s slice
// the sum is final, so it becomes dout_{k-1} and dz_{k-1} is written.
__device__ __forceinline__ void dgrad_store(const DgradArgs& a, size_t bp,
                                            int n, float acc) {
  float* df = a.dfeats + bp * a.f_total + n;
  float v = __fadd_rn(*df, acc);
  if (n >= a.act_lo) {
    const float act = a.feats[bp * a.f_total + n];
    v = __fmul_rn(v, act > 0.f ? 1.f : a.slope);
    a.dz_prev[bp * (a.c.cout - a.act_lo) + n - a.act_lo] = v;
  }
  *df = v;
}

template <int NT>
__global__ void __launch_bounds__(kThreads) dgrad3x3(DgradArgs a) {
  constexpr int N = 8 * NT;
  const int b = blockIdx.z / a.n_groups;
  const int n0 = (blockIdx.z % a.n_groups) * N;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const size_t img = (size_t)b * a.c.h * a.c.w_img;

  float acc[N];
  conv_tile_f32<NT>(a.c, b, n0, y0, x0, acc);
  const int oy = y0 + threadIdx.x / kTileW, ox = x0 + threadIdx.x % kTileW;
  if (oy >= a.c.h || ox >= a.c.w_img) return;
  const size_t bp = img + (size_t)oy * a.c.w_img + ox;
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n0 + n < a.c.cout) dgrad_store(a, bp, n0 + n, acc[n]);
}

struct WgradArgs {
  const float* dz;       // (B, H, W, cout): dout_k
  const float* dout;     // dout_k, dout_stride floats per pixel
  int dout_stride;
  const float* feats;    // (B, H, W, f_total); channels [0, cin) are read
  int f_total, cin, cout;
  float* partial;        // (n_parts, 9 * cout * cin + cout)
  int batch, h, w_img;
};

constexpr int kWgradCi = 16;     // input channels per block
constexpr int kWgradCo = 64;     // output channels per block (grid z)

constexpr size_t wgrad_smem(int MT) {
  // dz tile, feats patch, db scratch
  return (size_t)kTileH * kTileW * 16 * MT * 4 +
         (size_t)kPatch * kWgradCi * 4 + 4 * 64 * sizeof(float);
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

// This thread's share of db over one tile: channel co0 + (tid & 63),
// every fourth pixel starting at tid >> 6.
__device__ __forceinline__ float db_tile(const WgradArgs& a, int co0, int b,
                                         int y0, int x0) {
  const int co = co0 + (threadIdx.x & 63);
  float s = 0.f;
  if (co >= a.cout) return s;
  for (int p = threadIdx.x >> 6; p < kTileH * kTileW; p += 4) {
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy < a.h && gx < a.w_img)
      s += a.dout[(((size_t)b * a.h + gy) * a.w_img + gx) * a.dout_stride + co];
  }
  return s;
}

// Scalar FMA.  Block (range of 16x16 tiles, chunk of 16 input channels,
// group of 64 output channels); thread = (input channel tid & 15, output
// channels co0 + (tid >> 4) + 16 m), all 9 taps.  MT = 16-wide output
// channel tiles (cout - co0 <= 16 * MT).
template <int MT>
__global__ void __launch_bounds__(kThreads) wgrad3x3(WgradArgs a) {
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
  const int co0 = blockIdx.z * kWgradCo;
  float dbacc = 0.f;

  float* zs = reinterpret_cast<float*>(smem_raw);      // [256][kCo]
  float* fs = zs + kTileH * kTileW * kCo;              // [kPatch][16]
  float* sdb = fs + kPatch * kWgradCi;
  const int ci0 = blockIdx.y * kWgradCi;
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
      const int p = i / kCo, c = co0 + i % kCo;
      const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
      zs[i] = (c < a.cout && gy < a.h && gx < a.w_img)
                  ? a.dz[(img + (size_t)gy * a.w_img + gx) * a.cout + c]
                  : 0.f;
    }
    for (int i = tid; i < kPatch * kWgradCi; i += kThreads) {
      const int p = i / kWgradCi, c = ci0 + i % kWgradCi;
      const int gy = y0 - 1 + p / kPatchW, gx = x0 - 1 + p % kPatchW;
      fs[i] = (c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w_img)
                  ? a.feats[(img + (size_t)gy * a.w_img + gx) * a.f_total + c]
                  : 0.f;
    }
    if (do_db) dbacc += db_tile(a, co0, b, y0, x0);
    __syncthreads();

    for (int p = 0; p < kTileH * kTileW; ++p) {
      const int py = p / kTileW, px = p % kTileW;
      float zv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) zv[m] = zs[p * kCo + col + 16 * m];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float f = fs[((py + tap / 3) * kPatchW + px + tap % 3) *
                               kWgradCi + ci];
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[tap][m] = fmaf(zv[m], f, acc[tap][m]);
      }
    }
  }

#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int co = co0 + col + 16 * m;
      if (co < a.cout && ci0 + ci < a.cin)
        part[((size_t)tap * a.cout + co) * a.cin + ci0 + ci] = acc[tap][m];
    }

  if (do_db) {
    // the four pixel shares of each channel, added in a fixed order
    sdb[tid] = dbacc;
    __syncthreads();
    if (tid < 64 && co0 + tid < a.cout)
      part[n_w + co0 + tid] = (sdb[tid] + sdb[tid + 64]) +
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
int launch_dgrad(DgradArgs a, int batch, cudaStream_t stream) {
  constexpr int N = 8 * NT;
  a.n_groups = (a.c.cout + N - 1) / N;
  if ((long long)batch * a.n_groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.c.w_img + kTileW - 1) / kTileW,
                  (a.c.h + kTileH - 1) / kTileH, batch * a.n_groups);
  return launch(dgrad3x3<NT>, conv_tile_smem(N), a, grid, stream);
}

template <int MT>
int launch_wgrad(const WgradArgs& a, int n_parts, cudaStream_t stream) {
  const dim3 grid(n_parts, (a.cin + kWgradCi - 1) / kWgradCi,
                  (a.cout + kWgradCo - 1) / kWgradCo);
  return launch(wgrad3x3<MT>, wgrad_smem(MT), a, grid, stream);
}

bool bad_geometry(int batch, int h, int w_img) {
  return batch < 1 || h < 1 || w_img < 1 ||
         (long long)batch * ((h + kTileH - 1) / kTileH) *
                 ((w_img + kTileW - 1) / kTileW) > 0x7fffffffLL;
}

// --------------------------------------------------------------- bf16 --

constexpr int kPrepPix = 64;     // pixels per bwd_prep block
constexpr int kPrepC = 32;       // channels per pass

// dz_n = round(res_scale * g) into the dz buffer (pointer at dz_n's first
// channel, pixel stride dz_stride), padded channels [c, cp) zero; and per
// block the sums over its pixels of res_scale * g, slot (b, blockIdx.x).
__global__ void __launch_bounds__(256)
    bwd_prep(const __nv_bfloat16* g, int c, int cp, int hw, float res_scale,
             __nv_bfloat16* dz, int dz_stride, float* db_part) {
  __shared__ float tile[kPrepC][kPrepPix + 1];
  const int b = blockIdx.y, p0 = blockIdx.x * kPrepPix, tid = threadIdx.x;
  const size_t slot = (size_t)b * gridDim.x + blockIdx.x;
  for (int c0 = 0; c0 < cp; c0 += kPrepC) {
    for (int i = tid; i < kPrepC * kPrepPix; i += 256) {
      const int cc = i / kPrepPix, px = i % kPrepPix;
      float v = 0.f;
      if (c0 + cc < c && p0 + px < hw)
        v = __fmul_rn(res_scale, __bfloat162float(
                                     g[((size_t)b * c + c0 + cc) * hw + p0 + px]));
      tile[cc][px] = v;
    }
    __syncthreads();
    for (int i = tid; i < kPrepPix * (kPrepC / 8); i += 256) {
      const int px = i / (kPrepC / 8), q = (i % (kPrepC / 8)) * 8;
      if (p0 + px >= hw || c0 + q >= cp) continue;
      alignas(16) __nv_bfloat16 z[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) z[j] = __float2bfloat16_rn(tile[q + j][px]);
      *reinterpret_cast<uint4*>(dz + ((size_t)b * hw + p0 + px) * dz_stride +
                                c0 + q) = *reinterpret_cast<const uint4*>(z);
    }
    if (tid < kPrepC && c0 + tid < cp) {
      float s = 0.f;
      for (int px = 0; px < kPrepPix; ++px) s = __fadd_rn(s, tile[tid][px]);
      db_part[slot * cp + c0 + tid] = s;
    }
    __syncthreads();
  }
}

constexpr int kWgTH = 8;                  // rows of a pixel tile
constexpr int kWgCi = 64;                 // input channels of a unit (M)
constexpr int kWgCo = 32;                 // output channels of a unit (N)
constexpr int kWgStages = 3;              // per ring, two rings
constexpr int kWgSlot = 9 * kWgCo * kWgCi;    // floats of a unit's sums
constexpr uint32_t kWgPatchTx = kWgCi * 2 * wgc::kPatchW * (kWgTH + 2);
constexpr uint32_t kWgPatchBytes = wgc::round_up(kWgPatchTx, wgc::kAlign);
constexpr uint32_t kWgDzBytes = kWgCo * 2 * wgc::kTile * kWgTH;
constexpr uint32_t kWgStageBytes = kWgPatchBytes + kWgDzBytes;
constexpr uint32_t kWgSmem =
    wgc::kAlign + 2 * kWgStages * kWgStageBytes + 16 * 2 * kWgStages;
static_assert(kWgStageBytes % wgc::kAlign == 0, "stages stay 1024-aligned");
static_assert(kWgSmem <= (uint32_t)wgc::kMaxSmem, "wgrad fits a block");

struct WgParams {
  int c, g, cp, gp, n;           // widths (real, padded) and conv count
  int h, w, tiles_x, tiles_y, tiles;   // 16 x 8 pixel tiles
  int ranges, units;             // units = jobs x ranges
  float* partial;                // (units, 9, 32, 64)
};

// Job = (conv k, chunk of 64 input channels, group of 32 output channels),
// in that order: the chunk's first feats channel and the group's first
// dz channel.
__device__ __forceinline__ void wg_job(const WgParams& p, int job, int& ci0,
                                       int& z0) {
  ci0 = z0 = 0;
  for (int k = 1; k <= p.n; ++k) {
    const int cin = p.cp + (k - 1) * p.gp, cout = k < p.n ? p.gp : p.cp;
    const int ng = (cout + kWgCo - 1) / kWgCo;
    const int nj = (cin + kWgCi - 1) / kWgCi * ng;
    if (job < nj) {
      ci0 = job / ng * kWgCi;
      z0 = (k - 1) * p.gp + job % ng * kWgCo;
      return;
    }
    job -= nj;
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// wgmma m64n32k16, A from registers, B MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_n32_tb(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of one tile row of the dz stage as B (K = 16 pixels, N = 32
// channels, channels contiguous: MN-major, 64-byte swizzle).  SBO = 8
// pixel rows of 64 bytes; LBO (the stride between 32-channel atoms) is
// unused at N = 32.
__device__ __forceinline__ uint64_t dz_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * kWgCo * 2 / 16) << 32) | (2ull << 62);
}

// A fragment of batch bt = (patch row pr, dx): this warp's 16 input
// channels x the 16 pixels of patch row pr from column dx.  ldmatrix
// .trans matrix q = lane / 8: pixels 8 (q / 2) + lane % 8, channels
// 16 w + 8 (q % 2) (a 16-byte piece of the 128-byte pixel row).
__device__ __forceinline__ void wg_load_a(uint32_t (&a)[4], uint32_t patch,
                                          int bt, int pix_l,
                                          uint32_t piece) {
  const int pr = bt / 3, dx = bt % 3;
  const uint32_t off = (pr * wgc::kPatchW + dx + pix_l) * (kWgCi * 2) + piece;
  ldmatrix_x4_trans(a, patch + wgc::swizzle<kWgCi>(off));
}

// The products of one stage: for each (patch row pr, dx) one A fragment
// and up to three wgmmas (dy, output row pr - dy) into tap dy*3 + dx,
// issued as one batch behind one fence while the next fragment loads.
__device__ __forceinline__ void wg_stage(float (&acc)[9][16], uint32_t patch,
                                         uint32_t dzs, int w, int lane) {
  constexpr int kBatches = 3 * (kWgTH + 2);
  const int pix_l = (lane & 7) + 8 * (lane >> 4);
  const uint32_t piece = (2 * w + ((lane >> 3) & 1)) * 16;
  uint32_t a[2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 16; ++i) wgc::fence_operand(acc[t][i]);
  wg_load_a(a[0], patch, 0, pix_l, piece);
#pragma unroll
  for (int bt = 0; bt < kBatches; ++bt) {
    const int pr = bt / 3, dx = bt % 3;
    wgc::wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int r = pr - dy;
      if (r >= 0 && r < kWgTH)
        wgmma_n32_tb(acc[dy * 3 + dx], a[bt & 1],
                     dz_desc(dzs + r * (wgc::kTile * kWgCo * 2)));
    }
    wgc::wgmma_commit();
    if (bt + 1 < kBatches) {
      wgc::wgmma_wait<1>();   // batch bt - 1, the other set's reader, is done
      wg_load_a(a[(bt + 1) & 1], patch, bt + 1, pix_l, piece);
    }
  }
  wgc::wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 16; ++i) wgc::fence_operand(acc[t][i]);
}

// Grid: persistent blocks; block i takes units i, i + grid, ..., its k-th
// unit on consumer warpgroup k % 2 (each with a ring of its own).
__global__ void __launch_bounds__(wgc::kThreads, 1)
    wgrad_wgmma(const __grid_constant__ CUtensorMap tm_f,
                const __grid_constant__ CUtensorMap tm_z,
                const WgParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wgc::smem_u32(smem_raw);
  const uint32_t base = (raw + wgc::kAlign - 1) & ~(wgc::kAlign - 1);
  // full / empty barrier of stage s of ring g: + 8 (g kWgStages + s)
  const uint32_t full = base + 2 * kWgStages * kWgStageBytes;
  const uint32_t empty = full + 8 * 2 * kWgStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kWgStages; ++s) {
      wgc::mbar_init(full + 8 * s, 1);
      wgc::mbar_init(empty + 8 * s, 4);       // the 4 warps of a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_image = p.tiles_x * p.tiles_y;

  if (warp >= wgc::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(wgc::kProducerRegs));
    if (threadIdx.x != 32 * wgc::kConsumerWarps) return;
    int stage[2] = {0, 0};
    uint32_t phase[2] = {0, 0};
    for (int k = 0;; ++k) {
      const int unit = blockIdx.x + gridDim.x * k;
      if (unit >= p.units) break;
      const int g = k & 1, r = unit % p.ranges;
      int ci0, z0;
      wg_job(p, unit / p.ranges, ci0, z0);
      const int t0 = (int)((long long)r * p.tiles / p.ranges);
      const int t1 = (int)((long long)(r + 1) * p.tiles / p.ranges);
      for (int t = t0; t < t1; ++t) {
        const int b = t / per_image, rem = t % per_image;
        const int y0 = rem / p.tiles_x * kWgTH;
        const int x0 = rem % p.tiles_x * wgc::kTile;
        const uint32_t sb = 8 * (g * kWgStages + stage[g]);
        wgc::mbar_wait(empty + sb, phase[g] ^ 1);
        const uint32_t dst = base + (g * kWgStages + stage[g]) * kWgStageBytes;
        wgc::mbar_expect_tx(full + sb, kWgPatchTx + kWgDzBytes);
        wgc::tma_load_4d(dst, &tm_f, full + sb, ci0, x0 - 1, y0 - 1, b);
        wgc::tma_load_4d(dst + kWgPatchBytes, &tm_z, full + sb, z0, x0, y0,
                         b);
        if (++stage[g] == kWgStages) {
          stage[g] = 0;
          phase[g] ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(wgc::kConsumerRegs));
    const int g = warp >> 2, w = warp & 3;
    float acc[9][16];
    int stage = 0;
    uint32_t phase = 0;
    for (int k = g;; k += 2) {
      const int unit = blockIdx.x + gridDim.x * k;
      if (unit >= p.units) break;
      const int r = unit % p.ranges;
      const int t0 = (int)((long long)r * p.tiles / p.ranges);
      const int t1 = (int)((long long)(r + 1) * p.tiles / p.ranges);
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[t][i] = 0.f;
      for (int t = t0; t < t1; ++t) {
        const uint32_t sb = 8 * (g * kWgStages + stage);
        wgc::mbar_wait(full + sb, phase);
        const uint32_t st = base + (g * kWgStages + stage) * kWgStageBytes;
        wg_stage(acc, st, st + kWgPatchBytes, w, lane);
        __syncwarp();
        if (lane == 0) wgc::mbar_arrive(empty + sb);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the unit's sums, [tap][output channel][input channel]: lane (gq,
      // tq) holds channels 16 w + gq (+ 8) and 8 (i / 4) + 2 tq (+ 1)
      float* part = p.partial + (size_t)unit * kWgSlot;
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int ci = 16 * w + gq + 8 * ((i >> 1) & 1);
          const int co = 8 * (i >> 2) + 2 * tq + (i & 1);
          part[(t * kWgCo + co) * kWgCi + ci] = acc[t][i];
        }
    }
  }
}

struct RedParams {
  int c, g, cp, gp, n, ranges;
  const float* partial;      // wgrad_wgmma's slots
  const float* db_gather;    // convs 1..n-1: [conv][group][slot][gn]
  int g_slots, g_n, g_groups;
  const float* db_prep;      // conv n: [slot][cp]
  int p_slots;
  float* dw;                 // (9, cout_k, C_k) for k = 1..n, in order
  float* db;                 // (cout_k) for k = 1..n, in order
  int dw_total, db_total, dw_blocks;
};

// Blocks [0, dw_blocks): one dW element a thread, its slots summed in
// order.  The rest: one db element a warp, the lanes over the slots in a
// fixed stride, then a fixed xor tree.
__global__ void __launch_bounds__(256) bwd_reduce(const RedParams p) {
  if ((int)blockIdx.x < p.dw_blocks) {
    int e = blockIdx.x * 256 + threadIdx.x;
    if (e >= p.dw_total) return;
    const int out = e;
    int job0 = 0, cin = 0, cout = 0, ng = 1;
    for (int k = 1; k <= p.n; ++k) {
      cin = p.c + (k - 1) * p.g;
      cout = k < p.n ? p.g : p.c;
      const int cin_p = p.cp + (k - 1) * p.gp, cout_p = k < p.n ? p.gp : p.cp;
      ng = (cout_p + kWgCo - 1) / kWgCo;
      if (e < 9 * cout * cin) break;
      e -= 9 * cout * cin;
      job0 += (cin_p + kWgCi - 1) / kWgCi * ng;
    }
    const int ci = e % cin, co = e / cin % cout, tap = e / (cin * cout);
    // the input channel's place in the padded buffer
    const int ci_p =
        ci < p.c ? ci : p.cp + (ci - p.c) / p.g * p.gp + (ci - p.c) % p.g;
    const int job = job0 + ci_p / kWgCi * ng + co / kWgCo;
    const float* src = p.partial + (size_t)job * p.ranges * kWgSlot +
                       (tap * kWgCo + co % kWgCo) * kWgCi + ci_p % kWgCi;
    float s = 0.f;
    for (int r = 0; r < p.ranges; ++r)
      s = __fadd_rn(s, src[(size_t)r * kWgSlot]);
    p.dw[out] = s;
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int e = (blockIdx.x - p.dw_blocks) * 8 + warp;
    if (e >= p.db_total) return;
    const float* src;
    int slots, stride;
    if (e < (p.n - 1) * p.g) {
      const int k = e / p.g, ch = e % p.g;
      src = p.db_gather +
            (size_t)(k * p.g_groups + ch / p.g_n) * p.g_slots * p.g_n +
            ch % p.g_n;
      slots = p.g_slots;
      stride = p.g_n;
    } else {
      src = p.db_prep + (e - (p.n - 1) * p.g);
      slots = p.p_slots;
      stride = p.cp;
    }
    float s = 0.f;
    for (int i = lane; i < slots; i += 32)
      s = __fadd_rn(s, src[(size_t)i * stride]);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) p.db[e] = s;
  }
}

int sm_count(int* n_sm) {
  static int of[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && of[dev]) {
    *n_sm = of[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) of[dev] = *n_sm;
  return 0;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// wgrad_wgmma's jobs for padded widths cp, gp and n convs
int wgrad_jobs(int cp, int gp, int n) {
  int jobs = 0;
  for (int k = 1; k <= n; ++k)
    jobs += cdiv(cp + (k - 1) * gp, kWgCi) * cdiv(k < n ? gp : cp, kWgCo);
  return jobs;
}

}  // namespace

// Each function returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for arguments it cannot take; the
// Python wrapper raises on anything but 0.  The wrapper checks shapes,
// dtypes, alignment and contiguity; what picks a template or a 16-byte
// copy, and the sizes of the workspaces, are checked here too.

// ---- f32 ----

// Data gradient of conv k: dfeats[:, :c_k] += conv_transpose(dz, W_k),
// with wt = W_k flipped and transposed, (9, c_k, cout).  Channels
// [act_lo, c_k) are x_{k-1}'s slice: they leave as dout_{k-1}, and
// dz_prev (B, H, W, c_k - act_lo) receives them.  act_lo == c_k for
// conv 1.
extern "C" int dense_block_dgrad(const void* dz, int cout, const void* wt,
                                 int c_k, void* dfeats, const void* feats,
                                 int f_total, void* dz_prev, int act_lo,
                                 int batch, int h, int w_img, float slope,
                                 void* stream) {
  if (cout < 1 || c_k < 1 || c_k > f_total || act_lo < 0 || act_lo > c_k ||
      bad_geometry(batch, h, w_img))
    return (int)cudaErrorInvalidValue;
  DgradArgs a{{dz, cout, cout, wt, c_k, h, w_img},
              static_cast<float*>(dfeats), static_cast<const float*>(feats),
              f_total, static_cast<float*>(dz_prev), act_lo, 1, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_k <= 16) return launch_dgrad<2>(a, batch, s);
  if (c_k <= 32) return launch_dgrad<4>(a, batch, s);
  return launch_dgrad<8>(a, batch, s);
}

// Weight gradient of conv k, first pass: n_parts workspace slots of
// 9 * cout * cin + cout floats (dW partial sums, then db's).
extern "C" int dense_block_wgrad(const void* dz, const void* dout,
                                 int dout_stride, const void* feats,
                                 int f_total, int cin, int cout,
                                 void* partial, int n_parts, int batch,
                                 int h, int w_img, void* stream) {
  if (cout < 1 || cin < 1 || cin > f_total || dout_stride < cout ||
      n_parts < 1 || n_parts > 0x7fffffff ||
      (cin + kWgradCi - 1) / kWgradCi > 65535 ||
      (cout + kWgradCo - 1) / kWgradCo > 65535 ||
      bad_geometry(batch, h, w_img))
    return (int)cudaErrorInvalidValue;
  WgradArgs a{static_cast<const float*>(dz),
              static_cast<const float*>(dout),
              dout_stride,
              static_cast<const float*>(feats),
              f_total,
              cin,
              cout,
              static_cast<float*>(partial),
              batch,
              h,
              w_img};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int widest = cout < kWgradCo ? cout : kWgradCo;
  if (widest <= 16) return launch_wgrad<1>(a, n_parts, s);
  if (widest <= 32) return launch_wgrad<2>(a, n_parts, s);
  return launch_wgrad<4>(a, n_parts, s);
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

// ---- bf16 ----

// dz_n and db_n's slots from NCHW g (B, c, H, W): dz points at dz_n's
// first channel in the dz buffer (pixel stride dz_stride), db_part holds
// batch * ceil(hw / 64) slots of cp floats.
extern "C" int dense_block_bwd_prep(const void* g, int c, int cp,
                                    float res_scale, void* dz, int dz_stride,
                                    void* db_part, int batch, int hw,
                                    void* stream) {
  if (c < 1 || cp < c || cp % 8 || dz_stride % 8 || batch < 1 ||
      batch > 65535 || hw < 1 || (uintptr_t)dz % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(hw, kPrepPix), batch);
  bwd_prep<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), c, cp, hw, res_scale,
      static_cast<__nv_bfloat16*>(dz), dz_stride,
      static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// One gather launch of the data gradient: the conv of dz buffer channels
// [lo, c_total) with wb (9, width, c_total - lo).  act = 1: slice j >= 1,
// res = feats at the slice's first channel, out = the dz buffer at dz_j's
// first channel (both of pixel stride c_total), db_part = db_j's slots,
// db_len floats; act = 0: slice 0, res = g and out = dx, NCHW (B, width,
// H, W).
extern "C" int dense_block_gather(const void* dz, int c_total, int lo,
                                  const void* wb, int width, int act,
                                  void* out, const void* res, void* db_part,
                                  long long db_len, float slope, int batch,
                                  int h, int w_img, void* stream) {
  if (lo < 0 || lo % 8 || lo >= c_total || width < 1 || batch < 1 ||
      h < 1 || w_img < 1)
    return (int)cudaErrorInvalidValue;
  wgc::Conv c{};
  c.in = static_cast<const __nv_bfloat16*>(dz) + lo;
  c.c_total = c_total;
  c.cin = c_total - lo;
  c.w = wb;
  c.cout = width;
  c.bias = nullptr;
  c.batch = batch;
  c.h = h;
  c.w_img = w_img;
  c.slope = slope;
  if (act) {
    const int n = wgc::pick_n(width, 64);
    const long long units =
        (long long)batch * cdiv(h, wgc::kTile) * cdiv(w_img, wgc::kTile);
    if (width % 8 || (uintptr_t)out % 16 || (uintptr_t)res % 16 ||
        db_len != (long long)cdiv(width, n) * units * 4 * n)
      return (int)cudaErrorInvalidValue;
    c.mode = wgc::kBwdAct;
    c.out = out;
    c.c_out = c_total;
    c.act_in = res;
    c.act_stride = c_total;
    c.dz = out;
    c.dz_stride = c_total;
    c.db_part = static_cast<float*>(db_part);
  } else {
    c.mode = wgc::kBwdDx;
    c.out = out;
    c.c_out = width;
    c.res = res;
  }
  return wgc::launch<float, 64, true>(c, static_cast<cudaStream_t>(stream));
}

// The weight gradient of every conv: feats and dz (B, H, W, c_total) with
// c_total = cp + (n-1) gp; ranges pixel ranges per job; partial holds
// units = jobs * ranges slots of 9 * 32 * 64 floats.
extern "C" int dense_block_wgrad_wgmma(const void* feats, const void* dz,
                                       int c, int g, int cp, int gp, int n,
                                       int batch, int h, int w_img,
                                       int ranges, void* partial,
                                       long long units, void* stream) {
  const int c_total = cp + (n - 1) * gp;
  if (n < 1 || c < 1 || cp < c || cp % 8 || (n > 1 && (g < 1 || gp < g)) ||
      gp % 8 || batch < 1 || h < 1 || w_img < 1 || ranges < 1 ||
      (uintptr_t)feats % 16 || (uintptr_t)dz % 16)
    return (int)cudaErrorInvalidValue;
  WgParams p{};
  p.c = c;
  p.g = g;
  p.cp = cp;
  p.gp = gp;
  p.n = n;
  p.h = h;
  p.w = w_img;
  p.tiles_x = cdiv(w_img, wgc::kTile);
  p.tiles_y = cdiv(h, kWgTH);
  const long long tiles = (long long)batch * p.tiles_x * p.tiles_y;
  const long long all = (long long)wgrad_jobs(cp, gp, n) * ranges;
  if (tiles > 0x7fffffffLL || ranges > tiles || all != units ||
      all > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.ranges = ranges;
  p.units = (int)all;
  p.partial = static_cast<float*>(partial);

  const wgc::EncodeTiledFn encode = wgc::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t px = (cuuint64_t)c_total * 2;
  const cuuint64_t dim[4] = {(cuuint64_t)c_total, (cuuint64_t)w_img,
                             (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t stride[3] = {px, px * w_img, px * w_img * h};
  const cuuint32_t fbox[4] = {kWgCi, wgc::kPatchW, kWgTH + 2, 1};
  const cuuint32_t zbox[4] = {kWgCo, wgc::kTile, kWgTH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap tf, tz;
  if (encode(&tf, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(feats), dim, stride, fbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&tz, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(dz), dim, stride, zbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  int n_sm = 0;
  int err = sm_count(&n_sm);
  if (err) return err;
  static bool attr_set;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int grid = p.units < n_sm ? p.units : n_sm;
  wgrad_wgmma<<<grid, wgc::kThreads, kWgSmem,
                static_cast<cudaStream_t>(stream)>>>(tf, tz, p);
  return (int)cudaGetLastError();
}

// Both sums of every conv: dW (9, cout_k, C_k) and db (cout_k) for k =
// 1..n, each concatenated in k order, from wgrad_wgmma's slots and the db
// slots of the gathers (g_slots per group of g_n channels, g_groups
// groups a conv) and of bwd_prep (p_slots of cp).
extern "C" int dense_block_bwd_reduce(
    int c, int g, int cp, int gp, int n, int ranges, const void* partial,
    const void* db_gather, int g_slots, int g_n, int g_groups,
    const void* db_prep, int p_slots, void* dw, void* db, void* stream) {
  if (n < 1 || c < 1 || (n > 1 && (g < 1 || g_slots < 1 || g_n < 1 ||
                                   g_groups * g_n < gp)) ||
      ranges < 1 || p_slots < 1)
    return (int)cudaErrorInvalidValue;
  long long dw_total = 0;
  for (int k = 1; k <= n; ++k)
    dw_total += 9LL * (k < n ? g : c) * (c + (long long)(k - 1) * g);
  const long long db_total = (long long)(n - 1) * g + c;
  if (dw_total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  RedParams p{c, g, cp, gp, n, ranges,
              static_cast<const float*>(partial),
              static_cast<const float*>(db_gather), g_slots, g_n, g_groups,
              static_cast<const float*>(db_prep), p_slots,
              static_cast<float*>(dw), static_cast<float*>(db),
              (int)dw_total, (int)db_total, cdiv((int)dw_total, 256)};
  const int grid = p.dw_blocks + cdiv((int)db_total, 8);
  bwd_reduce<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
