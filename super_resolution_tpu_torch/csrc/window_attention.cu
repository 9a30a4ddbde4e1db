// Shifted-window multi-head self-attention of a Swin layer (SwinIR,
// arXiv 2108.10257) on Hopper (sm_90a): one launch per layer computes
// every 8x8 window and every head of the batch.
//
// No TPU kernel of the JAX package computes this: the port's SwinIR
// (models/swinir.py) is the first transformer the repo runs.
//
// Input.  The qkv Linear's channels-last (B, Hp, Wp, 3C) bf16 output,
// channel t*C + h*hd + d for q, k, v (t = 0, 1, 2) of head h, as SwinIR's
// reshape(B_, N, 3, heads, hd) reads it.  Token (i, j) of window (wy, wx)
// is the pixel ((8*wy + i + s) mod Hp, (8*wx + j + s) mod Wp), s = 0 or
// the cyclic shift: torch.roll by -s and the window partition become
// addressing.  The output (B, Hp, Wp, C) bf16 goes to the same pixels, so
// the roll back and the window reverse are addressing too.
//
// Math, per window and head, as WindowAttention.forward has it:
//   S = (q k^T) * hd^-1/2 + B_rel[head] (+ mask), P = softmax(S), O = P v
// B_rel[n][m] = table[head][(yn - ym + 7) * 15 + (xn - xm + 7)], the
// published relative_position_index gathered from the (heads, 225) table;
// the mask adds -100.0 where the two tokens lie in different regions of
// calculate_mask's 3 x 3 cut of the shifted frame (never -inf, and no
// block is skipped).  S, the softmax and its row sums are float32; P is
// rounded to bf16 for P v, which accumulates in float32; O is divided by
// the float32 row sum and rounded once to bf16.
//
// Design.  The work is bound by bytes: per window-head 4 * 64^2 * hd
// FLOP against (3 + 1) * 64 * hd * 2 bytes, 32 FLOP a byte at hd = 30.
// One block per window, one warp per head.  The block copies the
// window's 64 token rows of 3C channels (1440 bytes each at C = 240) into
// shared memory with 16-byte cp.async (every row of qkv is read once, in
// full pieces), and the (heads, 225) table beside them.  Each warp runs
// its head in four blocks of 16 query rows on mma.sync m16n8k16 (bf16 in,
// float32 accumulate; v's fragments transposed by movmatrix, since a
// head's channels start at no 16-byte boundary ldmatrix could take); head
// dim hd (30) is padded to 32 on chip: the
// fragment elements past hd are zeros, never loaded, so they add nothing
// to any sum, and no warp reads another head's channels.  Shared rows are
// padded to an odd number of 16-byte pieces, which keeps the fragments'
// 4-byte loads free of bank conflicts.  A warp writes its O over its own
// q channels of the rows it has just read; the block then stores the
// window's C output channels with 16-byte stores.  Two blocks fit on an
// SM (100 KB of shared memory each), so one copies in while the other
// computes.  No programmatic dependent launch: durations of launches on
// the stream do not overlap, so a roofline read from them stays true.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWin = 8;                  // window side
constexpr int kTok = kWin * kWin;        // tokens per window
constexpr int kRel = (2 * kWin - 1) * (2 * kWin - 1);   // table rows
constexpr int kMaxHeads = 8;         // one warp a head
constexpr float kMaskValue = -100.0f;    // calculate_mask's fill
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* qkv;   // (B, Hp, Wp, 3C)
  __nv_bfloat16* out;         // (B, Hp, Wp, C)
  const float* table;         // (heads, kRel)
  int hp, wp, heads, hd, c;   // c = heads * hd
  int shift;
  float scale;
  int stride;                 // shared row stride, elements
  int nwx, nwin;              // windows per row, per image
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the lane's pair of an 8 x 8 bf16 matrix transposed across the warp
__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D += A (16x16, row) * B (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// calculate_mask's region of shifted-frame coordinate v along an axis of
// n pixels: 0 up to n - 8, 1 up to n - s, 2 after
__device__ __forceinline__ int region(int v, int n, int s) {
  return v < n - kWin ? 0 : (v < n - s ? 1 : 2);
}

__global__ void __launch_bounds__(32 * kMaxHeads, 2)
    window_attention_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  float* table =
      reinterpret_cast<float*>(smem + (size_t)kTok * p.stride * 2);

  const int b = blockIdx.x / p.nwin;
  const int wy = (blockIdx.x % p.nwin) / p.nwx;
  const int wx = (blockIdx.x % p.nwin) % p.nwx;
  const int c3 = 3 * p.c;

  // the window's qkv rows, 16 bytes a piece, in the (rolled) window order
  const int pieces = c3 / 8;
  for (int t = threadIdx.x; t < kTok * pieces; t += blockDim.x) {
    const int tok = t / pieces, pc = t - tok * pieces;
    int y = wy * kWin + tok / kWin + p.shift;
    int x = wx * kWin + tok % kWin + p.shift;
    if (y >= p.hp) y -= p.hp;
    if (x >= p.wp) x -= p.wp;
    const __nv_bfloat16* src =
        p.qkv + (((size_t)b * p.hp + y) * p.wp + x) * c3 + pc * 8;
    cp_async16(smem_u32(tile + tok * p.stride + pc * 8), src);
  }
  for (int t = threadIdx.x; t < p.heads * kRel; t += blockDim.x)
    table[t] = p.table[t];
  cp_async_wait_all();
  __syncthreads();

  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  {
    const int hd = p.hd, st = p.stride;
    __nv_bfloat16* qs = tile + h * hd;
    const __nv_bfloat16* ks = tile + p.c + h * hd;
    const __nv_bfloat16* vs = tile + 2 * p.c + h * hd;
    const float* tab = table + h * kRel;
    const bool last_y = wy == p.hp / kWin - 1, last_x = wx == p.wp / kWin - 1;

    // the mask's region of key column m = 8 * nt + 2 * q + e
    int reg_col[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ry = last_y ? region(wy * kWin + nt, p.hp, p.shift) : 0;
        const int rx =
            last_x ? region(wx * kWin + 2 * q + e, p.wp, p.shift) : 0;
        reg_col[nt][e] = 3 * ry + rx;
      }

#pragma unroll 1
    for (int rb = 0; rb < kTok / 16; ++rb) {
      // A: q rows 16 rb + g (+8), channels 16 ks + 2 q (+8); zeros past hd
      uint32_t a[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c0 = 16 * kk + 2 * q, c1 = c0 + 8;
        const __nv_bfloat16* r0 = qs + (16 * rb + g) * st;
        const __nv_bfloat16* r1 = r0 + 8 * st;
        a[kk][0] = c0 < hd ? lds32(r0 + c0) : 0u;
        a[kk][1] = c0 < hd ? lds32(r1 + c0) : 0u;
        a[kk][2] = c1 < hd ? lds32(r0 + c1) : 0u;
        a[kk][3] = c1 < hd ? lds32(r1 + c1) : 0u;
      }
      // S = q k^T over the 64 keys, 8 at a time
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* kr = ks + (8 * nt + g) * st;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int c0 = 16 * kk + 2 * q, c1 = c0 + 8;
          mma16816(s[nt], a[kk], c0 < hd ? lds32(kr + c0) : 0u,
                   c1 < hd ? lds32(kr + c1) : 0u);
        }
      }
      // scale, relative bias, mask; the rows' maxima
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int yn = 2 * rb + half, xn = g;   // query row 16 rb + g + 8 half
        const int ry = last_y ? region(wy * kWin + yn, p.hp, p.shift) : 0;
        const int rx = last_x ? region(wx * kWin + xn, p.wp, p.shift) : 0;
        const int reg_row = 3 * ry + rx;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ym = nt, xm = 2 * q + e;
            float v = s[nt][2 * half + e] * p.scale +
                      tab[(yn - ym + kWin - 1) * (2 * kWin - 1) +
                          (xn - xm + kWin - 1)];
            if (p.shift && reg_row != reg_col[nt][e]) v += kMaskValue;
            s[nt][2 * half + e] = v;
            mx[half] = fmaxf(mx[half], v);
          }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      }
      // P = exp(S - max), in float32; P v from P rounded to bf16
      uint32_t pa[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float e4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e4[i] = exp2f((s[nt][i] - mx[i >> 1]) * kLog2e);
          sum[i >> 1] += e4[i];
        }
        pa[nt][0] = pack_bf16(e4[0], e4[1]);
        pa[nt][1] = pack_bf16(e4[2], e4[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      }
      float o[4][4];
#pragma unroll
      for (int nd = 0; nd < 4; ++nd)
        o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {       // keys 16 kk .. 16 kk + 15
        const uint32_t af[4] = {pa[2 * kk][0], pa[2 * kk][1],
                                pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {
          // B is v's 8 x 8 pieces transposed: each lane loads the pair
          // (key 16 kk + g (+8), channels 8 nd + 2 q) as q's fragments
          // lie, and movmatrix hands it the (keys 2 q, 2 q + 1, channel
          // 8 nd + g) pair that P v takes
          const int dq = 8 * nd + 2 * q;
          const __nv_bfloat16* vr = vs + (16 * kk + g) * st + dq;
          const uint32_t b0 = transpose8x8(dq < hd ? lds32(vr) : 0u);
          const uint32_t b1 = transpose8x8(dq < hd ? lds32(vr + 8 * st) : 0u);
          mma16816(o[nd], af, b0, b1);
        }
      }
      // O / row sum over this head's q channels of the rows just read
      __syncwarp();
      const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
      __nv_bfloat16* o0 = qs + (16 * rb + g) * st;
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int d = 8 * nd + 2 * q;
        if (d < hd) {
          *reinterpret_cast<uint32_t*>(o0 + d) =
              pack_bf16(o[nd][0] * inv0, o[nd][1] * inv0);
          *reinterpret_cast<uint32_t*>(o0 + 8 * st + d) =
              pack_bf16(o[nd][2] * inv1, o[nd][3] * inv1);
        }
      }
    }
  }
  __syncthreads();

  // the window's C output channels, 16 bytes a piece
  const int opieces = p.c / 8;
  for (int t = threadIdx.x; t < kTok * opieces; t += blockDim.x) {
    const int tok = t / opieces, pc = t - tok * opieces;
    int y = wy * kWin + tok / kWin + p.shift;
    int x = wx * kWin + tok % kWin + p.shift;
    if (y >= p.hp) y -= p.hp;
    if (x >= p.wp) x -= p.wp;
    *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.hp + y) * p.wp + x) *
                                          p.c + pc * 8) =
        *reinterpret_cast<const uint4*>(tile + tok * p.stride + pc * 8);
  }
}

// shared row stride in elements: 3C and an odd number of 16-byte pieces
// more than 3C / 8 (at least one piece of pad)
int row_stride(int c3) {
  const int pieces = c3 / 8;
  return 8 * (pieces % 2 == 0 ? pieces + 1 : pieces + 2);
}

size_t smem_bytes(int c3, int heads) {
  return (size_t)kTok * row_stride(c3) * 2 + (size_t)heads * kRel * 4;
}

}  // namespace

// One Swin layer's window attention.  qkv (B, Hp, Wp, 3C) bf16, out (B,
// Hp, Wp, C) bf16, both contiguous and 16-byte aligned, table (heads,
// 225) float32, contiguous; C = heads * hd with at most 8 heads, Hp and Wp multiples of 8,
// hd even and at most 32, C a multiple of 8, 0 <= shift < 8.  Returns
// cudaGetLastError() after the launch (0 on success); the Python wrapper
// checks the tensors.
extern "C" int window_attention_launch(const void* qkv, void* out,
                                       const void* table, int batch, int hp,
                                       int wp, int heads, int hd, int shift,
                                       float scale, void* stream) {
  const int c = heads * hd;
  if (batch < 1 || hp < kWin || wp < kWin || hp % kWin || wp % kWin ||
      heads < 1 || heads > kMaxHeads || hd < 2 || hd > 32 || hd % 2 ||
      c % 8 || shift < 0 || shift >= kWin ||
      (uintptr_t)qkv % 16 || (uintptr_t)out % 16 || (uintptr_t)table % 4)
    return (int)cudaErrorInvalidValue;
  const long long windows = (long long)batch * (hp / kWin) * (wp / kWin);
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(3 * c, heads);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params p{static_cast<const __nv_bfloat16*>(qkv),
           static_cast<__nv_bfloat16*>(out),
           static_cast<const float*>(table),
           hp, wp, heads, hd, c, shift, scale, row_stride(3 * c),
           wp / kWin, (hp / kWin) * (wp / kWin)};
  window_attention_kernel<<<(unsigned)windows, 32 * heads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
